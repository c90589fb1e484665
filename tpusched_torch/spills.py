"""Where a kernel's local-memory traffic falls: the source lines of its
spill and stack loads and stores.

    python3 -m tpusched_torch.spills SOURCE [--match TEXT] [--sass PATH]

Compiles one `csrc/*.cu` source as `_build` does (`sm_90a`, the same
flags) with `-lineinfo` into a cubin under the build directory,
disassembles it with `nvdisasm -gi`, and prints one JSON object: for
each entry function whose mangled name holds TEXT (every one without
--match), its count of local stores (STL) and loads (LDL) by the
source line they come from, with the lines it was inlined at
("preempt.cuh:220 < preempt.cuh:277 < scan.cu:470": one instantiation
of an inlined function apart from another); --sass also writes the
disassembly to PATH. Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from tpusched_torch import _build

_FUNC = re.compile(r"^\s*\.text\.(\S+):")
_LINE = re.compile(r'//## File "[^"]+", line \d+')
_SITE = re.compile(r'"([^"]+)", line (\d+)')
_LOCAL = re.compile(r"\b(STL|LDL)(?:\.[A-Z0-9]+)*\b")


def local_sites(sass: str, match: str = "") -> dict:
    """{function: {"STL": {site: n}, "LDL": {...}}} from `nvdisasm -gi`
    text, for the functions whose name holds `match`; a site is the
    file:line chain from the innermost line out."""
    out: dict = {}
    func, where = None, "?"
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            func = m.group(1) if match in m.group(1) else None
            where = "?"
            if func:
                out[func] = {"STL": collections.Counter(),
                             "LDL": collections.Counter()}
            continue
        if _LINE.search(line):
            where = " < ".join(f"{Path(f).name}:{n}"
                               for f, n in _SITE.findall(line))
            continue
        m = _LOCAL.search(line)
        if func and m and "/*" in line:
            out[func][m.group(1)][where] += 1
    return {f: {k: dict(sorted(c.items())) for k, c in v.items()}
            for f, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="a file of tpusched_torch/csrc")
    ap.add_argument("--match", default="")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    src = _build.CSRC / Path(args.source).name
    nvcc = _build.nvcc_path()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / (src.stem + ".lineinfo.cubin")
    subprocess.run([nvcc, *_build.ARCH, *_build.NVCC_FLAGS, "-lineinfo",
                    "-cubin", str(src), "-o", str(cubin)], check=True)
    sass = subprocess.run(
        [str(Path(nvcc).parent / "nvdisasm"), "-gi", "-c", str(cubin)],
        capture_output=True, text=True, check=True).stdout
    if args.sass:
        Path(args.sass).write_text(sass)
    json.dump(local_sites(sass, args.match), sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
