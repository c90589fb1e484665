"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with ctypes. The build
happens at first use, into `tpusched_torch/_build/` (listed in
.gitignore), and never when a module is imported: machines without
nvcc (the CPU test hosts) import every module of the package.

Flags: `--fmad=false` keeps nvcc from contracting `a*b + c` into an FMA,
so each kernel rounds exactly as its plain PyTorch version does (eager
torch runs the multiply and the add as two kernels); no fast-math, so
`/` and `sqrtf` stay IEEE. One nvcc per source, all started together,
then one link.

Every C entry point returns `cudaGetLastError()` after its launch; the
wrapper raises if it is not 0 (a refused launch never runs, and a later
synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libtpusched_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# K4's preemption block: M, GP, V, J, the victim table, the margin, the
# per-pod, per-node and running-pod arrays, the budget and eviction state
# (by pod and in the victims' sorted order).
_PREEMPT = [_I] * 4 + [_P] * 8 + [_F] + [_P] * 9

# C signature of every entry point (kernels.h). All pointers and the
# stream are c_void_p: an untyped Python int would be passed as a
# 32-bit int and cut.
SIGNATURES = {
    "tpusched_atom_sat": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                          _I, _P, _P],
    "tpusched_tableau_cells": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, _P],
    "tpusched_finalize_static": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "tpusched_parity_scan": [_I] * 6 + [_P] * 10 + [_I, _U, _P, _P, _P, _P],
    "tpusched_cycle": [_I] * 5 + [_P] * 15 + [_I] + [_P] * 4 + [_I, _I, _P],
    "tpusched_row_topk": [_I, _I, _I, _I, _P, _I, _U, _P, _P, _P, _P, _P],
    "tpusched_row_topk_radix": [_I, _I, _I, _P, _P, _P, _P, _P],
    "tpusched_desirability": [_I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    "tpusched_prefix_commit_loop": [_I] * 5 + [_P] * 10 + [_I] + [_P] * 5,
    "tpusched_parity_scan_pair": [_I] * 6 + [_P] * 10 + [_I, _U]
                                 + [_I] * 4 + [_P] * 23,
    "tpusched_sig_match": [_I] * 6 + [_P] * 8,
    "tpusched_pair_counts": [_I] * 7 + [_P] * 14,
    "tpusched_pairwise_batch": [_I] * 7 + [_P] * 21,
    "tpusched_deal": [_I] * 5 + [_P] * 7,
    "tpusched_deal_lists": [_I] * 7 + [_P] * 19,
    "tpusched_top_by_rank": [_I] * 3 + [_P] * 5,
    "tpusched_node_add": [_I] * 4 + [_P, _I] * 3 + [_P, _I, _P, _P, _I]
                         + [_P] * 3,
    "tpusched_pair_commit": [_I] * 6 + [_P] * 8 + [_I] + [_P] * 4,
    "tpusched_ia_at_choice": [_I] * 6 + [_P] * 13,
    "tpusched_waterfill": [_I] * 5 + [_P] * 14,
    "tpusched_waterfill_members": [_I] * 4 + [_P] * 9,
    "tpusched_waterfill_q": [_I] * 3 + [_P] * 4,
    "tpusched_waterfill_cnt": [_I] * 3 + [_P] * 4,
    "tpusched_waterfill_fill": [_I] * 3 + [_P] * 5,
    "tpusched_excess_keys": [_I] * 3 + [_P] * 5,
    "tpusched_excess_min": [_I] * 5 + [_P] * 16,
    "tpusched_excess_walk": [_I] * 5 + [_P] * 7,
    "tpusched_excess_survive": [_I, _I] + [_P] * 7,
    "tpusched_preempt_step": [_I] * 5 + [_P] * 8 + [_F] + [_P] * 12,
    "tpusched_parity_scan_preempt": [_I] * 4 + [_P] * 10 + [_I, _U]
                                    + _PREEMPT + [_P] * 6,
    "tpusched_parity_scan_pair_preempt": [_I] * 4 + [_P] * 10
                                         + [_I, _U] + [_I] * 4 + [_P] * 19
                                         + _PREEMPT + [_P] * 6,
    "tpusched_auction_tables": [_I] * 7 + [_P] * 9 + [_F] + [_P] * 4,
    "tpusched_auction_ok": [_I] * 4 + [_P] * 8,
    "tpusched_auction_rank": [_I] * 7 + [_P] * 11,
    "tpusched_auction_claim": [_I] * 11 + [_P] * 16 + [_F] + [_P] * 8,
    "tpusched_capacity_prefix_keep": [_I] * 3 + [_P] * 7,
    "tpusched_frontier_closure": [_I] * 3 + [_P] * 11,
    "tpusched_explain_cells": [_I] * 6 + [_P] * 16 + [_I] * 3 + [_P] * 25,
    "tpusched_explain_terms": [_I] * 6 + [_P] * 16 + [_I] * 3 + [_P] * 21
                              + [_I] + [_P] * 4,
    "tpusched_queue_rank": [_I] * 3 + [_P] * 7 + [_F, ctypes.c_double]
                           + [_P] * 7,
    "tpusched_ring_hop": [_I] * 7 + [_P] * 12,
    "tpusched_tableau_nv": [_I] * 7 + [_P] * 12 + [_F] + [_P] * 7,
    "tpusched_claim_limits": [_I] * 4 + [_P],
    "tpusched_shape_limits": [_P],
}

_lib: "ctypes.CDLL | None" = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from tpusched_torch/csrc at first "
        "use and need the CUDA toolkit"
    )


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir())


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH (skipped when it is newer than
    every source). Raises with nvcc's output if any step fails."""
    if not _stale():
        return LIB_PATH
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors, notes = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc exit {proc.returncode}\n{text}")
        else:
            notes.append(f"{src.name}:\n{text}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    tmp = LIB_PATH.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("kernel link failed:\n"
                           + link.stdout.decode(errors="replace"))
    tmp.replace(LIB_PATH)
    (BUILD_DIR / "ptxas.txt").write_text("\n".join(notes))
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.tpusched_error_string.argtypes = [_I]
        handle.tpusched_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise on a nonzero cudaError_t."""
    handle = lib()
    err = getattr(handle, name)(*args)
    if err != 0:
        msg = handle.tpusched_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
