"""The port's ctypes declarations against its C header: every entry
point of `tpusched_torch/csrc/kernels.h` is declared in
`tpusched_torch._build.SIGNATURES` with as many arguments as the header
gives it. A count that differs would pass garbage to a kernel on the
card (ctypes does not check a C prototype), so it is held here, on the
CPU, where nothing is built."""

from __future__ import annotations

import re

import pytest

from tpusched_torch import _build


def _header_params() -> dict[str, int]:
    """Parameter count of each `int tpusched_*(...)` declaration."""
    text = (_build.CSRC / "kernels.h").read_text()
    text = re.sub(r"//[^\n]*", "", text)
    return {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
            for m in re.finditer(r"\bint\s+(tpusched_\w+)\s*\(([^)]*)\)\s*;",
                                 text)}


def test_every_header_entry_point_is_declared():
    assert sorted(_header_params()) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_header(name):
    assert len(_build.SIGNATURES[name]) == _header_params()[name]
