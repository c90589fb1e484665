"""The PyTorch port stands alone: `tpusched_torch` and `chip_smoke.py`
import neither JAX nor anything of the JAX package, and the engine
never falls back to the CPU on its own."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusched_torch import Engine, EngineConfig

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tpusched_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusched")


def test_port_imports_with_jax_blocked():
    """Import the port and the chip smoke script in a fresh interpreter
    where importing jax, flax or tpusched raises."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'tpusched'):\n"
        "    sys.modules[m] = None\n"
        "import tpusched_torch, tpusched_torch.kernels.assign, "
        "tpusched_torch.kernels.pairwise, tpusched_torch.kernels.preempt, "
        "tpusched_torch.engine, "
        "tpusched_torch.synth\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpusched'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_names_no_jax_module(path):
    """Static twin of the subprocess check: no import statement anywhere
    in the port (function-level ones included) names a JAX module."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig())


def test_engine_cpu_only_when_asked():
    eng = Engine(EngineConfig(), device="cpu")
    try:
        assert eng.device == torch.device("cpu")
        assert eng.mesh is None
    finally:
        eng.close()


def test_fast_engine_without_cuda_raises(monkeypatch):
    """Fast mode, like parity, runs on the card unless asked for the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig(mode="fast"))
    assert Engine(EngineConfig(mode="fast"),
                  device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kw,exc", [
    (dict(mode="bogus"), ValueError),
    (dict(tie_break="random"), NotImplementedError),
    (dict(ring_counts=True), ValueError),
])
def test_engine_refuses_unported_modes(kw, exc):
    with pytest.raises(exc):
        Engine(EngineConfig(**kw), device="cpu")


def test_engine_runs_fast_preemption():
    """Fast mode with preemption (the batched auction) is ported: the
    engine takes the config and solves a config-5 snapshot on the CPU,
    with every placed pod within capacity after its evictions."""
    from tpusched_torch.synth import config5_preemption

    snap, _ = config5_preemption(np.random.default_rng(0), 24, 6)
    res = Engine(EngineConfig(mode="fast", preemption=True),
                 device="cpu").solve(snap)
    alloc = snap.nodes.allocatable.numpy()
    placed = res.assignment >= 0
    assert placed.any() and res.evicted.any()
    assert (res.final_used <= alloc + 1e-3).all()
    assert (~np.isfinite(res.chosen_score[placed])).any()
