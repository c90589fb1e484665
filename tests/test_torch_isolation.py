"""The PyTorch port stands alone: `tpusched_torch`, `chip_smoke.py` and
`solve_walls.py` import neither JAX nor anything of the JAX package, and
the engine never falls back to the CPU on its own."""

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
    REPO / "chip_smoke.py", REPO / "solve_walls.py"]
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
        "tpusched_torch.engine, tpusched_torch.kernels.queue, "
        "tpusched_torch.kernels.explain, "
        "tpusched_torch.synth, tpusched_torch.device_state, "
        "tpusched_torch.tenants, tpusched_torch.mesh, tpusched_torch.ring\n"
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


def test_solve_many_without_cuda_raises(monkeypatch):
    """The tenant batch, like the engine, runs on the card unless asked
    for the CPU."""
    from tpusched_torch import solve_many, stack_snapshots
    from tpusched_torch.synth import make_cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stacked = stack_snapshots([make_cluster(np.random.default_rng(0), 8,
                                            4)[0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_many(EngineConfig(), stacked)
    assert solve_many(EngineConfig(), stacked, device="cpu")[0].shape == (
        1, stacked.pods.valid.shape[1])


def test_device_queue_without_cuda_raises(monkeypatch):
    """The pending queue, like the engine, lives on the card unless asked
    for the CPU."""
    from tpusched_torch import DeviceQueue

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueue(capacity=8)
    assert DeviceQueue(capacity=8, device="cpu").capacity == 8


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


def test_warm_entry_points_run_on_the_cpu_only_when_asked(monkeypatch):
    """A lineage, like the engine, lives on the card unless asked for
    the CPU; asked, a CPU lineage warm-solves on a CPU engine without a
    transfer, and a foreign (numpy-backed) snapshot is read whole."""
    from tpusched_torch.device_state import DeviceSnapshot
    from tpusched_torch.synth import make_cluster

    nodes, pods, running = make_cluster(np.random.default_rng(0), 12, 4,
                                        as_records=True)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceSnapshot(EngineConfig(mode="fast"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(EngineConfig(mode="fast"))
    ds = DeviceSnapshot(EngineConfig(mode="fast"), device="cpu")
    ds.full_load(nodes, pods, running)
    eng = Engine(EngineConfig(mode="fast"), device="cpu")
    res = eng.solve_warm(ds)
    assert ds.snap.pods.valid.device == torch.device("cpu")
    assert ds.cold_solves == 1 and res.h2d_bytes == 0
    pods[0]["observed_avail"] = 0.3
    ds.apply(upsert_pods=[pods[0]])
    res = eng.solve_warm(ds)
    eng.close()
    assert ds.warm_solves == 1 and 0 < res.h2d_bytes < ds.full_bytes
