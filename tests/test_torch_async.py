"""The port's async entry points (`solve_async`, `score_async`,
`score_topk_async`, after tpusched/engine.py's): each `.result()` equals
the synchronous form in both modes, `result(timeout=...)` returns when
the result is there and raises concurrent.futures.TimeoutError when it
is not, the JAX package's own snapshot is accepted as it is, and the
explained form (decision provenance, ROADMAP A11) answers through two
PendingFetch results, the solve's equal to the unexplained one. (Before
A11 was ported the explained form refused with NotImplementedError; the
test keeps its name.)"""

from __future__ import annotations

import concurrent.futures

import jax
import numpy as np
import pytest

from tpusched.synth import make_cluster as jax_make_cluster
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.engine import PendingFetch
from tpusched_torch.snapshot import snapshot_from_numpy

MIXES = {
    "plain": dict(),
    "constrained": dict(taint_frac=0.3, toleration_frac=0.3,
                        selector_frac=0.3, affinity_frac=0.3,
                        cordon_frac=0.1),
    "pairwise": dict(spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2,
                     namespace_count=2),
}
FIELDS = ("assignment", "chosen_score", "order", "commit_key", "final_used",
          "evicted", "rounds", "host_reads")


@pytest.fixture(scope="module")
def engines():
    return {m: Engine(EngineConfig(mode=m), device="cpu")
            for m in ("parity", "fast")}


def _snaps(mix: str, seed: int = 3):
    """(the JAX package's snapshot as numpy, the port's)."""
    jsnap, _ = jax_make_cluster(np.random.default_rng(seed), 36, 9,
                                **MIXES[mix])
    jsnap = jax.device_get(jsnap)
    return jsnap, snapshot_from_numpy(jsnap)


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_solve_async_equals_solve(engines, mode, mix):
    eng = engines[mode]
    jsnap, snap = _snaps(mix)
    pending = eng.solve_async(snap)
    assert isinstance(pending, PendingFetch)
    got = pending.result()
    want = eng.solve(snap)
    _same(got, want)
    assert (got.assignment >= 0).any()
    # The JAX package's snapshot goes in as it is (read through numpy).
    _same(eng.solve_async(jsnap).result(timeout=30.0), want)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_score_async_equals_score(engines, mode):
    eng = engines[mode]
    _, snap = _snaps("pairwise")
    got = eng.score_async(snap).result()
    want = eng.score(snap)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.feasible.shape == (snap.pods.valid.shape[0],
                                  snap.nodes.valid.shape[0])


@pytest.mark.parametrize("k", [1, 3, 5])
def test_score_topk_async_equals_score_topk(engines, k):
    eng = engines["fast"]
    _, snap = _snaps("constrained")
    idx, val, _ = eng.score_topk_async(snap, k).result()
    widx, wval, _ = eng.score_topk(snap, k)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(val, wval)
    assert idx.shape == (snap.pods.valid.shape[0], k)
    with pytest.raises(ValueError, match="out of range"):
        eng.score_topk_async(snap, snap.nodes.valid.shape[0] + 1)


def test_result_timeout(engines):
    """On the CPU the result is there at dispatch, so any timeout
    returns it; a copy that has not landed by the deadline raises
    TimeoutError and can still be joined later."""
    eng = engines["fast"]
    _, snap = _snaps("plain")
    want = eng.solve(snap)
    _same(eng.solve_async(snap).result(timeout=0.0), want)

    class Pending:
        """A CUDA event stand-in whose copy lands on the third query."""

        def __init__(self):
            self.queries = 0

        def query(self):
            self.queries += 1
            return self.queries >= 3

        def synchronize(self):
            self.queries = 3

    pending = eng.solve_async(snap)
    pending._event = Pending()
    with pytest.raises(concurrent.futures.TimeoutError):
        pending.result(timeout=0.0)
    _same(pending.result(timeout=5.0), want)
    pending._event = Pending()
    _same(pending.result(), want)


def test_explained_form_refuses_legibly(engines):
    """The explained form answers; its solve equals the unexplained one."""
    jsnap, snap = _snaps("plain")
    for eng in engines.values():
        p_solve, p_probe = eng.solve_explained_async(snap, 3)
        assert isinstance(p_solve, PendingFetch)
        assert isinstance(p_probe, PendingFetch)
        res, exd = p_solve.result(timeout=60.0)
        _same(res, eng.solve(jsnap))
        assert exd.evictor.shape == res.evicted.shape
        assert p_probe.result().topk_idx.shape == (
            snap.pods.valid.shape[0], 3)


def test_close_is_idempotent():
    eng = Engine(EngineConfig(), device="cpu")
    eng.close()
    eng.close()
