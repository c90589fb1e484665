"""ScoreBatch of the port (`Engine.score`, `score_top1`, `score_topk`, on
the CPU, where every kernel wrapper runs its plain version) against the
JAX engine and its numpy oracle, on clusters with taints, selectors,
preferred affinity, cordons and QoS.

Tolerances:
  * feasibility: bitwise equal to the JAX engine's and the oracle's;
  * scores at feasible cells: bitwise equal to the oracle's (both round
    every multiply and add separately, in the same order);
  * scores against the JAX engine: its own parity tolerance (rtol 1e-4,
    atol 1e-3, tests/test_parity.py), because XLA on the CPU contracts
    multiply-adds into FMAs (ROADMAP C1);
  * top-1 / top-k indices: equal to a stable descending sort of the
    oracle's masked matrix (ties to the lower node index, as lax.top_k),
    and values equal to the oracle's there.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.oracle import Oracle
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.snapshot import snapshot_from_numpy

CASES = {
    "resources_qos": lambda: jsynth.make_cluster(
        np.random.default_rng(0), 40, 12, with_qos=True),
    "taints_cordons": lambda: jsynth.make_cluster(
        np.random.default_rng(1), 40, 12, taint_frac=0.5,
        toleration_frac=0.4, cordon_frac=0.2, initial_utilization=0.5),
    "selectors_affinity": lambda: jsynth.make_cluster(
        np.random.default_rng(2), 48, 16, selector_frac=0.4,
        affinity_frac=0.5, with_qos=True),
    "mixed_overcommitted": lambda: jsynth.make_cluster(
        np.random.default_rng(3), 64, 16, taint_frac=0.3,
        toleration_frac=0.3, selector_frac=0.3, affinity_frac=0.3,
        cordon_frac=0.1, initial_utilization=0.8, with_qos=True),
}
TIE_BREAKS = ["first", "seeded"]


def _identical_nodes():
    """Every node ties for every pod: the tie order decides top-k."""
    b = JBuilder(JConfig())
    for i in range(8):
        b.add_node(f"n{i}", {"cpu": 8000, "memory": 32 << 30})
    for i in range(4):
        b.add_pod(f"p{i}", {"cpu": 100, "memory": 1 << 28})
    return b.build()


CASES["identical_nodes"] = _identical_nodes


def _engines(tie_break):
    kw = dict(tie_break=tie_break, tie_seed=9)
    return JEngine(JConfig(**kw)), Engine(EngineConfig(**kw),
                                          device="cpu"), JConfig(**kw)


def _oracle_matrices(jsnap, jcfg):
    """(feasible, score) [n_pods, N] of the oracle's per-pod cycle
    against the snapshot's usage."""
    ora = Oracle(jsnap, jcfg)
    used = np.asarray(jsnap.nodes.used)
    n = int(np.asarray(jsnap.pods.valid).sum())
    rows = [ora.feasible_and_score(p, used) for p in range(n)]
    return (np.stack([f for f, _ in rows]),
            np.stack([s for _, s in rows]).astype(np.float32))


@pytest.fixture(params=sorted(CASES))
def case(request):
    jsnap, _ = CASES[request.param]()
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap))


@pytest.mark.parametrize("tie_break", TIE_BREAKS)
def test_score_matches_jax_and_oracle(case, tie_break):
    jsnap, tsnap = case
    jeng, teng, jcfg = _engines(tie_break)
    try:
        jr = jeng.score(jsnap)
        tr = teng.score(tsnap)
    finally:
        jeng.close()
        teng.close()
    assert tr.feasible.dtype == np.bool_ and tr.scores.dtype == np.float32
    assert tr.feasible.shape == tr.scores.shape == jr.feasible.shape
    np.testing.assert_array_equal(tr.feasible, jr.feasible)
    np.testing.assert_allclose(tr.scores, jr.scores, rtol=1e-4, atol=1e-3)
    of, osc = _oracle_matrices(jsnap, jcfg)
    n = of.shape[0]
    np.testing.assert_array_equal(tr.feasible[:n], of)
    np.testing.assert_array_equal(tr.scores[:n][of], osc[of])
    assert not tr.feasible[n:].any()  # padded pods


@pytest.mark.parametrize("tie_break", TIE_BREAKS)
def test_score_top1_matches_oracle(case, tie_break):
    jsnap, tsnap = case
    jeng, teng, jcfg = _engines(tie_break)
    try:
        jbest, jval, jany, _ = jeng.score_top1(jsnap)
        best, val, anyf, _ = teng.score_top1(tsnap)
    finally:
        jeng.close()
        teng.close()
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_array_equal(anyf, jany)
    np.testing.assert_allclose(val[anyf], jval[anyf], rtol=1e-4, atol=1e-3)
    assert np.isneginf(val[~anyf]).all()
    of, osc = _oracle_matrices(jsnap, jcfg)
    masked = np.where(of, osc, -np.inf).astype(np.float32)
    n = of.shape[0]
    want = np.argsort(-masked, axis=1, kind="stable")[:, 0]
    has = of.any(axis=1)
    np.testing.assert_array_equal(best[:n], np.where(has, want, -1))
    np.testing.assert_array_equal(val[:n][has], masked.max(axis=1)[has])


def _ks(N: int, n_feas: np.ndarray) -> list[int]:
    """k = 1, 3, N, and the smallest k past some pod's feasible count."""
    return sorted({1, min(3, N), N, min(N, int(n_feas.min()) + 1)})


@pytest.mark.parametrize("tie_break", TIE_BREAKS)
def test_score_topk_matches_sorted_oracle(case, tie_break):
    jsnap, tsnap = case
    jeng, teng, jcfg = _engines(tie_break)
    of, osc = _oracle_matrices(jsnap, jcfg)
    n = of.shape[0]
    masked = np.where(of, osc, -np.inf).astype(np.float32)
    order = np.argsort(-masked, axis=1, kind="stable")
    n_feas = of.sum(axis=1)
    ks = _ks(masked.shape[1], n_feas)
    try:
        for k in ks:
            jidx, jval, _ = jeng.score_topk(jsnap, k)
            idx, val, _ = teng.score_topk(tsnap, k)
            assert idx.shape == val.shape == (jidx.shape[0], k)
            np.testing.assert_array_equal(idx, jidx, err_msg=f"k={k}")
            np.testing.assert_allclose(val, jval, rtol=1e-4, atol=1e-3)
            ok = np.arange(k)[None, :] < n_feas[:, None]
            want_idx = np.where(ok, order[:, :k], -1)
            want_val = np.where(ok, np.take_along_axis(masked, order[:, :k],
                                                       axis=1), 0.0)
            np.testing.assert_array_equal(idx[:n], want_idx, err_msg=f"k={k}")
            np.testing.assert_array_equal(val[:n], want_val.astype(np.float32))
            # Fewer than k feasible: -1 / 0 fill.
            assert (idx[idx < 0] == -1).all() and (val[idx < 0] == 0).all()
    finally:
        jeng.close()
        teng.close()


def test_score_topk_rejects_bad_k():
    jsnap, _ = CASES["resources_qos"]()
    eng = Engine(EngineConfig(), device="cpu")
    N = int(np.asarray(jsnap.nodes.valid).shape[0])
    tsnap = snapshot_from_numpy(jsnap)
    try:
        for k in (0, N + 1):
            with pytest.raises(ValueError, match="out of range"):
                eng.score_topk(tsnap, k)
    finally:
        eng.close()


def test_score_accepts_signatures():
    """A spread snapshot, which ScoreBatch refused before the pairwise
    slice: feasibility equal to the JAX engine's, scores to the
    oracle's (tests/test_torch_pairwise.py holds more mixes)."""
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(2), 16, 6,
                                   spread_frac=0.6)
    assert np.asarray(jsnap.sigs.valid).any()
    eng = Engine(EngineConfig(), device="cpu")
    jeng = JEngine(JConfig())
    try:
        got = eng.score(snapshot_from_numpy(jsnap))
        want = jeng.score(jsnap)
    finally:
        eng.close()
        jeng.close()
    np.testing.assert_array_equal(got.feasible, want.feasible)
    oracle = Oracle(jsnap, JConfig())
    used = np.asarray(jsnap.nodes.used)
    for p in range(int(np.asarray(jsnap.pods.valid).sum())):
        feasible, score = oracle.feasible_and_score(p, used)
        np.testing.assert_array_equal(got.feasible[p], feasible)
        np.testing.assert_array_equal(got.scores[p][feasible],
                                      score[feasible])
