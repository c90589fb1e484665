"""Decision provenance (ROADMAP A11): the port's `Engine.solve_explained`
(on the CPU, where K4, K6, K22 and every other kernel wrapper run their
plain versions) against the JAX package's explained solve and probe, on
the same snapshots.

  * Pure observer: the explained solve equals the unexplained one
    (assignment, evictions, commit keys, rounds, host reads, scores and
    final usage).
  * Equal to JAX: evictor, evict_round, the rollback mask and the
    auction table exactly (the placements agree exactly on these
    cases); the probe's filter tallies, feasible counts and pressure
    exactly; priorities and victim columns, and the top-k scores and
    terms, at the JAX parity tolerances (rtol 1e-4, atol 1e-3: XLA on
    the CPU contracts multiply-adds, ROADMAP C1); the top-k node indices
    equal wherever the neighbouring scores differ by more than atol.
  * JAX's own invariants (tests/test_explain.py:77-140) on the port:
    the tallies partition the valid nodes, the terms sum to the total,
    empty slots are zero, every victim's evictor sits on its node.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels.assign import EXPLAIN_AUCTION_STATS as J_STATS
from tpusched.kernels.explain import FILTER_REASONS as J_REASONS
from tpusched.kernels.explain import SCORE_TERMS as J_TERMS
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import explain as tex
from tpusched_torch.snapshot import snapshot_from_numpy
from test_explain import _cluster

RTOL, ATOL = 1e-4, 1e-3


def _snap(case: str, cfg: JConfig):
    if case == "cluster":
        return _cluster(cfg)
    if case == "config5":
        return jsynth.config5_preemption(np.random.default_rng(45), 400, 100)
    return jsynth.config3_pairwise(np.random.default_rng(43), 200, 40)


CASES = {
    "cluster-fast": ("cluster", dict(mode="fast", preemption=True)),
    "cluster-parity": ("cluster", dict(mode="parity", preemption=True)),
    "config5-fast": ("config5", dict(mode="fast", preemption=True)),
    "config5-parity": ("config5", dict(mode="parity", preemption=True)),
    "config3-fast": ("config3", dict(mode="fast")),
    "config3-parity": ("config3", dict(mode="parity")),
}
_SOLVED: dict = {}


def _solved(name: str):
    """One explained solve a case for both packages (and the port's
    unexplained twin), shared by the tests of this module."""
    if name not in _SOLVED:
        case, kw = CASES[name]
        jcfg = JConfig(**kw)
        jsnap, meta = _snap(case, jcfg)
        jsnap = jax.device_put(jsnap)
        jeng = JEngine(jcfg)
        try:
            jres, jexd, jprobe = jeng.solve_explained(jsnap, k=3)
        finally:
            jeng.close()
        eng = Engine(EngineConfig.from_dict(dataclasses.asdict(jcfg)),
                     device="cpu")
        tsnap = snapshot_from_numpy(jax.device_get(jsnap))
        plain = eng.solve(tsnap)
        res, exd, probe = eng.solve_explained(tsnap, k=3)
        eng.close()
        _SOLVED[name] = SimpleNamespace(
            cfg=jcfg, meta=meta, tsnap=tsnap, jres=jres, jexd=jexd,
            jprobe=jprobe, plain=plain, res=res, exd=exd, probe=probe)
    return _SOLVED[name]


def test_layout_constants_equal_jax():
    assert tex.FILTER_REASONS == J_REASONS
    assert tex.SCORE_TERMS == J_TERMS
    assert tassign.EXPLAIN_AUCTION_STATS == J_STATS


@pytest.mark.parametrize("name", sorted(CASES))
def test_explained_solve_is_pure_observer(name):
    s = _solved(name)
    for f in ("assignment", "evicted", "commit_key", "order",
              "chosen_score", "final_used"):
        np.testing.assert_array_equal(getattr(s.res, f),
                                      getattr(s.plain, f))
    assert s.res.rounds == s.plain.rounds
    assert s.res.host_reads == s.plain.host_reads


@pytest.mark.parametrize("name", sorted(CASES))
def test_explained_solve_equals_jax(name):
    s = _solved(name)
    np.testing.assert_array_equal(s.res.assignment, s.jres.assignment)
    np.testing.assert_array_equal(s.res.evicted, s.jres.evicted)
    np.testing.assert_array_equal(s.exd.rolled, s.jexd.rolled)
    np.testing.assert_array_equal(s.exd.evictor, s.jexd.evictor)
    np.testing.assert_array_equal(s.exd.evict_round, s.jexd.evict_round)
    np.testing.assert_array_equal(s.exd.auction_stats,
                                  s.jexd.auction_stats)


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_equals_jax(name):
    s = _solved(name)
    p, j = s.probe, s.jprobe
    assert p.k == j.k == 3
    np.testing.assert_array_equal(p.filter_counts, j.filter_counts)
    np.testing.assert_array_equal(p.feasible_nodes, j.feasible_nodes)
    np.testing.assert_array_equal(p.pressure, j.pressure)
    for f in ("priority", "victim_priority", "victim_slack", "evict_cost",
              "topk_score", "topk_terms"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    # Node indices agree wherever the ranking is not decided by a
    # difference within the tolerance.
    v = j.topk_score
    sep = np.ones_like(p.topk_idx, bool)
    sep[:, 1:] &= np.abs(v[:, 1:] - v[:, :-1]) > ATOL
    sep[:, :-1] &= np.abs(v[:, :-1] - v[:, 1:]) > ATOL
    np.testing.assert_array_equal(p.topk_idx[sep], j.topk_idx[sep])
    np.testing.assert_array_equal(p.topk_idx < 0, j.topk_idx < 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_invariants_hold_on_the_port(name):
    s = _solved(name)
    probe, meta, res, exd = s.probe, s.meta, s.res, s.exd
    nP = meta.n_pods
    total = probe.feasible_nodes[:nP] + probe.filter_counts[:nP].sum(1)
    assert (total == meta.n_nodes).all()
    assert np.allclose(probe.topk_terms.sum(-1), probe.topk_score,
                       atol=1e-3)
    empty = probe.topk_idx < 0
    assert (probe.topk_score[empty] == 0).all()
    assert (probe.topk_terms[empty] == 0).all()
    node_idx = s.tsnap.running.node_idx.numpy()
    for m in np.flatnonzero(res.evicted):
        ev = int(exd.evictor[m])
        assert ev >= 0 and exd.evict_round[m] >= 0
        assert int(res.assignment[ev]) == int(node_idx[m])
    for m in np.flatnonzero(~res.evicted[:meta.n_running]):
        assert exd.evictor[m] == -1 and exd.evict_round[m] == -1
    col = tassign.EXPLAIN_AUCTION_STATS.index("evictions")
    if s.cfg.mode == "parity":
        assert not exd.auction_stats.any()
    else:
        assert exd.auction_stats[:, col].sum() == res.evicted.sum()
    if s.cfg.preemption:
        assert res.evicted.any()


def test_spread_and_interpod_columns_are_exercised():
    """The config-3 case reaches the probe's spread and inter-pod
    tallies and the normalised spread term (its values vary), so the
    S > 0 arm is held above."""
    p = _solved("config3-parity").probe
    assert p.filter_counts[:, J_REASONS.index("spread")].sum() > 0
    assert p.filter_counts[:, J_REASONS.index("interpod_affinity")].sum() > 0
    ts = p.topk_terms[..., J_TERMS.index("topology_spread")]
    assert len(np.unique(ts)) > 2


@pytest.mark.parametrize("k", [1, 2, 5])
def test_probe_k_slices_the_pow2_bucket(k):
    """k is ranked at its power-of-two bucket and sliced back: equal to
    the first k columns of a wider probe."""
    s = _solved("cluster-fast")
    eng = Engine(EngineConfig.from_dict(dataclasses.asdict(s.cfg)),
                 device="cpu")
    _, _, narrow = eng.solve_explained(s.tsnap, k=k)
    _, _, wide = eng.solve_explained(s.tsnap, k=8)
    eng.close()
    kk = min(k, s.tsnap.nodes.valid.shape[0])
    assert narrow.k == kk
    np.testing.assert_array_equal(narrow.topk_idx, wide.topk_idx[:, :kk])
    np.testing.assert_array_equal(narrow.topk_terms,
                                  wide.topk_terms[:, :kk])


@pytest.mark.parametrize("name", ["cluster-parity", "config5-parity"])
def test_k4_explain_outputs_of_the_plain_scans(name):
    """The plain preemption scan's explain outputs name, for each
    victim, the pod that evicted it and that pod's pop-order step; the
    scan's other outputs are those of the unexplained call."""
    s = _solved(name)
    cfg, snap = s.cfg, s.tsnap
    tcfg = EngineConfig.from_dict(dataclasses.asdict(cfg))
    static = tassign.precompute_static(tcfg, snap, *_sat_tables(snap))
    order = tassign.pop_order(tcfg, snap)
    pctx = tassign.kpre.precompute(tcfg, snap)
    got = tassign.parity_scan_preempt(tcfg, snap, static, order, pctx,
                                      explain=True)
    want = tassign.parity_scan_preempt(tcfg, snap, static, order, pctx)
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    ev, evictor, pos = got[3], got[4], got[5]
    assert ev.any()
    assert torch.equal(evictor >= 0, ev) and torch.equal(pos >= 0, ev)
    step = torch.empty_like(order)
    step[order] = torch.arange(order.shape[0])
    assert torch.equal(step[evictor[ev].long()].to(torch.int32), pos[ev])
