"""The port's warm path (`Engine.solve_warm` over `device_state.
DeviceSnapshot`), after the cases of tests/test_warm.py:

  * warm == cold, bitwise (assignment, chosen_score, evicted), on every
    cycle: value churn, row reorders, completions, cordon toggles, a
    forced rebuild (cold rung) and back, signatures, preemption with
    gangs, a pressure cross, lineage and engine moves;
  * the port's tableau equals the JAX package's `WarmTableau`, leaf for
    leaf, after the build and after every refresh: a JAX lineage fed the
    same records gives the same warm delta, and the JAX package's
    `build_tableau` / `refresh_tableau` (jitted here) run on it;
  * the port's warm parity result equals the JAX parity engine's cold
    solve of the same state (assignment, order, evicted exactly;
    chosen_score at the JAX tests' tolerances, ROADMAP C1).

Port lineages and engines run on the CPU (device="cpu")."""

from __future__ import annotations

import copy
import dataclasses

import jax
import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import EngineConfig as JConfig
from tpusched.device_state import DeviceSnapshot as JDeviceSnapshot
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.device_state import DeviceSnapshot
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.synth import make_cluster, warm_churn_stream

from test_warm import _nosig_records


@pytest.fixture(scope="module")
def fast_engine():
    return Engine(EngineConfig(mode="fast"), device="cpu")


_JAX_TABLEAU = {}


def _jax_tableau_fns(cfg: JConfig):
    """Jitted JAX build / refresh of the tableau, one pair a config."""
    key = (cfg.mode, cfg.preemption)
    if key not in _JAX_TABLEAU:
        _JAX_TABLEAU[key] = (
            jax.jit(lambda s: jassign.build_tableau(cfg, s,
                                                    *jax_sat_tables(s))),
            jax.jit(lambda s, t, dp, dn, dm, pp, np_, mp:
                    jassign.refresh_tableau(cfg, s, t, dp, dn, dm, pp, np_,
                                            mp)))
    return _JAX_TABLEAU[key]


def _pad(idx):
    return Engine._pad_idx(idx)


class WarmTwin:
    """A port lineage solved by the port engine's warm path, beside a
    JAX lineage whose tableau the JAX functions keep (no JAX solve)."""

    def __init__(self, engine: Engine, nodes, pods, running):
        self.engine = engine
        self.jcfg = JConfig.from_dict(dataclasses.asdict(engine.config))
        self.port = DeviceSnapshot(engine.config, device="cpu")
        self.jax = JDeviceSnapshot(self.jcfg)
        self.port.full_load(nodes, pods, running)
        self.jax.full_load(nodes, pods, running)
        self.jtab = None

    def apply(self, **delta):
        a = self.port.apply(**delta)
        b = self.jax.apply(**delta)
        assert (a.path, a.reason) == (b.path, b.reason)
        return a

    def warm(self, context: str, incremental: bool = False):
        """One warm solve on the port; the JAX tableau follows the same
        delta (built anew where the port went cold); the two tableaux
        must be equal."""
        pd, jd = self.port.warm_delta(), self.jax.warm_delta()
        for f in ("needs_cold", "reason", "dirty_pods", "dirty_nodes",
                  "dirty_members"):
            assert getattr(pd, f) == getattr(jd, f), (context, f)
        for f in ("pod_perm", "node_perm", "member_perm"):
            a, b = getattr(pd, f), getattr(jd, f)
            assert (a is None) == (b is None), (context, f)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        marker = self.port.warm_marker()
        res = self.engine.solve_warm(self.port, incremental=incremental)
        build, refresh = _jax_tableau_fns(self.jcfg)
        if self.port.warm_path_taken(marker) == "cold":
            self.jtab = build(self.jax.snap)
        else:
            self.jtab = refresh(
                self.jax.snap, self.jtab, _pad(jd.dirty_pods),
                _pad(jd.dirty_nodes), _pad(jd.dirty_members), jd.pod_perm,
                jd.node_perm, jd.member_perm)
        self.jax.commit_warm(None, path="warm", reason="",
                             rows=self.port.last_warm_rows)
        tab = self.port.warm_state.tableau  # tpl: disable=TPL011(read right after its refresh)
        for i, (g, w) in enumerate(zip(tab.leaves(),
                                       jax.tree.leaves(self.jtab))):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (context, i)
            np.testing.assert_array_equal(g, w, err_msg=f"{context} leaf {i}")
        return res


def _twin(engine: Engine, ds: DeviceSnapshot, context: str = "", res=None):
    """A warm and a cold solve of the same lineage state, equal bitwise
    in placements, scores and evictions."""
    warm = res if res is not None else engine.solve_warm(ds)
    cold = engine.solve(ds.snap)
    np.testing.assert_array_equal(warm.assignment, cold.assignment,
                                  err_msg=f"assignment {context}")
    np.testing.assert_array_equal(warm.chosen_score, cold.chosen_score,
                                  err_msg=f"chosen_score {context}")
    np.testing.assert_array_equal(warm.evicted, cold.evicted,
                                  err_msg=f"evicted {context}")
    return warm, cold


def test_warm_twin_parity_50_cycles_with_cold_fallbacks(fast_engine):
    rng = np.random.default_rng(42)
    nodes, pods, running = _nosig_records(rng)
    tw = WarmTwin(fast_engine, nodes, pods, running)
    ds = tw.port
    cycles = 0
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 50, churn_frac=0.15,
            structural_every=6)):
        if cyc == 25:
            extra = [dict(name=f"burst-{j:03d}", requests={"cpu": 20.0},
                          observed_avail=1.0)
                     for j in range(ds.meta.buckets.pods - len(pods) + 1)]
            pods.extend(extra)
            stats = tw.apply(upsert_pods=extra)
            assert stats.path == "rebuild" and stats.reason == "row_bucket"
        tw.apply(**delta)
        res = tw.warm(f"cycle {cyc}")
        _twin(fast_engine, ds, f"at cycle {cyc}", res)
        cycles += 1
    assert cycles == 50
    assert "row_bucket" in ds.warm_cold_reasons
    assert ds.cold_solves == 2, ds.warm_cold_reasons
    assert ds.warm_solves == 48
    assert ds.full_uploads == 2


def test_warm_parity_pairwise_sigs(fast_engine):
    rng = np.random.default_rng(7)
    nodes, pods, running = make_cluster(
        rng, 20, 6, as_records=True, spread_frac=0.4, interpod_frac=0.4,
        run_anti_frac=0.2, namespace_count=2)
    nodes, pods, running = list(nodes), list(pods), list(running)
    tw = WarmTwin(fast_engine, nodes, pods, running)
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 10, churn_frac=0.2,
            structural_every=3)):
        tw.apply(**delta)
        res = tw.warm(f"(sigs) cycle {cyc}")
        _twin(fast_engine, tw.port, f"(sigs) at cycle {cyc}", res)
    assert tw.port.warm_solves >= 8
    assert tw.port.snap.sigs.key.shape[0] > 0


def test_warm_parity_preemption_and_gangs():
    eng = Engine(EngineConfig(mode="fast", preemption=True), device="cpu")
    rng = np.random.default_rng(11)
    nodes, pods, running = make_cluster(
        rng, 18, 5, as_records=True, initial_utilization=0.8,
        n_running_per_node=3, pdb_frac=0.3, gang_frac=0.25, gang_size=2,
        tight_utilization=True)
    nodes, pods, running = list(nodes), list(pods), list(running)
    tw = WarmTwin(eng, nodes, pods, running)
    evicted_any = False
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 8, churn_frac=0.25,
            structural_every=4)):
        tw.apply(**delta)
        res = tw.warm(f"(preempt) cycle {cyc}")
        warm, _ = _twin(eng, tw.port, f"(preempt) at cycle {cyc}", res)
        evicted_any = evicted_any or bool(warm.evicted.any())
    assert tw.port.warm_solves >= 6
    assert evicted_any


@pytest.mark.parametrize("preemption", [False, True])
def test_warm_parity_mode_equals_the_jax_parity_engine(preemption):
    """Parity mode on the warm path: port warm == port cold bitwise, and
    == the JAX parity engine's solve of the JAX lineage's snapshot."""
    cfg = EngineConfig(mode="parity", preemption=preemption)
    eng = Engine(cfg, device="cpu")
    jeng = JEngine(JConfig(mode="parity", preemption=preemption))
    try:
        rng = np.random.default_rng(11 if preemption else 42)
        if preemption:
            nodes, pods, running = make_cluster(
                rng, 18, 5, as_records=True, initial_utilization=0.8,
                n_running_per_node=3, pdb_frac=0.3, gang_frac=0.25,
                gang_size=2, tight_utilization=True)
        else:
            nodes, pods, running = _nosig_records(rng)
        nodes, pods, running = list(nodes), list(pods), list(running)
        tw = WarmTwin(eng, nodes, pods, running)
        for cyc, delta in enumerate(warm_churn_stream(
                rng, nodes, pods, running, 6, churn_frac=0.2,
                structural_every=3)):
            tw.apply(**delta)
            res = tw.warm(f"(parity) cycle {cyc}")
            _twin(eng, tw.port, f"(parity) at cycle {cyc}", res)
            want = jeng.solve(tw.jax.snap)
            for f in ("assignment", "order", "evicted"):
                np.testing.assert_array_equal(
                    getattr(res, f), getattr(want, f),
                    err_msg=f"{f} vs JAX at cycle {cyc}")
            np.testing.assert_allclose(res.chosen_score, want.chosen_score,
                                       rtol=1e-4, atol=1e-3)
        assert tw.port.warm_solves >= 4
    finally:
        jeng.close()


def test_pressure_cross_changes_order_without_dirtying_the_row():
    eng = Engine(EngineConfig(mode="fast", preemption=True), device="cpu")
    nodes = [dict(name="n0", allocatable={"cpu": 1000.0})]
    pods = [
        dict(name="px", requests={"cpu": 900.0}, priority=10.0,
             slo_target=0.9, observed_avail=0.95),
        dict(name="py", requests={"cpu": 900.0}, priority=10.5,
             slo_target=0.9, observed_avail=0.95),
    ]
    running = [dict(name="r0", node="n0", requests={"cpu": 50.0},
                    priority=0.0, slack=0.5)]
    tw = WarmTwin(eng, nodes, pods, running)
    w0, _ = _twin(eng, tw.port, "(pre-cross)", tw.warm("pre-cross"))
    iy = tw.port.meta.pod_names.index("py")
    ix = tw.port.meta.pod_names.index("px")
    assert w0.assignment[iy] >= 0 and w0.assignment[ix] < 0
    pods[0]["observed_avail"] = 0.1
    tw.apply(upsert_pods=[pods[0]])
    w1, _ = _twin(eng, tw.port, "(post-cross)", tw.warm("post-cross"))
    assert w1.assignment[ix] >= 0 and w1.assignment[iy] < 0
    assert tw.port.last_warm_rows[0] == 1
    assert tw.port.warm_solves >= 1


def test_cordon_invalidates_the_node_column(fast_engine):
    rng = np.random.default_rng(3)
    nodes, pods, running = _nosig_records(rng, n_pods=10, n_nodes=4,
                                          n_running=3)
    for n in nodes:
        n["unschedulable"] = False
    tw = WarmTwin(fast_engine, nodes, pods, running)
    w0, _ = _twin(fast_engine, tw.port, "(pre-cordon)", tw.warm("pre"))
    placed = w0.assignment[w0.assignment >= 0]
    assert placed.size
    target = int(np.bincount(placed).argmax())
    crec = next(n for n in nodes
                if n["name"] == tw.port.meta.node_names[target])
    crec["unschedulable"] = True
    tw.apply(upsert_nodes=[crec])
    w1, _ = _twin(fast_engine, tw.port, "(post-cordon)", tw.warm("post"))
    assert not (w1.assignment == target).any()
    assert tw.port.last_warm_rows[1] >= 1


def test_warm_dispatch_overlaps_the_next_apply(fast_engine):
    """apply(k + 1) between the dispatch of cycle k and its join (the
    JAX package's warm_cycle_stream overlap): each joined result equals
    a cold solve of a twin lineage at cycle k."""
    rng = np.random.default_rng(9)
    nodes, pods, running = _nosig_records(rng, n_pods=12, n_nodes=5,
                                          n_running=3)
    ds_warm = DeviceSnapshot(fast_engine.config, device="cpu")
    ds_warm.full_load(nodes, pods, running)
    ds_cold = DeviceSnapshot(fast_engine.config, device="cpu")
    ds_cold.full_load(nodes, pods, running)
    deltas = [copy.deepcopy(d) for d in warm_churn_stream(
        rng, nodes, pods, running, 6, churn_frac=0.2, structural_every=3)]
    ds_warm.apply(**copy.deepcopy(deltas[0]))
    for cyc in range(6):
        pending = fast_engine.solve_warm_async(ds_warm)
        if cyc + 1 < 6:
            ds_warm.apply(**copy.deepcopy(deltas[cyc + 1]))
        res = pending.result()
        ds_cold.apply(**copy.deepcopy(deltas[cyc]))
        cold = fast_engine.solve(ds_cold.snap)
        np.testing.assert_array_equal(res.assignment, cold.assignment,
                                      err_msg=f"cycle {cyc}")
    assert ds_warm.warm_solves >= 5


def test_warm_handle_does_not_survive_lineage_moves(fast_engine):
    rng = np.random.default_rng(5)
    nodes, pods, running = _nosig_records(rng, n_pods=10, n_nodes=4,
                                          n_running=3)
    ds_a = DeviceSnapshot(fast_engine.config, device="cpu")
    ds_a.full_load(nodes, pods, running)
    ds_b = DeviceSnapshot(fast_engine.config, device="cpu")
    ds_b.full_load(nodes, pods, running)
    fast_engine.solve_warm(ds_a)
    fast_engine.solve_warm(ds_b)
    pods[0]["observed_avail"] = 0.2
    ds_b.apply(upsert_pods=[pods[0]])
    ds_b.warm_state = ds_a.warm_state
    _twin(fast_engine, ds_b, "(foreign handle)")
    assert ds_b.warm_cold_reasons[-1] == "lineage_mismatch"
    eng2 = Engine(EngineConfig(mode="fast"), device="cpu")
    pods[1]["observed_avail"] = 0.3
    ds_b.apply(upsert_pods=[pods[1]])
    res = eng2.solve_warm(ds_b)
    np.testing.assert_array_equal(res.assignment,
                                  eng2.solve(ds_b.snap).assignment)
    eng2.close()
    assert ds_b.warm_cold_reasons[-1] == "engine_mismatch"


def test_warm_audit_smoke(fast_engine):
    """The JAX package's warm audit at its smoke size (16 pods, 5
    nodes, the plain preset): no cycle diverges, and the tableau stays
    the JAX package's; the resident lineage ships no full snapshot."""
    rng = np.random.default_rng(4000)
    nodes, pods, running = make_cluster(rng, 16, 5, as_records=True)
    nodes, pods, running = list(nodes), list(pods), list(running)
    tw = WarmTwin(fast_engine, nodes, pods, running)
    full = tw.port.full_bytes
    diverged = -1
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 6, churn_frac=0.2)):
        tw.apply(**delta)
        res = tw.warm(f"(audit) cycle {cyc}")
        cold = fast_engine.solve(tw.port.snap)
        if diverged < 0 and not (
                np.array_equal(res.assignment, cold.assignment)
                and np.array_equal(res.chosen_score, cold.chosen_score)):
            diverged = cyc
        if cyc:
            assert 0 < res.h2d_bytes < full / 4
    assert diverged == -1
    assert tw.port.warm_solves == 5


def test_tableau_refresh_equals_a_fresh_build(fast_engine):
    """refresh_tableau over a lineage's deltas gives the tableau a full
    build of the current snapshot gives, every leaf."""
    rng = np.random.default_rng(7)
    nodes, pods, running = make_cluster(
        rng, 24, 6, as_records=True, spread_frac=0.4, interpod_frac=0.4,
        run_anti_frac=0.2, namespace_count=2, taint_frac=0.3,
        toleration_frac=0.3, selector_frac=0.3, affinity_frac=0.3)
    nodes, pods, running = list(nodes), list(pods), list(running)
    ds = DeviceSnapshot(fast_engine.config, device="cpu")
    ds.full_load(nodes, pods, running)
    fast_engine.solve_warm(ds)
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 6, churn_frac=0.2,
            structural_every=2)):
        ds.apply(**delta)
        fast_engine.solve_warm(ds)
        fresh = fast_engine._tableau_cold(ds.snap)
        tab = ds.warm_state.tableau  # tpl: disable=TPL011(read right after its refresh)
        for g, w in zip(tab.leaves(), fresh.leaves()):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert bool((g == w).all()), cyc
    assert ds.warm_solves == 6
    assert isinstance(tab, tassign.WarmTableau)
