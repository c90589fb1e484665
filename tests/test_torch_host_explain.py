"""Decision provenance through the JAX package's own host and simulator
with the port's engine injected: `HostScheduler` with an enabled
`ExplainCollector` calls `Engine.solve_explained_async` every cycle and
builds its records with `tpusched.explain.build_record`; the simulator's
miss attribution joins them. With the port engine the records (outcomes,
tallies, feasible counts, evictors and their rounds) equal those of the
JAX engine's host, and the explained sim run gives the JAX run's
event-log hash and miss causes."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import explain as ex
from tpusched.config import EngineConfig as JConfig
from tpusched.host import FakeApiServer, HostScheduler
from tpusched.sim import report as sim_report
from tpusched.sim import workloads
from tpusched.sim.driver import effective_config, run_scenario
from tpusched_torch import Engine, EngineConfig
from test_explain import _tiny_scenario

# Record fields compared exactly; the scores are held to the JAX parity
# tolerances (XLA on the CPU contracts multiply-adds, ROADMAP C1).
EXACT = ("pod_names", "outcome", "assignment", "commit_key",
         "filter_counts", "feasible_nodes", "evicted", "evictor",
         "evict_round", "pressure")
CLOSE = ("priority", "topk_score", "topk_terms", "victim_priority",
         "victim_slack", "evict_cost", "chosen_score")


def _port(cfg: JConfig) -> Engine:
    return Engine(EngineConfig.from_dict(dataclasses.asdict(cfg)),
                  device="cpu")


def _same_records(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in EXACT:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, f
        for f in CLOSE:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-4, atol=1e-3, err_msg=f)
        assert g.auction == w.auction


def _api() -> FakeApiServer:
    """Two nodes full of cheap running pods, a pressured preemptor, an
    unschedulable giant, a small pod and a gang short of its quorum:
    every outcome of a DecisionRecord."""
    api = FakeApiServer()
    for j in range(2):
        api.add_node(f"n{j}", allocatable={"cpu": 4000.0,
                                           "memory": float(64 << 30)})
        api.add_pod(f"v{j}", requests={"cpu": 4000.0,
                                       "memory": float(1 << 30)},
                    priority=10.0, slo_target=0.5)
        api.bind(f"v{j}", f"n{j}")
        api.set_observed_availability(f"v{j}", 0.8 - 0.25 * j)
    api.add_pod("p-preempt", requests={"cpu": 2000.0,
                                       "memory": float(1 << 30)},
                priority=200.0, slo_target=0.99)
    api.add_pod("p-giant", requests={"cpu": 90000.0,
                                     "memory": float(1 << 30)}, priority=5.0)
    api.add_pod("p-small", requests={"cpu": 100.0, "memory": float(1 << 30)},
                priority=1.0)
    for nm in ("g-a", "g-b"):
        api.add_pod(nm, requests={"cpu": 100.0, "memory": float(1 << 30)},
                    pod_group="g", pod_group_min_member=3)
    for nm in ("p-preempt", "p-giant", "p-small", "g-a", "g-b"):
        api.set_observed_availability(nm, 0.2)
    return api


def _host_records(cfg: JConfig, engine) -> list:
    col = ex.ExplainCollector(capacity=64, enabled=True)
    clock = iter(float(t) for t in range(1000))
    host = HostScheduler(_api(), cfg, engine=engine, explain=col,
                         clock=lambda: next(clock))
    try:
        for _ in range(3):
            host.cycle()
    finally:
        host.close()
    return col.records()


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_host_explained_records_equal_jax(mode):
    cfg = JConfig(mode=mode, preemption=True)
    jeng = JEngine(cfg)
    try:
        want = _host_records(cfg, jeng)
    finally:
        jeng.close()
    port = _port(cfg)
    got = _host_records(cfg, port)
    port.close()
    _same_records(got, want)
    first = got[0]
    outcomes = {ex.OUTCOMES[int(o)] for o in first.outcome}
    assert {ex.OUTCOME_PREEMPTOR, ex.OUTCOME_PENDING,
            ex.OUTCOME_GANG_HELD} <= outcomes
    assert first.evicted.any()


@pytest.mark.parametrize("scenario,horizon", [("tiny", None),
                                              ("pressure_skew", 100.0)])
def test_sim_explained_run_equals_jax(scenario, horizon):
    """run_scenario(..., explain=collector) with the port engine: the
    JAX run's event-log hash, records and miss attribution."""
    sc = (_tiny_scenario() if scenario == "tiny"
          else dataclasses.replace(workloads.SCENARIOS[scenario],
                                   horizon_s=horizon))
    cfg = effective_config(sc, None)
    runs = []
    for engine in (JEngine(cfg), _port(cfg)):
        col = ex.ExplainCollector(capacity=4096, enabled=True)
        try:
            res = run_scenario(sc, seed=0, config=cfg, engine=engine,
                               explain=col)
        finally:
            engine.close()
        runs.append((res, col.records()))
    (want, want_recs), (got, got_recs) = runs
    assert got.event_log_hash == want.event_log_hash
    _same_records(got_recs, want_recs)
    att, want_att = (sim_report.miss_attribution(r, recs)
                     for r, recs in ((got, got_recs), (want, want_recs)))
    assert att["causes"] == want_att["causes"]
    assert att["misses"] == want_att["misses"] > 0
    assert {k: v["cause"] for k, v in att["pods"].items()} == {
        k: v["cause"] for k, v in want_att["pods"].items()}
