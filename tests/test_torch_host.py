"""The JAX package's own host and simulator driving the port's engine
(ROADMAP A5): the port `Engine` is injected into `SimDriver` and
`HostScheduler`, which call only its async and warm entry points.

  * The simulator's run is a pure function of the placements, and its
    sha256 event-log hash covers every applied event: with the port
    engine it must equal the run with the JAX engine, in parity mode,
    in the sim's default fast mode, and in fast mode with preemption.
    The hashes are pinned, and the SLO attainment compared.
  * `HostScheduler(warm=True)` keeps a device-resident lineage (the JAX
    package's DeviceSnapshot, which the port engine reads through numpy)
    and warm-solves each cycle: its binds must equal the plain JAX
    host's, and a failed cycle must drop the lineage. warm="incremental"
    must bind the whole cluster and unwind the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import EngineConfig as JConfig
from tpusched.host import FakeApiServer, HostScheduler, build_synthetic_cluster
from tpusched.sim import report as sim_report
from tpusched.sim import workloads
from tpusched.sim.driver import SimDriver
from tpusched_torch import Engine, EngineConfig

# The event-log hashes of seed 0 with the JAX engine (the port must give
# the same): (mode, preemption, scenario) -> sha256.
PINNED = {
    ("parity", False, "steady_state"):
        "2edf193254de15a3ea1a8f34b9070494ec655c463b81eb8c4d9573836c8bc0c5",
    ("parity", False, "pressure_skew"):
        "3e09f46d83e534fd03363524e35437ba88ed05eaf6e5ca11943882105d59df26",
    ("fast", False, "steady_state"):
        "fe972e8ecea0ec16a53583455501689f3b5e835424997d7739eeef790a2b5edc",
    ("fast", False, "pressure_skew"):
        "90ad09407ee351d60a59815bc360a1222c8eea041537ba51c17b1cb057cbefca",
    ("fast", True, "pressure_skew"):
        "3e02b00507e8b9d61eeb2eeb8e4d78136bcc2b7723d968b03862471b08a3499e",
}


def _port_engine(cfg: JConfig) -> Engine:
    """The port engine with a config equal to the JAX one, field by
    field (buckets, mode, preemption, QoS, weights)."""
    return Engine(EngineConfig.from_dict(dataclasses.asdict(cfg)),
                  device="cpu")


def _run(scenario: str, cfg: JConfig, engine):
    res = SimDriver(workloads.SCENARIOS[scenario], seed=0, engine=engine,
                    config=cfg).run()
    return res.event_log_hash, sim_report.summarize(res)


@pytest.mark.parametrize("mode,preempt,scenario", [
    ("parity", False, "steady_state"),
    ("parity", False, "pressure_skew"),
    ("fast", False, "steady_state"),
    ("fast", False, "pressure_skew"),
    ("fast", True, "pressure_skew"),
])
def test_sim_twin_event_log_hash(mode, preempt, scenario):
    cfg = JConfig(mode=mode, preemption=preempt)
    jeng = JEngine(cfg)
    try:
        want_hash, want = _run(scenario, cfg, jeng)
    finally:
        jeng.close()
    port = _port_engine(cfg)
    got_hash, got = _run(scenario, cfg, port)
    assert got_hash == want_hash == PINNED[(mode, preempt, scenario)]
    assert got["slo_attainment_frac"] == want["slo_attainment_frac"]
    assert got["slo_pods"] == want["slo_pods"] > 0


def test_port_config_equals_the_jax_one():
    for kw in (dict(mode="parity"), dict(mode="fast", preemption=True),
               dict(mode="fast", compact_cap=8, tie_break="seeded",
                    tie_seed=5)):
        cfg = JConfig(**kw)
        got = dataclasses.asdict(_port_engine(cfg).config)
        assert got == dataclasses.asdict(cfg)


def _cluster(seed: int, n_pods: int, n_nodes: int, pin_avail: bool = True):
    api = FakeApiServer()
    build_synthetic_cluster(api, np.random.default_rng(seed), n_pods,
                            n_nodes)
    if pin_avail:
        # Lifecycle accounting decays with wall time: pin it so both
        # runs see the same inputs.
        rng = np.random.default_rng(99)
        for i in range(n_pods):
            api.set_observed_availability(f"pod-{i}",
                                          float(rng.uniform(0.4, 1.0)))
    return api


def _plain_binds(cfg: JConfig, seed: int, n_pods: int, n_nodes: int,
                 batch: int) -> dict:
    jeng = JEngine(cfg)
    api = _cluster(seed, n_pods, n_nodes)
    host = HostScheduler(api, cfg, engine=jeng, batch_size=batch)
    try:
        host.run_until_idle(max_cycles=30)
    finally:
        host.close()
        jeng.close()
    return {p["name"]: p["node"] for p in api.bound_pods()}


@pytest.mark.parametrize("warm", [True, "incremental"])
def test_host_warm_binds_as_the_jax_plain_host(warm):
    """The warm host with the port engine, over the JAX lineage, binds
    what the decode-every-cycle JAX host binds; a wedged cycle drops the
    lineage (and its carry) and the host still converges."""
    cfg = JConfig(mode="fast")
    want = _plain_binds(cfg, 17, 30, 5, 12)
    eng = _port_engine(cfg)
    api = _cluster(17, 30, 5)
    host = HostScheduler(api, cfg, engine=eng, batch_size=12, warm=warm)
    try:
        host.cycle()
        ds0 = host._warm_ds
        assert ds0 is not None and ds0.cold_solves == 1
        real = eng.solve_warm_async
        calls = {"n": 0}

        def boom(ds, incremental=False):
            calls["n"] += 1
            raise RuntimeError("injected warm failure")

        eng.solve_warm_async = boom
        try:
            with pytest.raises(RuntimeError, match="injected"):
                host.cycle()
        finally:
            eng.solve_warm_async = real
        assert calls["n"] == 1
        assert host._warm_ds is None
        assert ds0.warm_state is None and ds0.carry_arrays() is None
        host.run_until_idle(max_cycles=30)
    finally:
        host.close()
    got = {p["name"]: p["node"] for p in api.bound_pods()}
    assert not api.pending_pods()
    assert got == want


def test_host_warm_lineage_counts_warm_cycles():
    """Over a multi-cycle drain the JAX lineage rides the port engine's
    warm rung (not only the cold one); the port reads that foreign
    lineage through numpy, a full transfer every cycle, and each result
    counts it."""
    cfg = JConfig(mode="fast")
    eng = _port_engine(cfg)
    api = _cluster(23, 40, 6)
    host = HostScheduler(api, cfg, engine=eng, batch_size=8, warm=True)
    moved = []
    real = eng.solve_warm_async

    def spy(ds, incremental=False):
        pending = real(ds, incremental=incremental)
        join = pending.result

        def result(timeout=None):
            res = join(timeout)
            moved.append((res.h2d_bytes, eng.put(ds.snap)))
            return res

        pending.result = result
        return pending

    eng.solve_warm_async = spy
    try:
        host.run_until_idle(max_cycles=30)
        ds = host._warm_ds
    finally:
        host.close()
    assert not api.pending_pods()
    assert ds is not None and ds.warm_solves >= 1, ds.warm_cold_reasons
    assert len(moved) >= 3
    for h2d, snap in moved:
        full = sum(t.numel() * t.element_size() for t in snap.leaves())
        assert h2d >= full > 0


if __name__ == "__main__":
    # The sim twins' numbers: each case's hash and SLO attainment with
    # the JAX engine and with the port's.
    for (mode, preempt, scenario) in PINNED:
        cfg = JConfig(mode=mode, preemption=preempt)
        jeng = JEngine(cfg)
        try:
            jh, js = _run(scenario, cfg, jeng)
        finally:
            jeng.close()
        ph, ps = _run(scenario, cfg, _port_engine(cfg))
        print(f"{mode} preemption={preempt} {scenario}: hash JAX {jh} "
              f"port {ph} ({'equal' if jh == ph else 'DIFFERENT'}); SLO "
              f"attainment JAX {js['slo_attainment_frac']} port "
              f"{ps['slo_attainment_frac']} of {ps['slo_pods']} SLO pods")
