"""The device queue (ROADMAP A10): the port's `kernels/queue.py` (K21's
plain version on the CPU) and `device_state.DeviceQueue` against the JAX
package's, and both against the numpy oracle `rank_reference`, bit for
bit (order, priorities, both counts), on the tables of
tests/test_devqueue.py; the JAX package's ingest gate and simulator
driving the port's queue."""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.device_state import DeviceQueue as JQueue
from tpusched.ingest import IngestGate
from tpusched.kernels import queue as jq
from tpusched.sim import workloads
from tpusched.sim.driver import effective_config, run_scenario
from tpusched_torch.device_state import DeviceQueue
from tpusched_torch.kernels import queue as kq
from test_devqueue import _rand_table

CPU = functools.partial(DeviceQueue, device="cpu")


def test_sortable_u32_is_monotone_and_equals_jax():
    """The values of tests/test_devqueue.py:32: strictly increasing
    floats give strictly increasing keys, in numpy and in torch (int64
    holding the u32), equal to JAX's."""
    rng = np.random.default_rng(1)
    x = np.unique(np.concatenate([
        rng.uniform(-1e6, 1e6, 256).astype(np.float32),
        np.float32([0.0, -0.0, 1e-38, -1e-38, 3.0e38, -3.0e38]),
    ]))
    u = kq.sortable_u32(x)
    assert u.dtype == np.uint32 and np.all(u[:-1] < u[1:])
    np.testing.assert_array_equal(u, jq.sortable_u32(x))
    np.testing.assert_array_equal(
        np.asarray(jq.sortable_u32(jnp.asarray(x))), u)
    t = kq.sortable_u32(torch.from_numpy(x))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), u.astype(np.int64))


def test_qos_helpers_equal_jax():
    """The QoS helpers the queue and the probe read (tpusched/qos.py:32-89):
    the never-observed grace, availability, the priority's terms and
    slack, on the same values as JAX's."""
    from tpusched import qos as jqos
    from tpusched.config import EngineConfig as JConfig
    from tpusched_torch import EngineConfig
    from tpusched_torch import qos as tqos

    assert tqos.MIN_OBSERVED_AGE_S == jqos.MIN_OBSERVED_AGE_S
    for args in ((0.0, 5.0, None, 10.0), (0.0, 5.0, 8.0, 10.0),
                 (3.0, 0.0, None, 3.0 + 1e-12), (0.0, 50.0, None, 10.0),
                 (0.0, float("nan"), None, 10.0)):
        assert (tqos.observed_availability(*args)
                == jqos.observed_availability(*args))
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 100, 64).astype(np.float32)
    slo = rng.uniform(0, 1, 64).astype(np.float32)
    avail = rng.uniform(0, 1, 64).astype(np.float32)
    want = jqos.priority_terms(JConfig(), base, slo, avail)
    got = tqos.priority_terms(EngineConfig(), *(torch.from_numpy(x) for x in
                                                (base, slo, avail)))
    for k in ("pressure", "qos_boost", "effective"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_array_equal(
        tqos.slack_of(torch.from_numpy(slo), torch.from_numpy(avail)).numpy(),
        jqos.slack_of(slo, avail))


def test_k_bucket_equals_jax():
    for k, n in ((1, 1024), (3, 1024), (256, 1024), (257, 1024),
                 (5000, 1024), (7, 6)):
        assert kq.k_bucket(k, n) == jq.k_bucket(k, n)


def _jax_table(t):
    return jq.QueueTable(*[np.asarray(a) for a in t])


@pytest.mark.parametrize("q", [64, 256, 1024])
@pytest.mark.parametrize("seed", range(6))
def test_rank_full_equals_reference_and_jax(seed, q):
    """K21's plain version == rank_reference == JAX rank_full, bit for
    bit: order, priorities (as u32 bits), eligible and valid counts."""
    rng = np.random.default_rng(seed)
    now, gain = 60.0, 1000.0
    t = _rand_table(rng, q=q)
    order, prio, ne, dep = kq.rank_full(kq.to_device(t, "cpu"), now, gain)
    order_h, prio_h, ne_h, dep_h = kq.rank_reference(t, now, gain)
    order_j, prio_j, ne_j, dep_j = jq.rank_full(
        _jax_table(t), np.float32(now), np.float32(gain))
    np.testing.assert_array_equal(order.numpy(), order_h)
    np.testing.assert_array_equal(order_h, np.asarray(order_j))
    np.testing.assert_array_equal(prio.numpy().view(np.uint32),
                                  prio_h.view(np.uint32))
    np.testing.assert_array_equal(prio_h.view(np.uint32),
                                  np.asarray(prio_j).view(np.uint32))
    assert int(ne) == ne_h == int(ne_j)
    assert int(dep) == dep_h == int(dep_j)


@pytest.mark.parametrize("q", [5, 48, 100])
def test_rank_full_on_tables_of_any_size(q):
    """Capacities that are not powers of two (the kernel pads its keys
    to the next one) rank as the oracle does."""
    rng = np.random.default_rng(q)
    t = _rand_table(rng, q=q)
    order, prio, ne, dep = kq.rank_full(t, 30.0, 500.0)
    order_h, prio_h, ne_h, dep_h = kq.rank_reference(t, 30.0, 500.0)
    np.testing.assert_array_equal(order.numpy(), order_h)
    np.testing.assert_array_equal(prio.numpy().view(np.uint32),
                                  prio_h.view(np.uint32))
    assert (int(ne), int(dep)) == (ne_h, dep_h)


@pytest.mark.parametrize("seed", range(3))
def test_window_select_is_prefix_of_full_ranking(seed):
    rng = np.random.default_rng(100 + seed)
    now, gain = 45.0, 1000.0
    t = _rand_table(rng, q=32)
    order_h, prio_h, ne_h, dep_h = kq.rank_reference(t, now, gain)
    dt = kq.to_device(t, "cpu")
    for kb in (1, 3, 4, 16, 32, 64):
        win, prio, ne, dep = kq.window_select(dt, now, gain, kb)
        want = min(kq.k_bucket(kb, 10**9), 32)
        np.testing.assert_array_equal(win.numpy(), order_h[:want])
        np.testing.assert_array_equal(prio.numpy(), prio_h[order_h[:want]])
        assert (int(ne), int(dep)) == (ne_h, dep_h)
        jwin, *_ = jq.window_select(_jax_table(t), now, gain, min(kb, 32))
        np.testing.assert_array_equal(win.numpy()[:len(jwin)],
                                      np.asarray(jwin))


def test_ordering_contract_directed():
    """tests/test_devqueue.py:102's cases: the pressured pod first, the
    tie group in arrival order, the parked slot leading the ineligible
    tail."""
    t = kq.empty_table(8)
    now = 50.0
    for slot, seq in ((0, 3), (1, 1), (2, 2)):
        t.valid[slot] = True
        t.base_priority[slot] = 5.0
        t.submitted[slot] = 10.0
        t.seq[slot] = seq
    t.valid[3] = True
    t.base_priority[3] = 1.0
    t.slo_target[3] = 0.9
    t.submitted[3] = 10.0
    t.seq[3] = 7
    t.valid[4] = True
    t.base_priority[4] = 999.0
    t.submitted[4] = 10.0
    t.parked_until[4] = 100.0
    t.seq[4] = 0
    order, prio, ne, dep = kq.rank_full(t, now, 1000.0)
    assert int(dep) == 5 and int(ne) == 4
    assert list(order.numpy()[:5]) == [3, 1, 2, 0, 4]
    order_j, *_ = jq.rank_full(_jax_table(t), np.float32(now),
                               np.float32(1000.0))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))


def test_seq_above_int32_sorts_as_unsigned():
    """Arrival stamps at or above 2**31 (negative as int32 bits on the
    device) still sort as u32, after smaller ones."""
    t = kq.empty_table(4)
    t.valid[:] = True
    t.seq[:] = np.uint32([2**32 - 1, 5, 2**31, 2**31 - 1])
    order, *_ = kq.rank_full(t, 1.0, 1000.0)
    assert list(order.numpy()) == [1, 3, 2, 0]
    np.testing.assert_array_equal(order.numpy(),
                                  kq.rank_reference(t, 1.0, 1000.0)[0])


# -- DeviceQueue ------------------------------------------------------------


def _expected_window(dq, now: float, w: int):
    order, _prio, ne, dep = kq.rank_reference(dq._host, now - dq._epoch,
                                              dq.qos_gain)
    take = min(w, ne)
    return [dq._names[int(s)] for s in order[:take]], ne, dep


def test_device_queue_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueue()
    assert CPU().device == torch.device("cpu")


def test_device_queue_upsert_remove_park_semantics():
    dq = CPU(capacity=8)
    assert dq.window(0.0, 4) == ([], 0, 0)
    assert dq.upsert("a", base_priority=5.0, submitted=0.0)
    assert dq.upsert("b", base_priority=9.0, submitted=1.0)
    assert "a" in dq and dq.depth == 2
    assert dq.window(10.0, 4) == (["b", "a"], 2, 2)
    assert dq.upsert("a", base_priority=99.0, submitted=0.0)
    assert dq.depth == 2
    assert dq.window(10.0, 4)[0] == ["a", "b"]
    assert dq.park("a", until=20.0)
    assert dq.window(15.0, 4) == (["b"], 1, 2)
    assert dq.window(25.0, 4)[0] == ["a", "b"]
    assert not dq.park("ghost", until=20.0)
    assert dq.remove(["a", "ghost"]) == 1
    assert dq.remove(["a"]) == 0
    assert dq.window(25.0, 4)[0] == ["b"] and dq.depth == 1


def test_device_queue_bounded_sheds_new_names_only():
    dq = CPU(capacity=8, bound=2)
    assert dq.upsert("a", submitted=0.0)
    assert dq.upsert("b", submitted=0.0)
    assert not dq.upsert("c", submitted=0.0)
    assert dq.upsert("a", base_priority=3.0, submitted=0.0)
    assert dq.depth == 2 and "c" not in dq
    dq.remove(["a"])
    assert dq.upsert("c", submitted=0.0)
    assert dq.stats()["bound"] == 2


def test_device_queue_growth_preserves_rows():
    dq = CPU(capacity=4)
    for i in range(9):
        assert dq.upsert(f"p{i}", base_priority=float(i),
                         submitted=float(i))
    assert dq.capacity == 16 and dq.depth == 9
    names, ne, dep = dq.window(100.0, 16)
    assert ne == dep == 9
    assert names == [f"p{i}" for i in range(8, -1, -1)]
    assert names == _expected_window(dq, 100.0, 16)[0]


def test_device_queue_scatter_traffic_is_o_churn():
    dq = CPU(capacity=64)
    for i in range(40):
        dq.upsert(f"p{i:02d}", base_priority=float(i), submitted=0.0)
    dq.window(10.0, 8)
    assert dq.scatters == 0
    dq.upsert("p00", base_priority=50.0, submitted=0.0)
    dq.upsert("new", base_priority=1.0, submitted=10.0)
    dq.window(11.0, 8)
    assert dq.scatters == 1 and dq.scatter_rows_total == 2
    dq.window(12.0, 8)
    assert dq.scatters == 1
    # The device twin equals the mirror after the scatter.
    for a, h in zip(dq._dev, kq.to_device(dq._host, "cpu")):
        assert torch.equal(a, h)


@pytest.mark.parametrize("seed", range(4))
def test_device_queue_windows_equal_jax_under_churn(seed):
    """tests/test_devqueue.py:150-248's churn script driven into the
    port's queue and JAX's at once: every window (names, eligible count,
    depth) equal, and equal to the oracle over the port's mirror; the
    same scatter counts."""
    rng = np.random.default_rng(200 + seed)
    dq, jdq = CPU(capacity=16), JQueue(capacity=16)
    live: set = set()
    t = 0.0
    for _ in range(6):
        t += 7.0
        for _ in range(int(rng.integers(4, 14))):
            nm = f"p{int(rng.integers(0, 40)):03d}"
            kw = dict(base_priority=float(rng.integers(0, 6)),
                      slo_target=float(rng.choice([0.0, 0.9, 0.99])),
                      submitted=t - float(rng.uniform(0.0, 20.0)),
                      run_seconds=float(rng.uniform(0.0, 10.0)))
            assert dq.upsert(nm, **kw) == jdq.upsert(nm, **kw)
            live.add(nm)
        if live and rng.random() < 0.6:
            drop = sorted(live)[: int(rng.integers(1, 4))]
            assert dq.remove(drop) == jdq.remove(drop)
            live -= set(drop)
        if live and rng.random() < 0.5:
            until = t + float(rng.uniform(0, 15))
            nm = sorted(live)[0]
            assert dq.park(nm, until=until) == jdq.park(nm, until=until)
        got = dq.window(t, w=8)
        assert got == jdq.window(t, w=8)
        assert got == _expected_window(dq, t, 8)
        assert got[2] == len(live)
    assert dq.stats() == jdq.stats()


def test_ingest_gate_over_the_port_queue():
    """tpusched.ingest.IngestGate over the port's bounded queue and over
    JAX's: the same admissions, sheds, depths and drained windows."""
    rng = np.random.default_rng(7)
    gates = [IngestGate(q, rate=50.0, burst=20.0, tenants=2, skew=1.0,
                        clock=lambda: 0.0, dedup=True)
             for q in (CPU(capacity=16, bound=24),
                       JQueue(capacity=16, bound=24))]
    now = 0.0
    for step in range(8):
        now += 0.5
        pods = [dict(name=f"p{int(rng.integers(0, 60)):02d}",
                     priority=float(rng.integers(0, 9)),
                     slo_target=float(rng.choice([0.0, 0.5, 0.99])),
                     submitted=now - float(rng.uniform(0, 3)),
                     run_seconds=float(rng.uniform(0, 1)))
                for _ in range(int(rng.integers(4, 16)))]
        tenant = step % 2
        got, want = (g.offer(pods, tenant=tenant, now=now) for g in gates)
        assert got == want
        if step % 3 == 2:
            w = int(rng.integers(1, 10))
            assert (gates[0].take_window(now=now, w=w)
                    == gates[1].take_window(now=now, w=w))
    assert gates[0].stats() == gates[1].stats()
    assert gates[0].shed_capacity + gates[0].shed_rate > 0


def test_sim_device_queue_run_equals_jax(monkeypatch):
    """run_scenario(pressure_skew, horizon 100 s, device_queue=True): the
    JAX host with the port's queue (monkeypatched in, on the CPU) and
    the port's engine gives the JAX run's event-log hash."""
    from tpusched import Engine as JEngine
    from tpusched import host as jhost
    from tpusched_torch import Engine, EngineConfig

    sc = dataclasses.replace(workloads.SCENARIOS["pressure_skew"],
                             horizon_s=100.0)
    cfg = effective_config(sc, None)
    jeng = JEngine(cfg)
    try:
        want = run_scenario(sc, 0, config=cfg, engine=jeng,
                            device_queue=True)
    finally:
        jeng.close()
    made = []

    def port_queue(**kw):
        made.append(CPU(**kw))
        return made[-1]

    monkeypatch.setattr(jhost, "DeviceQueue", port_queue)
    eng = Engine(EngineConfig.from_dict(dataclasses.asdict(cfg)),
                 device="cpu")
    got = run_scenario(sc, 0, config=cfg, engine=eng, device_queue=True)
    eng.close()
    assert len(made) == 1 and made[0].windows > 0
    assert got.event_log_hash == want.event_log_hash
    assert got.completions == want.completions
    assert [p.name for p in got.pods] == [p.name for p in want.pods]
