"""The port's incremental warm solve (`Engine.solve_warm(incremental=
True)`, `kernels/assign.solve_incremental`), after the incremental
cases of tests/test_frontier.py. Not bitwise against a cold solve (the
JAX package's own contract): every cycle must keep the validity
contract, which the solve's audit tail reports (all zeros) and the JAX
package's oracle re-checks on the JAX lineage fed the same records;
forced spills (cordon, capacity shrink) re-place instead of
overflowing; the carry dies with the lineage.

K19's and K20's plain versions (what the CPU runs) are held against the
JAX package's expressions: K19 bitwise where f32 sums are exact
(requests multiples of 2**20), and against an f64 reference at config-5
magnitudes; K20 exactly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import EngineConfig as JConfig
from tpusched.device_state import DeviceSnapshot as JDeviceSnapshot
from tpusched.kernels import assign as jassign
from tpusched.oracle import validate_assignment
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.device_state import DeviceSnapshot
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.synth import make_cluster, warm_churn_stream


@pytest.fixture(scope="module")
def inc_engine():
    return Engine(EngineConfig(mode="fast"), device="cpu")


class Lineages:
    """The port lineage the port engine solves, and the JAX lineage fed
    the same records, whose snapshot the oracle audits."""

    def __init__(self, cfg: EngineConfig, nodes, pods, running):
        self.port = DeviceSnapshot(cfg, device="cpu")
        self.jax = JDeviceSnapshot(JConfig(mode=cfg.mode,
                                           preemption=cfg.preemption))
        self.port.full_load(nodes, pods, running)
        self.jax.full_load(nodes, pods, running)

    def apply(self, **delta):
        self.port.apply(**delta)
        self.jax.apply(**delta)

    def audit(self, res, context=""):
        viol = validate_assignment(
            self.jax.snap, self.jax.config, res.assignment,
            commit_key=res.commit_key, evicted=res.evicted)
        assert not viol, (context, viol[:5])


def test_incremental_validity_sweep(inc_engine):
    """Churned cycles: audit tail and oracle clean every cycle; placed
    within a few percent of the cold solve over the sweep, and beside
    the JAX engine's incremental solve of its lineage."""
    eng = inc_engine
    rng = np.random.default_rng(41)
    nodes, pods, running = make_cluster(
        rng, 40, 10, as_records=True, spread_frac=0.3, interpod_frac=0.3,
        run_anti_frac=0.15, namespace_count=2)
    nodes, pods, running = list(nodes), list(pods), list(running)
    ln = Lineages(eng.config, nodes, pods, running)
    jeng = JEngine(JConfig(mode="fast"))
    try:
        eng.solve_warm(ln.port)
        jeng.solve_warm(ln.jax)
        placed_w = placed_c = placed_j = 0
        for cyc, delta in enumerate(warm_churn_stream(
                rng, nodes, pods, running, 10, churn_frac=0.15,
                structural_every=3)):
            ln.apply(**delta)
            res = eng.solve_warm(ln.port, incremental=True)
            jres = jeng.solve_warm(ln.jax, incremental=True)
            cold = eng.solve(ln.port.snap)
            assert res.inc_info is not None, "incremental path not taken"
            assert res.inc_info["audit_violations"] == 0, res.inc_info
            assert jres.inc_info["audit_violations"] == 0
            ln.audit(res, cyc)
            placed_w += int((res.assignment >= 0).sum())
            placed_c += int((cold.assignment >= 0).sum())
            placed_j += int((jres.assignment >= 0).sum())
    finally:
        jeng.close()
    assert ln.port.incremental_solves == 10, ln.port.warm_cold_reasons
    assert placed_w >= 0.95 * placed_c, (placed_w, placed_c)
    assert abs(placed_w - placed_j) <= 0.05 * placed_j, (placed_w, placed_j)


def test_incremental_carried_pods_skip_the_rounds(inc_engine):
    eng = inc_engine
    rng = np.random.default_rng(43)
    nodes, pods, running = make_cluster(rng, 40, 10, as_records=True)
    nodes, pods, running = list(nodes), list(pods), list(running)
    ln = Lineages(eng.config, nodes, pods, running)
    first = eng.solve_warm(ln.port)
    placed0 = int((first.assignment >= 0).sum())
    assert placed0 > 10
    for rec in pods[:3]:
        rec["observed_avail"] = 0.31
    ln.apply(upsert_pods=pods[:3])
    res = eng.solve_warm(ln.port, incremental=True)
    info = res.inc_info
    assert info is not None and info["audit_violations"] == 0
    assert info["frontier"] <= 3 + (len(pods) - placed0), info
    assert info["carried"] >= placed0 - 3, (info, placed0)
    ln.audit(res)


def test_incremental_spill_on_cordon(inc_engine):
    eng = inc_engine
    nodes = [dict(name=f"n{i}", allocatable={"cpu": 4000.0})
             for i in range(3)]
    pods = [dict(name=f"p{i}", requests={"cpu": 500.0},
                 priority=float(10 - i)) for i in range(6)]
    ln = Lineages(eng.config, nodes, pods, [])
    first = eng.solve_warm(ln.port)
    target = int(first.assignment[0])
    assert target >= 0
    crec = next(n for n in nodes
                if n["name"] == ln.port.meta.node_names[target])
    crec["unschedulable"] = True
    ln.apply(upsert_nodes=[crec])
    res = eng.solve_warm(ln.port, incremental=True)
    assert res.inc_info is not None
    assert res.inc_info["audit_violations"] == 0, res.inc_info
    assert not (res.assignment == target).any()
    assert (res.assignment[:6] >= 0).all()
    ln.audit(res)


def test_incremental_capacity_edge_carry(inc_engine):
    eng = inc_engine
    nodes = [dict(name="n0", allocatable={"cpu": 4000.0}),
             dict(name="n1", allocatable={"cpu": 4000.0})]
    pods = [dict(name=f"p{i}", requests={"cpu": 900.0},
                 priority=float(100 - i)) for i in range(8)]
    ln = Lineages(eng.config, nodes, pods, [])
    first = eng.solve_warm(ln.port)
    assert int((first.assignment >= 0).sum()) == 8
    nodes[0]["allocatable"] = {"cpu": 2000.0}
    ln.apply(upsert_nodes=[nodes[0]])
    res = eng.solve_warm(ln.port, incremental=True)
    assert res.inc_info is not None
    assert res.inc_info["cap_violations"] == 0, res.inc_info
    assert res.inc_info["audit_violations"] == 0, res.inc_info
    for n, name in enumerate(ln.port.meta.node_names):
        load = sum(900.0 for i in range(8) if int(res.assignment[i]) == n)
        assert load <= (2000.0 if name == "n0" else 4000.0) + 1e-6, name
    ln.audit(res)


def test_incremental_carry_dies_with_the_lineage(inc_engine):
    eng = inc_engine
    rng = np.random.default_rng(47)
    nodes, pods, running = make_cluster(rng, 20, 6, as_records=True)
    nodes, pods, running = list(nodes), list(pods), list(running)
    ds = DeviceSnapshot(eng.config, device="cpu")
    ds.full_load(nodes, pods, running)
    eng.solve_warm(ds)
    assert ds.carry_arrays() is not None
    ds.invalidate_warm("unit_unwind")
    assert ds.carry_arrays() is None
    inc0, cold0 = ds.incremental_solves, ds.cold_solves
    res = eng.solve_warm(ds, incremental=True)
    assert res.inc_info is None
    assert ds.cold_solves == cold0 + 1
    pods[0]["observed_avail"] = 0.4
    ds.apply(upsert_pods=[pods[0]])
    res2 = eng.solve_warm(ds, incremental=True)
    assert res2.inc_info is not None
    assert ds.incremental_solves == inc0 + 1


@pytest.mark.parametrize("preemption", [False, True])
def test_incremental_preemption_and_gangs_stay_valid(preemption):
    """Preemption rounds and the gang gate run unchanged on top of the
    seeded rounds: the audit and the oracle stay clean."""
    cfg = EngineConfig(mode="fast", preemption=preemption)
    eng = Engine(cfg, device="cpu")
    rng = np.random.default_rng(31)
    nodes, pods, running = make_cluster(
        rng, 36, 8, as_records=True, initial_utilization=0.8,
        n_running_per_node=3, pdb_frac=0.3, gang_frac=0.25, gang_size=2,
        tight_utilization=True, spread_frac=0.3, interpod_frac=0.3,
        run_anti_frac=0.15)
    nodes, pods, running = list(nodes), list(pods), list(running)
    ln = Lineages(cfg, nodes, pods, running)
    eng.solve_warm(ln.port)
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes, pods, running, 6, churn_frac=0.25,
            structural_every=3)):
        ln.apply(**delta)
        res = eng.solve_warm(ln.port, incremental=True)
        assert res.inc_info["audit_violations"] == 0, (cyc, res.inc_info)
        ln.audit(res, cyc)
        group = ln.port.snap.pods.group.numpy()
        gmin = ln.port.snap.group_min_member.numpy()
        placed = res.assignment >= 0
        cnt = np.bincount(group[placed & (group >= 0)],
                          minlength=gmin.shape[0])
        assert not ((cnt > 0) & (cnt < gmin)).any(), cyc
    assert ln.port.incremental_solves == 6
    eng.close()


def test_frontier_bucket_and_audit_layout():
    assert Engine._frontier_bucket(3, 10240) == 64
    assert Engine._frontier_bucket(100, 10240) == 256
    assert Engine._frontier_bucket(600, 1024) == 0
    assert tassign.INC_AUDIT_LEN == jassign.INC_AUDIT_LEN == 5


# -- K19 and K20's plain versions against the JAX expressions -------------


def _prefix_inputs(seed: int, P: int, N: int, exact: bool):
    rng = np.random.default_rng(seed)
    R = 3
    if exact:
        unit = float(1 << 20)
        alloc = rng.integers(8, 64, (N, R)).astype(np.float32) * unit
        used = np.floor(alloc * rng.uniform(0.0, 0.6, (N, R)) / unit) * unit
        req = rng.integers(0, 12, (P, R)).astype(np.float32) * unit
    else:
        # Config-5 magnitudes: memory in bytes of 16-128 GiB nodes at
        # 90 % use, cpu in millicores, the pods slot count.
        alloc = np.stack([rng.choice([4000.0, 8000.0, 16000.0, 32000.0], N),
                          rng.choice([16.0, 32.0, 64.0, 128.0], N)
                          * float(1 << 30),
                          np.full(N, 110.0)], axis=1)
        used = np.floor(alloc * rng.uniform(0.5, 0.9, (N, R)))
        req = np.stack([rng.integers(100, 4000, P).astype(float),
                        rng.integers(1 << 28, 8 << 30, P).astype(float),
                        np.ones(P)], axis=1)
    node = rng.integers(-1, N, P).astype(np.int32)
    rank = rng.permutation(P).astype(np.int32)
    active = (node >= 0) & (rng.random(P) < 0.9)
    return (alloc.astype(np.float32), used.astype(np.float32),
            req.astype(np.float32), node, rank, active)


def _port_keep(args):
    return tassign.capacity_prefix_keep_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k19_plain_equals_jax_on_exact_sums(seed):
    args = _prefix_inputs(seed, 400, 30, exact=True)
    want = np.asarray(jassign._capacity_prefix_keep(
        *(jnp.asarray(a) for a in args)))
    got = _port_keep(args)
    np.testing.assert_array_equal(got, want)
    assert got.any() and (args[5] & ~got).any()


@pytest.mark.parametrize("seed,P,N", [(0, 4000, 400), (1, 4000, 400),
                                      (0, 10240, 5120)])
def test_k19_plain_equals_an_f64_reference_at_config5_magnitudes(seed, P, N):
    """At config-5 magnitudes K19's per-node f32 sums decide as f64 sums
    do. (0, 10240, 5120) is a case where JAX's global cumsum less the
    segment offset does not (ROADMAP C7: `python
    tests/test_torch_incremental.py k19` prints them)."""
    args = _prefix_inputs(seed, P, N, exact=False)
    got = _port_keep(args)
    np.testing.assert_array_equal(got, _f64_keep(*args))
    active = args[5]
    assert got.sum() > P // 10 and (active & ~got).sum() > P // 10


def _jax_closure(invol, fr0, valid, carry, dirty_node, mask):
    """solve_incremental's closure and first pass, as the JAX package
    writes them (tpusched/kernels/assign.py, solve_incremental)."""
    P = fr0.shape[0]
    carry = jnp.where(valid, carry, -1)
    fr = fr0 & valid
    if invol is not None:
        hot = jnp.any(invol & fr[:, None], axis=0)
        fr = fr | jnp.any(invol & hot[None, :], axis=1)
    if dirty_node is not None:
        fr = fr | ((carry >= 0) & dirty_node[jnp.clip(carry, 0, None)])
    carried = valid & (carry >= 0) & ~fr
    frontier_n = jnp.sum((valid & (carry < 0) | fr).astype(jnp.float32))
    carried &= mask[jnp.arange(P), jnp.clip(carry, 0, None)]
    return fr, carried, frontier_n


@pytest.mark.parametrize("S,dirty", [(0, False), (0, True), (4, False),
                                     (32, True)])
def test_k20_plain_equals_the_jax_closure(S, dirty):
    rng = np.random.default_rng(S + dirty)
    P, N = 300, 40
    invol = (rng.random((P, S)) < 0.05) if S else None
    fr0 = rng.random(P) < 0.05
    valid = rng.random(P) < 0.9
    carry = rng.integers(-1, N, P).astype(np.int32)
    dnode = (rng.random(N) < 0.1) if dirty else None
    mask = rng.random((P, N)) < 0.8
    want = _jax_closure(*(None if a is None else jnp.asarray(a)
                          for a in (invol, fr0, valid, carry, dnode, mask)))
    t = [None if a is None else torch.from_numpy(a)
         for a in (invol, fr0, valid, carry, dnode, mask)]
    t[3] = torch.where(t[2], t[3], -1)   # the caller masks carry by valid
    fr, carried, count = tassign.frontier_closure_plain(*t)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(carried.numpy(), np.asarray(want[1]))
    assert float(count) == float(want[2])
    assert carried.any() and fr.any()


def _f64_keep(alloc, used, req, node, rank, active) -> np.ndarray:
    """The carried prefix with f64 sums within each node: the reference
    K19's f32 per-node sums are held to."""
    keep = np.zeros(node.shape[0], bool)
    for n in np.unique(node[active]):
        rows = np.nonzero(active & (node == n))[0]
        run = np.zeros(req.shape[1])
        for p in rows[np.argsort(rank[rows], kind="stable")]:
            run = run + req[p].astype(np.float64)
            if not (used[n].astype(np.float64) + run
                    <= alloc[n].astype(np.float64)).all():
                break
            keep[p] = True
    return keep


def k19_divergence(seeds, sizes=((4000, 400), (10240, 5120),
                                 (20000, 1000))) -> None:
    """Print, per (seed, P, N) of the config-5-magnitude inputs, the rows
    where K19's plain version and JAX's _capacity_prefix_keep part, the
    first one with both verdicts and the f64 reference's (ROADMAP C)."""
    for seed in seeds:
        for P, N in sizes:
            args = _prefix_inputs(seed, P, N, exact=False)
            got = _port_keep(args)
            want = np.asarray(jassign._capacity_prefix_keep(
                *(jnp.asarray(a) for a in args)))
            ref = _f64_keep(*args)
            d = np.nonzero(got != want)[0]
            first = (f"first row {d[0]}: port {bool(got[d[0]])}, JAX "
                     f"{bool(want[d[0]])}, f64 {bool(ref[d[0]])}"
                     if d.size else "")
            print(f"seed {seed} P={P} N={N}: {d.size} rows differ, port == "
                  f"f64 on all rows: {bool((got == ref).all())}, JAX == f64: "
                  f"{bool((want == ref).all())}; {first}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["k19"]:
        k19_divergence([int(s) for s in sys.argv[2:]] or range(6))
