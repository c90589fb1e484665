"""Parity-mode preemption with PodDisruptionBudgets: the port's
`Engine.solve(EngineConfig(preemption=True))` (on the CPU, where every
kernel wrapper runs its plain version) against the JAX package's parity
engine and its numpy oracle, on one snapshot built by the JAX builder
and carried across with `snapshot_from_numpy`; and the victim search's
functions one by one against the JAX package's.

Every parity case of tests/test_preempt.py and tests/test_pdb.py is
here, their fuzz seeds included. `assignment`, `order` and `evicted`
must be exact; `final_used` is held at rtol 1e-5 and `chosen_score` at
rtol 1e-4, atol 1e-3, the JAX package's own parity tolerances
(ROADMAP C1: XLA on the CPU may contract multiply-adds that the oracle
and the port round separately)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels import preempt as jpre
from tpusched.oracle import Oracle, validate_assignment
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import _sat_tables as tsat
from tpusched_torch.kernels import preempt as tpre
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_snapshot import assert_same_arrays


def solve_three(jsnap, **cfg_kw):
    """(port, JAX engine, oracle) results in parity mode with preemption
    on one JAX-built snapshot."""
    cfg_kw.setdefault("preemption", True)
    jcfg, tcfg = JConfig(**cfg_kw), EngineConfig(**cfg_kw)
    jeng = JEngine(jcfg)
    teng = Engine(tcfg, device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = teng.solve(snapshot_from_numpy(jax.device_get(jsnap)))
    finally:
        jeng.close()
        teng.close()
    return tres, jres, Oracle(jsnap, jcfg).solve()


def assert_preempt_parity(tres, jres, ores):
    for ref, who in ((jres, "JAX"), (ores, "oracle")):
        np.testing.assert_array_equal(tres.assignment, ref.assignment,
                                      err_msg=f"placements differ from {who}")
        np.testing.assert_array_equal(tres.evicted, ref.evicted,
                                      err_msg=f"evictions differ from {who}")
        n = len(ref.order)
        np.testing.assert_array_equal(tres.order[:n], ref.order)
        np.testing.assert_allclose(tres.final_used, ref.final_used,
                                   rtol=1e-5)
        both = np.isfinite(ref.chosen_score)
        np.testing.assert_array_equal(np.isfinite(tres.chosen_score), both)
        np.testing.assert_allclose(tres.chosen_score[both],
                                   ref.chosen_score[both], rtol=1e-4,
                                   atol=1e-3)
    np.testing.assert_array_equal(tres.commit_key, jres.commit_key)
    assert tres.rounds == jres.rounds


def _full_node(b, name, victims, cpu=4000):
    """Node filled to capacity by `victims` = [(prio, slack, cpu)]."""
    b.add_node(name, {"cpu": cpu, "memory": 64 << 30, "pods": 110})
    for prio, slack, vcpu in victims:
        b.add_running_pod(name, {"cpu": vcpu, "memory": 1 << 30},
                          priority=prio, slack=slack)


def _node(b, name, victims):
    """A 4000-cpu node with running pods [(cpu, prio, slack, kwargs)]."""
    b.add_node(name, {"cpu": 4000, "memory": 64 << 30})
    for cpu, prio, slack, kw in victims:
        b.add_running_pod(name, {"cpu": cpu, "memory": 1 << 30},
                          priority=prio, slack=slack, **kw)


def _db(allowed, **kw):
    return dict(pdb_group="db", pdb_disruptions_allowed=allowed, **kw)


# tests/test_preempt.py's and tests/test_pdb.py's hand-built clusters:
# (name, build(b), want) with want = (assignment[:k], evicted[:k'])
# where the JAX test pins them.
def hand_cheapest(b):
    _full_node(b, "n0", [(10, 0.05, 4000)])
    _full_node(b, "n1", [(10, 0.30, 4000)])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)


def hand_no_eligible(b):
    _full_node(b, "n0", [(1000, 0.3, 4000)])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=5)


def hand_minimal_prefix(b):
    _full_node(b, "n0", [(10, 0.3, 1000), (10, 0.2, 1000),
                         (10, 0.1, 1000), (10, 0.0, 1000)])
    b.add_pod("p", {"cpu": 1500, "memory": 1 << 30}, priority=500)


def hand_below_slo_meek(b):
    _full_node(b, "n0", [(10, -0.5, 4000)])
    b.add_pod("meek", {"cpu": 2000, "memory": 1 << 30}, priority=50)


def hand_below_slo_desperate(b):
    _full_node(b, "n0", [(10, -0.5, 4000)])
    b.add_pod("desperate", {"cpu": 2000, "memory": 1 << 30}, priority=50,
              slo_target=0.99, observed_avail=0.0)


def hand_taints(b):
    b.add_node("n0", {"cpu": 4000, "memory": 64 << 30},
               taints=[("dedicated", "batch", "NoSchedule")])
    b.add_running_pod("n0", {"cpu": 4000, "memory": 1 << 30},
                      priority=1, slack=0.5)
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)


def hand_later_pod_sees_eviction(b):
    _full_node(b, "n0", [(10, 0.3, 3000), (10, 0.0, 1000)])
    b.add_pod("a", {"cpu": 2500, "memory": 1 << 30}, priority=500)
    b.add_pod("b", {"cpu": 400, "memory": 1 << 30}, priority=100)


def hand_gang_members_do_not_preempt(b):
    _full_node(b, "n0", [(1, 0.5, 4000)])
    for i in range(2):
        b.add_pod(f"g-{i}", {"cpu": 1500, "memory": 1 << 30}, priority=500,
                  pod_group="g", pod_group_min_member=2)


def hand_pdb_protected_avoided(b):
    _node(b, "n0", [(4000, 10, 0.3, _db(0))])
    _node(b, "n1", [(4000, 10, 0.05, {})])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)


def hand_pdb_last_resort(b):
    _node(b, "n0", [(4000, 10, 0.3, _db(0))])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)


def hand_pdb_limited_evictions(b):
    _node(b, "n0", [(2000, 10, 0.3, _db(1))] * 2)
    _node(b, "n1", [(2000, 10, 0.05, {})] * 2)
    b.add_pod("p", {"cpu": 3000, "memory": 1 << 30}, priority=500)


def hand_pdb_shared_across_preemptors(b):
    _node(b, "n0", [(4000, 10, 0.4, _db(1))])
    _node(b, "n1", [(4000, 10, 0.35, _db(1))])
    _node(b, "n2", [(4000, 10, 0.05, {})])
    b.add_pod("p1", {"cpu": 4000, "memory": 1 << 30}, priority=500)
    b.add_pod("p2", {"cpu": 4000, "memory": 1 << 30}, priority=400)


def hand_pdb_namespaces(b):
    _node(b, "n0", [(4000, 10, 0.3, _db(0, namespace="a"))])
    _node(b, "n1", [(4000, 10, 0.05, _db(2, namespace="b"))])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)


HAND = {
    "cheapest_victim": (hand_cheapest, [1], [False, True]),
    "no_eligible_victims": (hand_no_eligible, [-1], [False]),
    "minimal_victim_prefix": (hand_minimal_prefix, [0],
                              [True, True, False, False]),
    "below_slo_meek": (hand_below_slo_meek, [-1], [False]),
    "below_slo_desperate": (hand_below_slo_desperate, [0], [True]),
    "respects_taints": (hand_taints, [-1], [False]),
    "later_pod_sees_eviction": (hand_later_pod_sees_eviction, [0, 0],
                                [True, False]),
    "gang_members_do_not_preempt": (hand_gang_members_do_not_preempt,
                                    [-1, -1], [False]),
    "pdb_protected_avoided": (hand_pdb_protected_avoided, [1],
                              [False, True]),
    "pdb_last_resort": (hand_pdb_last_resort, [0], [True]),
    "pdb_limited_evictions": (hand_pdb_limited_evictions, [1],
                              [False, False, True, True]),
    "pdb_shared_across_preemptors": (hand_pdb_shared_across_preemptors,
                                     [0, 2], [True, False, True]),
    "pdb_namespaces": (hand_pdb_namespaces, [1], [False, True]),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_preempt_hand_cases(case):
    build, want_a, want_ev = HAND[case]
    b = JBuilder(JConfig(preemption=True))
    build(b)
    jsnap, _ = b.build()
    tres, jres, ores = solve_three(jsnap)
    assert_preempt_parity(tres, jres, ores)
    assert tres.assignment[:len(want_a)].tolist() == want_a
    assert tres.evicted[:len(want_ev)].tolist() == want_ev


def test_preemption_off_by_default():
    b = JBuilder(JConfig())
    _full_node(b, "n0", [(1, 0.5, 4000)])
    b.add_pod("p", {"cpu": 2000, "memory": 1 << 30}, priority=500)
    jsnap, _ = b.build()
    tres, jres, ores = solve_three(jsnap, preemption=False)
    assert_preempt_parity(tres, jres, ores)
    assert tres.assignment[0] == -1 and not tres.evicted.any()


def test_eviction_names_for_unsorted_wire_order():
    """tests/test_pdb.py's codec case: the JAX codec builds the arrays
    in name order; the port evicts the same running pod."""
    from tpusched.rpc.codec import snapshot_from_proto, snapshot_to_proto

    mem = float(64 << 30)
    nodes = [dict(name="n0", allocatable={"cpu": 4000.0, "memory": mem}),
             dict(name="n1", allocatable={"cpu": 4000.0, "memory": mem})]
    running = [
        dict(name="z-victim", node="n1",
             requests={"cpu": 4000.0, "memory": float(1 << 30)},
             priority=10, slack=0.5),
        dict(name="a-protected", node="n0",
             requests={"cpu": 4000.0, "memory": float(1 << 30)},
             priority=10, slack=0.0),
    ]
    pods = [dict(name="p", requests={"cpu": 2000.0,
                                     "memory": float(1 << 30)},
                 priority=500.0, observed_avail=1.0)]
    jsnap, meta = snapshot_from_proto(
        snapshot_to_proto(nodes, pods, running), JConfig(preemption=True))
    tres, jres, ores = solve_three(jsnap)
    assert_preempt_parity(tres, jres, ores)
    names = [meta.running_names[m] for m in np.nonzero(tres.evicted)[0]]
    assert names == ["z-victim"]


@pytest.mark.parametrize("seed", range(6))
def test_preemption_parity_fuzz(seed):
    """tests/test_preempt.py:137's clusters (spread and inter-pod terms
    included, so K4's pairwise preemption path runs)."""
    rng = np.random.default_rng(11000 + seed)
    jsnap, _ = jsynth.make_cluster(
        rng,
        n_pods=int(rng.integers(10, 40)),
        n_nodes=int(rng.integers(3, 10)),
        initial_utilization=0.9,
        n_running_per_node=int(rng.integers(2, 6)),
        interpod_frac=float(rng.uniform(0, 0.3)),
        spread_frac=float(rng.uniform(0, 0.3)),
    )
    assert_preempt_parity(*solve_three(jsnap))


@pytest.mark.parametrize("seed", range(4))
def test_parity_fuzz_with_pdbs(seed):
    """tests/test_pdb.py:201's near-full clusters with budgets."""
    jsnap, _ = jsynth.make_cluster(
        np.random.default_rng(4200 + seed), 30, 8, initial_utilization=0.9,
        n_running_per_node=6, pdb_frac=0.5)
    tres, jres, ores = solve_three(jsnap)
    assert_preempt_parity(tres, jres, ores)


@pytest.mark.parametrize("seed", range(3))
def test_config5_preemption_small(seed):
    """BASELINE config 5 at a small size, built by the port's generator
    (identical arrays to the JAX generator's): the port evicts what JAX
    and the oracle evict."""
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(45 + seed),
                                         48, 12)
    tsnap, _ = tsynth.config5_preemption(np.random.default_rng(45 + seed),
                                         48, 12)
    assert_same_arrays(jsnap, tsnap)
    tres, jres, ores = solve_three(jsnap)
    assert_preempt_parity(tres, jres, ores)
    assert tres.evicted.any()


# -- the victim search, function by function --------------------------------


def _jax_and_port(seed, n_pods=30, n_nodes=8, **kw):
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed),
                                         n_pods, n_nodes, **kw)
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap))


@pytest.mark.parametrize("seed", range(4))
def test_precompute_equals_jax(seed):
    """Every field of the victim table bitwise (dtype, shape, values)."""
    jsnap, tsnap = _jax_and_port(
        seed, namespace_count=2 if seed % 2 else 1)
    jctx = jpre.precompute(JConfig(), jsnap)
    tctx = tpre.precompute(EngineConfig(), tsnap)
    for f in ("perm", "node_s", "seg_start", "cost_s", "vprio_s", "req_s",
              "pdb_s"):
        want = np.asarray(getattr(jctx, f))
        got = getattr(tctx, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _random_state(r, jsnap, M, N):
    evicted = r.random(M) < 0.2
    scale = r.uniform(0.8, 1.05, size=(N, 1)).astype(np.float32)
    used = (np.asarray(jsnap.nodes.used) * scale).astype(np.float32)
    allowed = r.random(N) < 0.8
    return evicted, used, allowed


@pytest.mark.parametrize("seed", range(4))
def test_preempt_step_plain_equals_jax(seed):
    """preempt_step_plain against JAX preempt_step on random states
    (earlier evictions, usage, allowed rows, priorities): best_n, can and
    the eviction mask exact, the freed row within 1 ulp."""
    jsnap, tsnap = _jax_and_port(100 + seed, pdb_frac=0.5)
    jcfg, tcfg = JConfig(), EngineConfig()
    jctx = jpre.precompute(jcfg, jsnap)
    tctx = tpre.precompute(tcfg, tsnap)
    M = tctx.perm.shape[0]
    N = tsnap.nodes.valid.shape[0]
    r = np.random.default_rng(seed)
    reqs = np.asarray(jsnap.pods.requests)
    cans = 0
    for trial in range(12):
        ev, used, allowed = _random_state(r, jsnap, M, N)
        prio = np.float32(r.uniform(0, 400))
        req = reqs[trial]
        jb, jc, jm, jf = (np.asarray(x) for x in jpre.preempt_step(
            jcfg, jsnap, jctx, jnp.float32(prio), jnp.asarray(req),
            jnp.asarray(allowed), jnp.asarray(used), jnp.asarray(ev)))
        tb, tc, tm, tf = tpre.preempt_step(
            tcfg, tsnap, tctx, torch.tensor(prio), torch.from_numpy(req),
            torch.from_numpy(allowed), torch.from_numpy(used),
            torch.from_numpy(ev))
        assert int(tb) == int(jb) and bool(tc) == bool(jc)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_max_ulp(tf.numpy(), jf[int(jb)], maxulp=1)
        cans += bool(tc)
    assert cans > 0


def _edge_victims(case):
    """A JAX snapshot for the search's edge cases: `spilled`, nodes with
    more victims than K15's [V, N] planes hold (their tails read in the
    sorted order); `many_budgets`, 20 budgets over nodes of 24 victims
    (more than K15 counts in registers on a node); `no_allowed_node`,
    the spilled cluster with no node allowed to the pod."""
    b = JBuilder(JConfig(preemption=True))
    per = tpre.PLANE_CAP + 9 if case != "many_budgets" else 24
    for n in range(5):
        b.add_node(f"n{n}", {"cpu": 100 * per, "memory": 64 << 30,
                             "pods": 200})
        for j in range(per):
            g = (n + j) % (20 if case == "many_budgets" else 3)
            b.add_running_pod(
                f"n{n}", {"cpu": 100, "memory": 1 << 20},
                priority=(j * 7) % 11, slack=(j % 5) / 20.0,
                pdb_group=f"g{g}" if j % 4 != 1 else None,
                pdb_disruptions_allowed=(n + j) % 3)
    b.add_pod("p", {"cpu": 100.0 * (per - 3), "memory": 1 << 22},
              priority=500)
    return b.build()[0]


@pytest.mark.parametrize("case", ["spilled", "many_budgets",
                                  "no_allowed_node"])
def test_preempt_step_plain_edge_cases(case):
    """The plain search against JAX preempt_step and against the exact
    pick (test_torch_c5.exact_pick: the sums and the fit in f64) on
    segments past K15's planes, more budgets than it counts in
    registers, and a pod allowed on no node: best_n, can and the
    eviction mask exact, the freed row within 1 ulp of JAX's."""
    from test_torch_c5 import exact_pick

    jsnap = _edge_victims(case)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jcfg, tcfg = JConfig(preemption=True), EngineConfig(preemption=True)
    jctx = jpre.precompute(jcfg, jsnap)
    tctx = tpre.precompute(tcfg, tsnap)
    assert int((tctx.off[1:] - tctx.off[:-1]).max()) > tctx.pl_vic.shape[0]
    if case == "many_budgets":
        assert tsnap.pdb_allowed.shape[0] > 16
    M = tctx.perm.shape[0]
    N = tsnap.nodes.valid.shape[0]
    r = np.random.default_rng(len(case))
    req = np.asarray(jsnap.pods.requests)[0]
    cans = 0
    for trial in range(8):
        ev, used, allowed = _random_state(r, jsnap, M, N)
        ev &= r.random(M) < 0.3 * (trial % 3)
        if case == "no_allowed_node":
            allowed[:] = False
        prio = np.float32(500.0)
        jb, jc, jm, jf = (np.asarray(x) for x in jpre.preempt_step(
            jcfg, jsnap, jctx, jnp.float32(prio), jnp.asarray(req),
            jnp.asarray(allowed), jnp.asarray(used), jnp.asarray(ev)))
        state = (tcfg, tsnap, tctx, torch.tensor(prio),
                 torch.from_numpy(req), torch.from_numpy(allowed),
                 torch.from_numpy(used), torch.from_numpy(ev))
        tb, tc, tm, tf = tpre.preempt_step(*state)
        assert int(tb) == int(jb) and bool(tc) == bool(jc)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_max_ulp(tf.numpy(), jf[int(jb)], maxulp=1)
        assert (int(tb) if bool(tc) else -1) == exact_pick(tsnap, tctx,
                                                           state)
        cans += bool(tc)
    assert cans == 0 if case == "no_allowed_node" else cans > 0


def test_pair_state_evict_equals_jax():
    """pair_state_evict on a snapshot with signatures and running
    required-anti holders against JAX's, bitwise."""
    from tpusched.engine import _sat_tables as jsat
    from tpusched.kernels import assign as jassign
    from tpusched.kernels import pairwise as jpair
    from tpusched_torch.engine import _sat_tables as tsat
    from tpusched_torch.kernels import assign as tassign
    from tpusched_torch.kernels import pairwise as tpair

    jsnap, _ = jsynth.make_cluster(
        np.random.default_rng(5), 24, 8, spread_frac=0.5, interpod_frac=0.5,
        run_anti_frac=0.4, n_running_per_node=4)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jcfg, tcfg = JConfig(), EngineConfig()
    jstatic = jassign.precompute_static(jcfg, jsnap, *jsat(jsnap))
    tstatic = tassign.precompute_static(tcfg, tsnap, *tsat(tsnap))
    jst = jpair.pair_state_init(jsnap, jstatic.sig_match)
    dom = tpair.sig_domains(tsnap)
    tst = tpair.pair_counts(tstatic.sig_match, dom, tsnap.running,
                            tsnap.pods)
    M = tsnap.running.valid.shape[0]
    ev = np.random.default_rng(1).random(M) < 0.4
    ev &= np.asarray(jsnap.running.valid)
    jout = jpair.pair_state_evict(jsnap, jst, jstatic.sig_match,
                                  jnp.asarray(ev))
    tout = tpair.pair_state_evict(tsnap, tst, tstatic.sig_match, dom,
                                  torch.from_numpy(ev))
    for f in ("counts", "anti", "match_tot"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)))
    assert float(tst.anti.sum()) > float(tout.anti.sum())


def test_fast_preemption_runs():
    """The fast auction is ported: the engine and a direct solve_rounds
    call both run fast mode with preemption and return a valid result."""
    from tpusched_torch.kernels import assign as tassign

    cfg = EngineConfig(mode="fast", preemption=True)
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(0), 8, 4)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    res = Engine(cfg, device="cpu").solve(tsnap)
    assert validate_assignment(jsnap, JConfig(mode="fast", preemption=True),
                               res.assignment, commit_key=res.commit_key,
                               evicted=res.evicted) == []
    assert (res.assignment >= 0).any()
    out = tassign.solve_rounds(cfg, tsnap, *tsat(tsnap))
    np.testing.assert_array_equal(out[0].numpy(), res.assignment)
    np.testing.assert_array_equal(out[6].numpy(), res.evicted)
