"""Gangs (pod groups, all-or-nothing at min_member) in both modes: the
port's `Engine.solve` on the CPU (every kernel wrapper runs its plain
version) against the JAX package's engine and, in parity mode, its
numpy oracle, on one snapshot built by the JAX builder and carried
across with `snapshot_from_numpy`; the gang gate against JAX's
`gang_rollback`; the builder's and the generator's gang fields against
the JAX ones.

Every case of tests/test_gangs.py is here in both modes, the fuzz seeds
included. Parity: `assignment`, `order` exact, `final_used` at rtol
1e-5, `chosen_score` at C1's rtol 1e-4, atol 1e-3. Fast: the fast
contract (validity under the commit key, no partial group, placed count
at least JAX fast's less 2, identity where the JAX tests pin it)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched.kernels import pairwise as jpair
from tpusched.oracle import Oracle, validate_assignment
from tpusched.snapshot import MatchExpression, PodAffinityTerm
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig
from tpusched_torch import snapshot as tsnapshot
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import pairwise as tpair
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_snapshot import assert_same_arrays

ZONE = "topology.kubernetes.io/zone"


def solve_both(jsnap, mode, **cfg_kw):
    """(port result, JAX engine result) in `mode` on one JAX snapshot."""
    jcfg = JConfig(mode=mode, **cfg_kw)
    tcfg = EngineConfig(mode=mode, **cfg_kw)
    jeng = JEngine(jcfg)
    teng = Engine(tcfg, device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = teng.solve(snapshot_from_numpy(jax.device_get(jsnap)))
    finally:
        jeng.close()
        teng.close()
    return tres, jres


def no_partial_group(jsnap, assignment):
    group = np.asarray(jsnap.pods.group)
    gmin = np.asarray(jsnap.group_min_member)
    for g in range(gmin.shape[0]):
        placed = int(((group == g) & (assignment >= 0)).sum())
        assert placed == 0 or placed >= gmin[g], (g, placed, gmin[g])


def check_mode(jsnap, mode, **cfg_kw):
    """The slice's contract in `mode`; returns the port's result."""
    tres, jres = solve_both(jsnap, mode, **cfg_kw)
    no_partial_group(jsnap, tres.assignment)
    if mode == "parity":
        ores = Oracle(jsnap, JConfig(**cfg_kw)).solve()
        for ref in (jres, ores):
            np.testing.assert_array_equal(tres.assignment, ref.assignment)
            n = len(ref.order)
            np.testing.assert_array_equal(tres.order[:n], ref.order)
            np.testing.assert_allclose(tres.final_used, ref.final_used,
                                       rtol=1e-5)
            both = np.isfinite(ref.chosen_score)
            np.testing.assert_array_equal(np.isfinite(tres.chosen_score),
                                          both)
            np.testing.assert_allclose(tres.chosen_score[both],
                                       ref.chosen_score[both], rtol=1e-4,
                                       atol=1e-3)
    else:
        cfg = JConfig(mode="fast", **cfg_kw)
        assert validate_assignment(jsnap, cfg, tres.assignment,
                                   commit_key=tres.commit_key) == []
        placed = int((tres.assignment >= 0).sum())
        assert placed >= int((jres.assignment >= 0).sum()) - 2
        rolled = (tres.assignment < 0) & (np.asarray(jsnap.pods.group) >= 0)
        assert (tres.commit_key[rolled] == -1).all()
    assert not tres.evicted.any()
    return tres, jres


def _gang(b, name, n, min_member, cpu=1000, **kw):
    for i in range(n):
        b.add_pod(f"{name}-{i}", {"cpu": cpu, "memory": 1 << 30},
                  pod_group=name, pod_group_min_member=min_member, **kw)


def hand_quorum_met(b):
    for i in range(4):
        b.add_node(f"n{i}", {"cpu": 4000, "memory": 16 << 30})
    _gang(b, "g", 4, 4)


def hand_no_quorum(b):
    b.add_node("n0", {"cpu": 2000, "memory": 16 << 30})
    _gang(b, "g", 4, 4)


def hand_floor_not_cap(b):
    b.add_node("n0", {"cpu": 3000, "memory": 16 << 30})
    _gang(b, "g", 4, 2)


def hand_frees_nothing_for_same_batch(b):
    b.add_node("n0", {"cpu": 2000, "memory": 16 << 30})
    _gang(b, "g", 4, 4, priority=100)
    b.add_pod("solo", {"cpu": 1500, "memory": 1 << 30}, priority=1)


def hand_pairwise_rolls_back(b):
    for i in range(2):
        b.add_node(f"n{i}", {"cpu": 2000, "memory": 16 << 30},
                   labels={ZONE: "ab"[i]})
    _gang(b, "g", 4, 4, priority=100, labels={"app": "g"},
          pod_affinity=[PodAffinityTerm(
              ZONE, (MatchExpression("app", "In", ("g",)),), anti=True,
              required=True)])


def hand_audit_caveat(b):
    b.add_node("n0", {"cpu": 4000, "memory": 16 << 30}, labels={ZONE: "a"})
    b.add_node("n1", {"cpu": 4000, "memory": 16 << 30}, labels={ZONE: "b"})
    b.add_pod("g-big", {"cpu": 99999, "memory": 1 << 30}, priority=300,
              labels={"app": "web"}, pod_group="gang",
              pod_group_min_member=2)
    b.add_pod("g-ok", {"cpu": 100, "memory": 1 << 30}, priority=200,
              labels={"app": "web"}, pod_group="gang",
              pod_group_min_member=2)
    b.add_pod("dep", {"cpu": 100, "memory": 1 << 30}, priority=100,
              labels={"app": "api"},
              pod_affinity=[PodAffinityTerm(
                  ZONE, (MatchExpression("app", "In", ("web",)),),
                  required=True)])


def _placed(k):
    return lambda a: (a[:k] >= 0).all()


def _none(k):
    return lambda a: (a[:k] == -1).all()


# (build, what tests/test_gangs.py pins on the assignment, whether the
# final usage must equal the initial one)
HAND = {
    "quorum_met_places_all": (hand_quorum_met, _placed(4), False),
    "no_quorum_places_none": (hand_no_quorum, _none(4), True),
    "min_member_is_floor_not_cap": (
        hand_floor_not_cap, lambda a: (a[:4] >= 0).sum() == 3, False),
    "rollback_frees_nothing_for_same_batch": (
        hand_frees_nothing_for_same_batch, _none(5), True),
    "with_pairwise_rolls_back_counts": (hand_pairwise_rolls_back, _none(4),
                                        True),
    "rollback_audit_caveat": (
        hand_audit_caveat, lambda a: a[0] == -1 and a[1] == -1 and a[2] >= 0,
        False),
}


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("case", sorted(HAND))
def test_gang_hand_cases(case, mode):
    build, pinned, restored = HAND[case]
    b = JBuilder(JConfig(mode=mode))
    build(b)
    jsnap, _ = b.build()
    tres, jres = check_mode(jsnap, mode)
    assert pinned(tres.assignment), tres.assignment
    # Where the JAX tests pin the assignment, the port and JAX agree.
    np.testing.assert_array_equal(tres.assignment, jres.assignment)
    if restored:
        np.testing.assert_array_equal(tres.final_used,
                                      np.asarray(jsnap.nodes.used))


@pytest.mark.parametrize("seed", range(4))
def test_gang_parity_fuzz(seed):
    """tests/test_gangs.py:83's clusters."""
    rng = np.random.default_rng(9000 + seed)
    jsnap, _ = jsynth.make_cluster(
        rng, n_pods=int(rng.integers(16, 48)),
        n_nodes=int(rng.integers(3, 10)), gang_frac=0.7,
        gang_size=int(rng.integers(2, 6)))
    check_mode(jsnap, "parity")


@pytest.mark.parametrize("seed", range(4))
def test_gang_fast_no_partial_groups(seed):
    """tests/test_gangs.py:100's clusters, in fast mode."""
    rng = np.random.default_rng(9500 + seed)
    jsnap, _ = jsynth.make_cluster(
        rng, n_pods=int(rng.integers(16, 64)),
        n_nodes=int(rng.integers(3, 10)), gang_frac=0.8, gang_size=4,
        initial_utilization=0.6)
    check_mode(jsnap, "fast")


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("seed", range(2))
def test_config4_gangs_small(seed, mode):
    """BASELINE config 4 at a small size, built by the port's generator
    (identical arrays to the JAX generator's), with demand near free
    capacity so that groups roll back."""
    kw = dict(n_groups=16, gang_size=4, n_nodes=8)
    jsnap, jmeta = jsynth.config4_gangs(np.random.default_rng(44 + seed),
                                        **kw)
    tsnap, tmeta = tsynth.config4_gangs(np.random.default_rng(44 + seed),
                                        **kw)
    assert_same_arrays(jsnap, tsnap)
    assert tmeta.group_names == jmeta.group_names
    tres, _ = check_mode(jsnap, mode)
    assert (tres.assignment >= 0).any()


@pytest.mark.parametrize("seed", range(2))
def test_gang_rollback_equals_jax_with_pairwise(seed):
    """The gang gate alone with S > 0, on the same post-scan state: used
    within an ulp (JAX's duplicate-index scatter-add leaves its order
    open; the port unwinds in ascending pod index, the oracle's order),
    assignment, chosen and the rolled mask exact, and the reverted pair
    state equal to K10's recount of the surviving assignment."""
    rng = np.random.default_rng(700 + seed)
    jsnap, _ = jsynth.make_cluster(rng, 32, 6, gang_frac=0.7, gang_size=3,
                                   spread_frac=0.5, interpod_frac=0.5,
                                   initial_utilization=0.6)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jcfg, tcfg = JConfig(), EngineConfig()
    jstatic = jassign.precompute_static(jcfg, jsnap, *jax_sat_tables(jsnap))
    tstatic = tassign.precompute_static(tcfg, tsnap, *_sat_tables(tsnap))
    dom = tpair.sig_domains(tsnap)
    st0 = tpair.pair_counts(tstatic.sig_match, dom, tsnap.running,
                            tsnap.pods)
    order = tassign.pop_order(tcfg, tsnap)
    assigned, chosen, used, st = tassign.parity_scan_pair_plain(
        tcfg, tsnap, tstatic, order, st0, dom)
    jst = jpair.PairState(counts=jnp.asarray(st.counts.numpy()),
                          anti=jnp.asarray(st.anti.numpy()),
                          match_tot=jnp.asarray(st.match_tot.numpy()))
    ju, ja, jc, _, jroll = jassign.gang_rollback(
        jsnap, jnp.asarray(used.numpy()), jnp.asarray(assigned.numpy()),
        jnp.asarray(chosen.numpy()), jst, jstatic.sig_match)
    tu, ta, tc, tst, troll = tassign.gang_rollback(
        tsnap, used, assigned, chosen, st, tstatic.sig_match, dom)
    assert troll.any()
    np.testing.assert_array_equal(troll.numpy(), np.asarray(jroll))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(tu.numpy(), np.asarray(ju), maxulp=1)
    rec = tpair.pair_counts(tstatic.sig_match, dom, tsnap.running,
                            tsnap.pods, assigned=ta)
    for f in ("counts", "anti", "match_tot"):
        assert torch.equal(getattr(tst, f), getattr(rec, f)), f


def test_builder_gang_fields_equal_jax():
    """Gang names intern in sorted order, min_member is the largest given
    for the group, and the G axis grows to the groups seen."""
    jb = JBuilder(JConfig())
    tb = tsnapshot.SnapshotBuilder(EngineConfig())
    for b in (jb, tb):
        b.add_node("n0", {"cpu": 4000, "memory": 16 << 30})
        for i, (g, k) in enumerate([("zeta", 2), ("alpha", 3), ("zeta", 4),
                                    (None, 0), ("mid", 1)]):
            b.add_pod(f"p{i}", {"cpu": 100}, pod_group=g,
                      pod_group_min_member=k)
    (jsnap, jmeta), (tsnap, tmeta) = jb.build(), tb.build()
    assert_same_arrays(jsnap, tsnap)
    assert tmeta.group_names == jmeta.group_names == ["alpha", "mid", "zeta"]
    assert tsnap.group_min_member[:3].tolist() == [3, 1, 4]


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_score_ignores_groups(mode):
    """ScoreBatch on a config-4 snapshot: the gang axis changes nothing
    (JAX score_batch ignores it); feasibility equal to JAX's, scores
    within C1's tolerance, and equal to the same snapshot without its
    groups."""
    jsnap, _ = jsynth.config4_gangs(np.random.default_rng(3), n_groups=6,
                                    gang_size=4, n_nodes=6)
    jeng = JEngine(JConfig(mode=mode))
    try:
        want = jeng.score(jsnap)
    finally:
        jeng.close()
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    teng = Engine(EngineConfig(mode=mode), device="cpu")
    got = teng.score(tsnap)
    bare = teng.score(tsnapshot.ClusterSnapshot(**{
        **vars(tsnap), "group_min_member": tsnap.group_min_member[:0]}))
    teng.close()
    np.testing.assert_array_equal(got.feasible, np.asarray(want.feasible))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.feasible, bare.feasible)
    np.testing.assert_array_equal(got.scores, bare.scores)
