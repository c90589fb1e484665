"""The pairwise slice of the port (topology spread, inter-pod affinity and
anti-affinity, symmetric anti-affinity, namespace scopes, key-less nodes)
against the JAX package, on the CPU, where every kernel wrapper runs its
plain version.

Tolerances:
  * builder and generator arrays: identical, leaf by leaf;
  * K9 (sig_match), K10 (pair_counts), K11 (pairwise_batch) plain
    versions, pairwise_row, symmetric_anti_block and pair_state_add_pod:
    bitwise equal to the JAX functions (bool and int outputs, and f32
    values that are integer counts, weight sums and the normalisers'
    product-then-divide);
  * parity solves: assignment and order exactly equal to the JAX parity
    engine's and the oracle's; final_used rtol 1e-5 and chosen_score
    rtol 1e-4 / atol 1e-3, the JAX package's own parity tolerances
    (tests/test_parity.py; XLA on the CPU contracts multiply-adds,
    ROADMAP C1);
  * ScoreBatch: feasibility bitwise equal to the JAX engine's and the
    oracle's, scores bitwise equal to the oracle's.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import snapshot as jsnapshot
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched.kernels import pairwise as jpair
from tpusched.kernels import score as jscore
from tpusched.oracle import Oracle, validate_assignment
from tpusched_torch import Engine, EngineConfig
from tpusched_torch import snapshot as tsnapshot
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_snapshot import assert_same_arrays

ZONE = "topology.kubernetes.io/zone"
JAXM = types.SimpleNamespace(mod=jsnapshot, cfg=JConfig, synth=jsynth)
PORT = types.SimpleNamespace(mod=tsnapshot, cfg=EngineConfig, synth=tsynth)

# -- snapshots, built by either package from the same records or seed ---------


def _nodes(m, b, n=4, zones=("a", "b")):
    for i in range(n):
        b.add_node(f"n{i}", {"cpu": 4000, "memory": 16 << 30},
                   labels={ZONE: zones[i % len(zones)]})


def _web(m):
    return (m.mod.MatchExpression("app", "In", ("web",)),)


def _term(m, sel, **kw):
    return m.mod.PodAffinityTerm(ZONE, sel, **kw)


def _spread(m, skew=1):
    return m.mod.TopologySpreadConstraint(
        ZONE, max_skew=skew, when_unsatisfiable="DoNotSchedule",
        selector=_web(m))


R1 = {"cpu": 100, "memory": 1 << 28}


def hand_running_anti(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b)
    b.add_running_pod("n0", R1, labels={"app": "db"}, pod_affinity=[
        _term(m, _web(m), anti=True, required=True)])
    b.add_pod("w", R1, labels={"app": "web"})
    b.add_pod("x", R1, labels={"app": "cache"})
    return b.build()


def hand_pending_anti_holder(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b)
    b.add_pod("holder", R1, priority=100, labels={"app": "db"},
              pod_affinity=[_term(m, _web(m), anti=True, required=True)])
    b.add_pod("web1", R1, priority=1, labels={"app": "web"})
    return b.build()


def hand_keyless_holder(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    b.add_node("keyless", {"cpu": 4000, "memory": 16 << 30})
    b.add_node("n1", {"cpu": 4000, "memory": 16 << 30}, labels={ZONE: "a"})
    b.add_running_pod("keyless", R1, pod_affinity=[
        _term(m, _web(m), anti=True, required=True)])
    b.add_pod("w", R1, labels={"app": "web"})
    return b.build()


def hand_empty_selector_anti(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b)
    b.add_running_pod("n0", R1, pod_affinity=[
        _term(m, (), anti=True, required=True)])
    b.add_pod("p", R1, labels={"app": "anything"})
    return b.build()


def hand_run_anti_two_atoms(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b)
    b.add_running_pod("n0", R1, pod_affinity=[_term(
        m, (m.mod.MatchExpression("app", "In", ("web",)),
            m.mod.MatchExpression("tier", "In", ("1",))),
        anti=True, required=True)])
    b.add_pod("w", R1, labels={"app": "web", "tier": "1"})
    b.add_pod("c", R1, labels={"app": "cache"})
    return b.build()


def hand_keyless_member_all_zero(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    b.add_node("keyless", {"cpu": 4000, "memory": 16 << 30})
    b.add_node("n1", {"cpu": 4000, "memory": 16 << 30}, labels={ZONE: "a"})
    b.add_running_pod("keyless", R1, labels={"app": "db"})
    b.add_pod("w", R1, labels={"app": "web"}, pod_affinity=[_term(
        m, (m.mod.MatchExpression("app", "In", ("db",)),), required=True)])
    return b.build()


def hand_self_match_special_case(m):
    """No member matches the required selector anywhere, but the pod
    matches its own: any node with the key will do."""
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b)
    b.add_node("keyless", {"cpu": 4000, "memory": 16 << 30})
    b.add_pod("w", R1, labels={"app": "web"},
              pod_affinity=[_term(m, _web(m), required=True)])
    b.add_pod("w2", R1, labels={"app": "web"},
              pod_affinity=[_term(m, _web(m), required=True)])
    return b.build()


def _ns_case(term_kw, run_ns, anti=False, pods_ns=("mine",)):
    def build(m):
        b = m.mod.SnapshotBuilder(m.cfg())
        _nodes(m, b)
        b.add_running_pod("n0", R1, labels={"app": "web"}, namespace=run_ns)
        for i, ns in enumerate(pods_ns):
            b.add_pod(f"api{i}", R1, labels={"app": "api"}, namespace=ns,
                      pod_affinity=[_term(m, _web(m), anti=anti,
                                          required=True, **term_kw)])
        return b.build()
    return build


def hand_spread_ns(same: bool):
    def build(m):
        b = m.mod.SnapshotBuilder(m.cfg())
        b.add_node("big-a", {"cpu": 16000, "memory": 64 << 30},
                   labels={ZONE: "a"})
        b.add_node("small-b", {"cpu": 4000, "memory": 16 << 30},
                   labels={ZONE: "b"})
        for _ in range(2):
            b.add_running_pod("big-a", R1, labels={"app": "web"},
                              namespace="mine" if same else "other")
        b.add_pod("w", R1, labels={"app": "web"}, namespace="mine",
                  topology_spread=[_spread(m)])
        return b.build()
    return build


def hand_holder_scope(m):
    b = m.mod.SnapshotBuilder(m.cfg())
    b.add_node("n0", {"cpu": 4000, "memory": 16 << 30}, labels={ZONE: "a"})
    b.add_running_pod("n0", R1, labels={"app": "db"}, namespace="team-a",
                      pod_affinity=[_term(m, _web(m), anti=True,
                                          required=True)])
    b.add_pod("w-a", R1, labels={"app": "web"}, namespace="team-a")
    b.add_pod("w-b", R1, labels={"app": "web"}, namespace="team-b")
    return b.build()


def hand_preferred_and_schedule_anyway(m):
    """Preferred (anti-)affinity weights, ScheduleAnyway spread with a
    key-less node (the max-count fallback) and two terms per pod."""
    b = m.mod.SnapshotBuilder(m.cfg())
    _nodes(m, b, n=6, zones=("a", "b", "c"))
    b.add_node("keyless", {"cpu": 8000, "memory": 32 << 30})
    for i in range(3):
        b.add_running_pod(f"n{i}", R1, labels={"app": "web"})
    for i in range(8):
        b.add_pod(f"p{i}", R1, priority=float(i), labels={"app": "web"},
                  topology_spread=[m.mod.TopologySpreadConstraint(
                      ZONE, max_skew=1, when_unsatisfiable="ScheduleAnyway",
                      selector=_web(m))],
                  pod_affinity=[
                      _term(m, _web(m), required=False, weight=7.5),
                      _term(m, (m.mod.MatchExpression("app", "In", ("db",)),),
                            anti=True, required=False, weight=3.25)])
    return b.build()


HAND = {
    "running_anti": hand_running_anti,
    "pending_anti_holder": hand_pending_anti_holder,
    "keyless_holder": hand_keyless_holder,
    "empty_selector_anti": hand_empty_selector_anti,
    "run_anti_two_atoms": hand_run_anti_two_atoms,
    "keyless_member_all_zero": hand_keyless_member_all_zero,
    "self_match_special_case": hand_self_match_special_case,
    "ns_own_scope": _ns_case({}, "other"),
    "ns_explicit": _ns_case({"namespaces": ("other",)}, "other"),
    "ns_star": _ns_case({"namespaces": ("*",)}, "whatever"),
    "ns_anti_other": _ns_case({}, "other", anti=True),
    "ns_mixed_pods": _ns_case({"namespaces": ("other", "mine")}, "other",
                              pods_ns=("mine", "third", "other")),
    "spread_other_ns": hand_spread_ns(False),
    "spread_same_ns": hand_spread_ns(True),
    "holder_scope": hand_holder_scope,
    "preferred_schedule_anyway": hand_preferred_and_schedule_anyway,
}


def _gen(**kw):
    P, N = kw.pop("size", (40, 12))
    return lambda m, rng: m.synth.make_cluster(rng, P, N, **kw)


# (generator, seed): tests/test_parity.py's pairwise shapes (seed 0, the
# rng fixture), then mixes with every pairwise feature.
GEN = {
    "spread": (_gen(size=(30, 12), spread_frac=0.6), 0),
    "interpod": (_gen(size=(30, 12), interpod_frac=0.6), 0),
    "kitchen_sink": (_gen(size=(48, 16), taint_frac=0.3, toleration_frac=0.3,
                          selector_frac=0.2, affinity_frac=0.3,
                          spread_frac=0.3, interpod_frac=0.3), 0),
    "config3": (lambda m, rng: m.synth.config3_pairwise(rng, 60, 16), 43),
    "config3_anti_ns_keyless": (lambda m, rng: m.synth.config3_pairwise(
        rng, 60, 16, run_anti_frac=0.2, namespace_count=3,
        keyless_node_frac=0.15), 43),
    "run_anti_keyless": (_gen(run_anti_frac=0.4, keyless_node_frac=0.3,
                              interpod_frac=0.3), 5),
    "namespaces": (_gen(spread_frac=0.4, interpod_frac=0.4,
                        run_anti_frac=0.2, namespace_count=3), 900),
}


def _fuzz_parity(seed):
    """tests/test_parity.py:test_parity_fuzz's draws."""
    def gen(m, rng):
        return m.synth.make_cluster(
            rng, n_pods=int(rng.integers(5, 60)),
            n_nodes=int(rng.integers(3, 24)),
            initial_utilization=float(rng.uniform(0.1, 0.6)),
            taint_frac=float(rng.uniform(0, 0.5)),
            toleration_frac=float(rng.uniform(0, 0.5)),
            selector_frac=float(rng.uniform(0, 0.4)),
            affinity_frac=float(rng.uniform(0, 0.4)),
            spread_frac=float(rng.uniform(0, 0.4)),
            interpod_frac=float(rng.uniform(0, 0.4)))
    return gen, 1000 + seed


def _fuzz_anti(seed):
    """tests/test_symmetric_anti.py:test_parity_fuzz_with_running_anti."""
    def gen(m, rng):
        return m.synth.make_cluster(
            rng, n_pods=int(rng.integers(10, 50)),
            n_nodes=int(rng.integers(4, 16)),
            interpod_frac=float(rng.uniform(0, 0.5)),
            spread_frac=float(rng.uniform(0, 0.4)),
            run_anti_frac=float(rng.uniform(0.1, 0.5)),
            keyless_node_frac=float(rng.uniform(0, 0.3)))
    return gen, 7000 + seed


def _fuzz_ns(seed):
    """tests/test_namespace.py:test_parity_fuzz_with_namespaces."""
    return (lambda m, rng: m.synth.make_cluster(
        rng, 40, 12, spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2,
        namespace_count=3), 900 + seed)


for _s in range(8):
    GEN[f"fuzz_parity_{_s}"] = _fuzz_parity(_s)
for _s in range(6):
    GEN[f"fuzz_running_anti_{_s}"] = _fuzz_anti(_s)
for _s in range(4):
    GEN[f"fuzz_namespaces_{_s}"] = _fuzz_ns(_s)


def both_snaps(name):
    """(JAX snapshot, port snapshot) of a case, each built by its own
    package's builder or generator."""
    if name in HAND:
        return HAND[name](JAXM)[0], HAND[name](PORT)[0]
    gen, seed = GEN[name]
    return (gen(JAXM, np.random.default_rng(seed))[0],
            gen(PORT, np.random.default_rng(seed))[0])


ALL = sorted(HAND) + sorted(GEN)

# -- builder and generator ----------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_builder_arrays_match_jax(name):
    jsnap, tsnap = both_snaps(name)
    assert_same_arrays(jsnap, tsnap)


# -- kernels' plain versions against the JAX functions ------------------------


KERNEL_CASES = ["config3", "config3_anti_ns_keyless", "run_anti_keyless",
                "namespaces", "kitchen_sink", "preferred_schedule_anyway",
                "ns_mixed_pods"]


def _tensors(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _state_eq(jst, tst):
    for f in ("counts", "anti", "match_tot"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)


def _kernel_setup(name):
    jsnap, tsnap = both_snaps(name)
    jsat, jmem = jax_sat_tables(jsnap)
    jstatic = jassign.precompute_static(JConfig(), jsnap, jsat, jmem)
    _, tmem = _sat_tables(tsnap)
    tstatic = tassign.precompute_static(EngineConfig(), tsnap,
                                        *_sat_tables(tsnap))
    return jsnap, tsnap, jmem, tmem, jstatic, tstatic


def _some_assignment(tsnap, seed):
    """A pending assignment (-1 for about a third of the pods) onto
    valid nodes, for states with pending members."""
    rng = np.random.default_rng(seed)
    n_valid = int(tsnap.nodes.valid.sum())
    P = tsnap.pods.valid.shape[0]
    a = rng.integers(0, n_valid, size=P).astype(np.int32)
    a[(rng.random(P) < 0.33) | ~tsnap.pods.valid.numpy()] = -1
    return a


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_sig_match_and_domains_match_jax(name):
    jsnap, tsnap, jmem, tmem, jstatic, _ = _kernel_setup(name)
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    ns = kpair.merge_members(tsnap.running.namespace, tsnap.pods.namespace)
    want = np.asarray(jpair.sig_member_match(jsnap, jmem))
    np.testing.assert_array_equal(
        kpair.sig_match_plain(tmem, tsnap.sigs, ns).numpy(), want)
    np.testing.assert_array_equal(
        kpair.sig_match(tmem, tsnap.sigs, ns).numpy(), want)
    np.testing.assert_array_equal(kpair.sig_domains(tsnap).numpy(),
                                  np.asarray(jpair.sig_domains(jsnap)))


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_pair_counts_match_jax(name):
    """K10's plain version: pair_state_init, and pair_state_seed at an
    assignment with pending holders."""
    jsnap, tsnap, _, _, jstatic, tstatic = _kernel_setup(name)
    dom = kpair.sig_domains(tsnap)
    args = (tstatic.sig_match, dom, tsnap.running, tsnap.pods)
    _state_eq(jpair.pair_state_init(jsnap, jstatic.sig_match),
              kpair.pair_counts_plain(*args))
    _state_eq(jpair.pair_state_init(jsnap, jstatic.sig_match),
              kpair.pair_counts(*args))
    a = _some_assignment(tsnap, 1)
    jst = jpair.pair_state_seed(jsnap, jstatic.sig_match,
                                jnp.asarray(np.maximum(a, 0)),
                                jnp.asarray(a >= 0))
    _state_eq(jst, kpair.pair_counts_plain(*args,
                                           assigned=torch.from_numpy(a)))


def _states(jsnap, tsnap, jstatic, tstatic, seed):
    """The same non-trivial pair state on both sides."""
    a = _some_assignment(tsnap, seed)
    jst = jpair.pair_state_seed(jsnap, jstatic.sig_match,
                                jnp.asarray(np.maximum(a, 0)),
                                jnp.asarray(a >= 0))
    tst = kpair.pair_counts_plain(tstatic.sig_match,
                                  kpair.sig_domains(tsnap), tsnap.running,
                                  tsnap.pods, assigned=torch.from_numpy(a))
    return jst, tst


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_pairwise_batch_matches_jax(name):
    """K11's plain version and pairwise_from_counts / symmetric_anti_block
    against the JAX functions, on a state with pending members."""
    jsnap, tsnap, _, _, jstatic, tstatic = _kernel_setup(name)
    jst, tst = _states(jsnap, tsnap, jstatic, tstatic, 2)
    dom = kpair.sig_domains(tsnap)
    aff_ok = torch.from_numpy(np.array(jstatic.aff_ok))
    want = jpair.pairwise_from_counts(jsnap, jst, jstatic.aff_ok,
                                      jstatic.sig_match)
    got = kpair.pairwise_from_counts(tsnap, tst, aff_ok, tstatic.sig_match,
                                     dom)
    for g, w, f in zip(got, want, ("spread_ok", "spread_pen", "ia_ok",
                                   "ia_raw")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(
        kpair.symmetric_anti_block(tsnap, tst, tstatic.sig_match,
                                   dom).numpy(),
        np.asarray(jpair.symmetric_anti_block(jsnap, jst,
                                              jstatic.sig_match)))
    nvalid = jsnap.nodes.valid
    want11 = (np.asarray(want[0] & want[2]),
              np.asarray(jscore.inverse_normalize(want[1], nvalid)),
              np.asarray(jscore.minmax_normalize(want[3], nvalid)))
    for fn in (kpair.pairwise_batch_plain, kpair.pairwise_batch):
        got11 = fn(tsnap, tst, aff_ok, tstatic.sig_match, dom)
        for g, w in zip(got11, want11):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_pairwise_row_and_add_pod_match_jax(name):
    """The scan's per-pod row and state update (K4's pairwise variant's
    plain parts) against the JAX functions, pod by pod."""
    jsnap, tsnap, _, _, jstatic, tstatic = _kernel_setup(name)
    jst, tst = _states(jsnap, tsnap, jstatic, tstatic, 3)
    dom = kpair.sig_domains(tsnap)
    aff_ok = torch.from_numpy(np.array(jstatic.aff_ok))
    P = int(tsnap.pods.valid.sum())
    n_valid = int(tsnap.nodes.valid.sum())
    for p in range(P):
        want = jpair.pairwise_row(jsnap, jst, jstatic.sig_match, p,
                                  jstatic.aff_ok[p])
        got = kpair.pairwise_row(tsnap, tst, tstatic.sig_match, dom, p,
                                 aff_ok[p])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n, on = (3 * p + 1) % n_valid, p % 3 != 0
        jst = jpair.pair_state_add_pod(jsnap, jst, jstatic.sig_match, p,
                                       jnp.int32(n), jnp.bool_(on))
        tst = kpair.pair_state_add_pod(tsnap, tst, tstatic.sig_match, dom, p,
                                       torch.tensor(n), torch.tensor(on))
        _state_eq(jst, tst)


# -- the slice as a whole: parity solves --------------------------------------


def _solve_three(jsnap, tsnap, **cfg_kw):
    jcfg, tcfg = JConfig(**cfg_kw), EngineConfig(**cfg_kw)
    jeng = JEngine(jcfg)
    teng = Engine(tcfg, device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = teng.solve(tsnap)
    finally:
        jeng.close()
        teng.close()
    return tres, jres, Oracle(jsnap, jcfg).solve()


def _assert_parity(tres, jres, ores):
    np.testing.assert_array_equal(tres.assignment, jres.assignment,
                                  err_msg="placements diverge from JAX")
    np.testing.assert_array_equal(tres.assignment, ores.assignment,
                                  err_msg="placements diverge from oracle")
    np.testing.assert_array_equal(tres.order, jres.order)
    n = len(ores.order)
    np.testing.assert_array_equal(tres.order[:n], ores.order)
    np.testing.assert_allclose(tres.final_used, ores.final_used, rtol=1e-5)
    both = np.isfinite(ores.chosen_score)
    np.testing.assert_array_equal(np.isfinite(tres.chosen_score), both)
    np.testing.assert_allclose(tres.chosen_score[both],
                               jres.chosen_score[both], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tres.chosen_score[both],
                               ores.chosen_score[both], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", ALL)
def test_parity_solve_matches_jax_and_oracle(name):
    jsnap, tsnap = both_snaps(name)
    assert np.asarray(jsnap.sigs.valid).any()
    _assert_parity(*_solve_three(jsnap, tsnap))


@pytest.mark.parametrize("name", ["config3", "config3_anti_ns_keyless",
                                  "fuzz_running_anti_0", "namespaces",
                                  "preferred_schedule_anyway"])
def test_parity_solve_seeded_tie_break(name):
    jsnap, tsnap = both_snaps(name)
    _assert_parity(*_solve_three(jsnap, tsnap, tie_break="seeded",
                                 tie_seed=11))


def test_parity_solve_places_pods_apart():
    """The behaviour the constraints exist for: the web pod avoids the
    anti-affinity holder's zone, and the final pair state recounted by
    K10 equals the scan's."""
    _, tsnap = both_snaps("pending_anti_holder")
    res = Engine(EngineConfig(), device="cpu").solve(tsnap)
    zones = tsnap.nodes.domain[:, 0].numpy()
    assert (res.assignment[:2] >= 0).all()
    assert zones[res.assignment[0]] != zones[res.assignment[1]]
    cfg = EngineConfig()
    static = tassign.precompute_static(cfg, tsnap, *_sat_tables(tsnap))
    dom = kpair.sig_domains(tsnap)
    st0 = kpair.pair_counts(static.sig_match, dom, tsnap.running, tsnap.pods)
    order = tassign.pop_order(cfg, tsnap)
    a, _, _, st = tassign.parity_scan_pair(cfg, tsnap, static, order, st0,
                                           dom)
    rec = kpair.pair_counts(static.sig_match, dom, tsnap.running, tsnap.pods,
                            assigned=a)
    for f in ("counts", "anti", "match_tot"):
        assert torch.equal(getattr(rec, f), getattr(st, f))


# -- ScoreBatch ----------------------------------------------------------------


SCORE_CASES = ["config3", "config3_anti_ns_keyless", "kitchen_sink",
               "namespaces", "run_anti_keyless", "preferred_schedule_anyway",
               "spread_same_ns", "holder_scope"]


@pytest.mark.parametrize("name", SCORE_CASES)
def test_score_batch_matches_jax_and_oracle(name):
    jsnap, tsnap = both_snaps(name)
    eng = Engine(EngineConfig(), device="cpu")
    jeng = JEngine(JConfig())
    try:
        got = eng.score(tsnap)
        want = jeng.score(jsnap)
        idx, val, _ = eng.score_topk(tsnap, 3)
        best, mx, anyf, _ = eng.score_top1(tsnap)
    finally:
        eng.close()
        jeng.close()
    np.testing.assert_array_equal(got.feasible, want.feasible)
    oracle = Oracle(jsnap, JConfig())
    used = np.asarray(jsnap.nodes.used)
    P, N = got.feasible.shape
    masked = np.full((P, N), -np.inf, np.float32)
    for p in range(int(np.asarray(jsnap.pods.valid).sum())):
        feasible, score = oracle.feasible_and_score(p, used)
        np.testing.assert_array_equal(got.feasible[p], feasible,
                                      err_msg=f"pod {p}")
        np.testing.assert_array_equal(got.scores[p][feasible],
                                      score[feasible], err_msg=f"pod {p}")
        masked[p] = np.where(feasible, score, -np.inf)
    # Top-k: a stable descending sort of the oracle's masked matrix.
    ranked = np.argsort(-masked, axis=1, kind="stable")[:, :3]
    ok = np.isfinite(np.take_along_axis(masked, ranked, axis=1))
    np.testing.assert_array_equal(idx, np.where(ok, ranked, -1))
    np.testing.assert_array_equal(anyf, ok[:, 0])
    np.testing.assert_array_equal(best, np.where(ok[:, 0], ranked[:, 0], -1))


# -- fast mode ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["config3", "running_anti"])
def test_fast_mode_refuses_signatures(name):
    """Fast mode takes signatures now (it refused them before the fast
    rounds with signatures were ported): the solve is valid under the
    oracle's commit-key audit and places as many pods as the JAX fast
    engine, less 2 (tests/test_torch_fastsig_solve.py holds more
    snapshots to this)."""
    jsnap, tsnap = both_snaps(name)
    eng = Engine(EngineConfig(mode="fast"), device="cpu")
    jeng = JEngine(JConfig(mode="fast"))
    try:
        res = eng.solve(tsnap)
        jres = jeng.solve(jsnap)
    finally:
        eng.close()
        jeng.close()
    assert validate_assignment(jsnap, JConfig(mode="fast"), res.assignment,
                               commit_key=res.commit_key) == []
    assert (res.assignment >= 0).sum() >= (jres.assignment >= 0).sum() - 2
    assert res.rounds > 0 and res.host_reads > 0


def test_jax_snapshot_carries_across():
    """A JAX-built pairwise snapshot, carried across leaf by leaf, solves
    like the port-built one."""
    jsnap, tsnap = both_snaps("config3_anti_ns_keyless")
    carried = snapshot_from_numpy(jax.device_get(jsnap))
    eng = Engine(EngineConfig(), device="cpu")
    try:
        np.testing.assert_array_equal(eng.solve(carried).assignment,
                                      eng.solve(tsnap).assignment)
    finally:
        eng.close()
