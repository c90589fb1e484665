"""Fast-mode preemption with PodDisruptionBudgets: the port's
`Engine.solve(EngineConfig(mode="fast", preemption=True))` (on the CPU,
where every kernel wrapper runs its plain version) against the JAX
package's fast engine and its numpy oracle, on snapshots built by the
JAX package and carried across with `snapshot_from_numpy`; and the
auction's functions one by one against the JAX package's.

Every fast case of tests/test_preempt.py and tests/test_pdb.py is here,
with the JAX test's own assertions, the validity audit
(`validate_assignment` with the commit key and the evictions) and, where
the JAX test compares with the oracle, the oracle's assignment and
evictions exactly. On all of these the port also places and evicts
exactly what the JAX fast engine does.

The auction's f32 prefixes run left to right from 0.0 (JAX leaves their
order to XLA); on the tested states the bids, claims and freed
capacity are still bitwise JAX's.

Run as a script (from the repository root) for the placed and evicted
counts and the preemption rounds of a config-5 solve beside the JAX
fast engine's, without and with spread and inter-pod terms:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_fastpreempt.py counts 2000 1000

and for ROADMAP C6's numbers (where the two part: the main rounds
alone, then both packages' preemption rounds from the port's
main-round state and, where those part too, the round and the node
picks there):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_fastpreempt.py c6 2000 1000
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jsat
from tpusched.kernels import assign as jassign
from tpusched.kernels import pairwise as jpair
from tpusched.kernels import preempt as jpre
from tpusched.oracle import Oracle, validate_assignment
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched.synth import make_cluster
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.engine import _sat_tables as tsat
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import pairwise as tpair
from tpusched_torch.kernels import preempt as tpre
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_c6 import _main_rounds
from test_torch_preempt import HAND

FAST = dict(mode="fast", preemption=True)


@pytest.fixture(scope="module")
def jax_fast():
    """One JAX fast engine for the module (its compiled programs are
    shared by the snapshots of one bucket shape)."""
    eng = JEngine(JConfig(**FAST))
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def port_fast():
    eng = Engine(EngineConfig(**FAST), device="cpu")
    yield eng
    eng.close()


def _solve_both(jsnap, jax_fast, port_fast):
    tres = port_fast.solve(snapshot_from_numpy(jax.device_get(jsnap)))
    return tres, jax_fast.solve(jsnap)


def _audit(jsnap, res):
    violations = validate_assignment(
        jsnap, JConfig(**FAST), res.assignment, commit_key=res.commit_key,
        evicted=res.evicted)
    assert violations == [], violations


def _same_as_jax(tres, jres):
    np.testing.assert_array_equal(tres.assignment, jres.assignment)
    np.testing.assert_array_equal(tres.evicted, jres.evicted)
    np.testing.assert_array_equal(tres.commit_key, jres.commit_key)
    assert tres.rounds == jres.rounds


# -- tests/test_preempt.py and tests/test_pdb.py, fast mode -----------------

# The hand-built clusters of test_torch_preempt.HAND that the JAX tests run
# in fast mode, with the fields the JAX test holds to the oracle.
FAST_HAND = {
    "cheapest_victim": ("assignment", "evicted"),          # test_preempt:27
    "no_eligible_victims": ("assignment",),                # :45
    "minimal_victim_prefix": ("evicted",),                 # :61
    "below_slo_meek": (),                                  # :79
    "below_slo_desperate": (),                             # :79
    "respects_taints": (),                                 # :102
    "later_pod_sees_eviction": (),                         # :177
    "gang_members_do_not_preempt": ("assignment", "evicted"),  # :194
    "pdb_protected_avoided": ("assignment", "evicted"),    # test_pdb:21
    "pdb_last_resort": ("assignment", "evicted"),          # :44
    "pdb_limited_evictions": ("evicted",),                 # :64
    "pdb_shared_across_preemptors": ("assignment", "evicted"),  # :89
    "pdb_namespaces": ("assignment", "evicted"),           # :146
}


@pytest.mark.parametrize("case", sorted(FAST_HAND))
def test_fast_hand_cases(case, jax_fast, port_fast):
    build, want_a, want_ev = HAND[case]
    b = JBuilder(JConfig(**FAST))
    build(b)
    jsnap, _ = b.build()
    tres, jres = _solve_both(jsnap, jax_fast, port_fast)
    assert tres.assignment[:len(want_a)].tolist() == want_a
    assert tres.evicted[:len(want_ev)].tolist() == want_ev
    if case == "pdb_namespaces":
        assert np.asarray(jsnap.pdb_allowed)[:2].tolist() == [0.0, 2.0]
    _audit(jsnap, tres)
    _same_as_jax(tres, jres)
    ora = Oracle(jsnap, JConfig(**FAST)).solve()
    for field in FAST_HAND[case]:
        np.testing.assert_array_equal(getattr(tres, field),
                                      getattr(ora, field), err_msg=field)


@pytest.mark.parametrize("seed", range(4))
def test_preemption_fast_valid(seed, jax_fast, port_fast):
    """test_preempt.py:159."""
    rng = np.random.default_rng(12000 + seed)
    jsnap, _ = make_cluster(
        rng, n_pods=int(rng.integers(10, 40)),
        n_nodes=int(rng.integers(3, 10)), initial_utilization=0.9,
        n_running_per_node=4)
    tres, jres = _solve_both(jsnap, jax_fast, port_fast)
    _audit(jsnap, tres)
    _same_as_jax(tres, jres)


@pytest.mark.parametrize(
    "seed", [0, pytest.param(1, marks=pytest.mark.slow),
             pytest.param(2, marks=pytest.mark.slow)])
def test_preemption_fast_valid_many_bidders(seed, jax_fast, port_fast):
    """test_preempt.py:227: many bidders of mixed priorities, where the
    bucket thresholds approximate."""
    rng = np.random.default_rng(13000 + seed)
    jsnap, _ = make_cluster(
        rng, n_pods=120, n_nodes=10, initial_utilization=0.9,
        n_running_per_node=6, tight_utilization=True, pdb_frac=0.3)
    tres, jres = _solve_both(jsnap, jax_fast, port_fast)
    _audit(jsnap, tres)
    assert tres.evicted.sum() > 0, "90% tight utilization must preempt"
    _same_as_jax(tres, jres)


@pytest.mark.parametrize(
    "seed", [0, pytest.param(1, marks=pytest.mark.slow)])
def test_preemption_fast_valid_with_pairwise(seed, jax_fast, port_fast):
    """test_preempt.py:255: signatures present (the pairwise-involved
    plain claimants, the end-of-round validation fixpoint)."""
    rng = np.random.default_rng(14000 + seed)
    jsnap, _ = make_cluster(
        rng, n_pods=60, n_nodes=8, initial_utilization=0.9,
        n_running_per_node=5, tight_utilization=True, interpod_frac=0.3,
        spread_frac=0.3)
    tres, jres = _solve_both(jsnap, jax_fast, port_fast)
    _audit(jsnap, tres)
    _same_as_jax(tres, jres)


# -- the auction, function by function ---------------------------------------


def _jax_and_port(seed, n_pods=40, n_nodes=10, **kw):
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed),
                                         n_pods, n_nodes, **kw)
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap))


@pytest.mark.parametrize("seed", range(4))
def test_precompute_nv_equals_jax(seed):
    """Every field of the node-major victim table bitwise (dtype, shape,
    values), at the fast mode's V = 16 and at a V that cuts segments."""
    jsnap, tsnap = _jax_and_port(seed, pdb_frac=0.5,
                                 namespace_count=2 if seed % 2 else 1)
    for cap in (16, 3):
        jctx = jpre.precompute_nv(JConfig(), jsnap, cap)
        tctx = tpre.precompute_nv(EngineConfig(), tsnap, cap)
        for f in ("vreq", "vcost", "vprio", "vpdb", "vvalid", "vidx"):
            want = np.asarray(getattr(jctx, f))
            got = getattr(tctx, f).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("n_active", [0, 1, 2, 5, 6, 40])
def test_thresholds_equal_nanquantile(n_active):
    """The bucket thresholds against jnp.nanquantile (JAX
    `preempt_auction`'s), bitwise, for none, one, two, an odd and an even
    number of active bidders; and the bidders' buckets."""
    r = np.random.default_rng(n_active)
    C = 40
    prio = r.uniform(0, 1000, C).astype(np.float32)
    prio[::7] = prio[0]                      # ties
    active = np.zeros(C, bool)
    active[r.permutation(C)[:n_active]] = True
    qs = jnp.linspace(0.0, 1.0, tpre.PRIO_BUCKETS, endpoint=False)
    want = np.asarray(jnp.nanquantile(
        jnp.where(jnp.asarray(active), jnp.asarray(prio), jnp.nan), qs))
    got = tpre.prio_thresholds(torch.from_numpy(prio),
                               torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, want)
    bk = np.clip((want[None, :] <= prio[:, None]).sum(1) - 1, 0,
                 tpre.PRIO_BUCKETS - 1)
    np.testing.assert_array_equal(
        tpre.bucket_of(torch.from_numpy(got), torch.from_numpy(prio)).numpy(),
        bk)


def _auction_state(r, jsnap, M, N, C):
    ev = (r.random(M) < 0.2) & np.asarray(jsnap.running.valid)
    used = (np.asarray(jsnap.nodes.used)
            * r.uniform(0.9, 1.05, (N, 1))).astype(np.float32)
    allowed = r.random((C, N)) < 0.7
    prio = r.uniform(0, 600, C).astype(np.float32)
    reqs = np.asarray(jsnap.pods.requests)
    req = reqs[r.integers(0, reqs.shape[0], C)]
    can_plain = r.random(C) < 0.2
    allowed &= ~can_plain[:, None]
    n_plain = r.integers(0, N, C).astype(np.int32)
    rank = r.permutation(C).astype(np.int32)
    return ev, used, allowed, prio, req, can_plain, n_plain, rank


@pytest.mark.parametrize("seed", range(4))
def test_preempt_auction_plain_equals_jax(seed):
    """preempt_auction (K17's auction_ok, the thresholds, K16, K17, K6 at
    K = 256 and K18, plain) against JAX preempt_auction on random states
    (earlier evictions, usage, allowed rows, priorities, plain claimants,
    shuffled ranks): all seven outputs bitwise."""
    jsnap, tsnap = _jax_and_port(300 + seed, n_pods=60, n_nodes=24,
                                 pdb_frac=0.5)
    jcfg, tcfg = JConfig(), EngineConfig()
    jctx = jpre.precompute_nv(jcfg, jsnap, 16)
    tctx = tpre.precompute_nv(tcfg, tsnap, 16)
    M = tsnap.running.valid.shape[0]
    N = tsnap.nodes.valid.shape[0]
    r = np.random.default_rng(seed)
    kept = 0
    for trial in range(4):
        C = 48 if trial % 2 else 1
        st = _auction_state(r, jsnap, M, N, C)
        ev, used, allowed, prio, req, can_plain, n_plain, rank = st
        want = jpre.preempt_auction(
            jcfg, jsnap, jctx, *(jnp.asarray(x) for x in (
                prio, req, allowed, used, ev, can_plain, n_plain)),
            k_cand=8, rank=jnp.asarray(rank))
        got = tpre.preempt_auction(
            tcfg, tsnap, tctx, *(torch.from_numpy(x) for x in (
                prio, req, allowed, used, ev, can_plain, n_plain)),
            k_cand=8, rank=torch.from_numpy(rank),
            pre_active=torch.ones(C, dtype=torch.bool))
        names = ("target", "claimed", "takes_evict", "vidx_t", "freed_req",
                 "usage", "could_bid")
        for name, w, g in zip(names, want, got):
            g = g.numpy()
            if name == "usage":
                g = g.astype(np.float32)
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        kept += int(got[2].sum())
    assert kept > 0


@pytest.mark.parametrize("seed", range(3))
def test_kept_prefix_is_tableau_minimum(seed):
    """On every node an eviction bidder claims, the prefix the auction
    keeps is the lexicographic (violations, cost) minimum over the
    node's fitting prefixes that `_tableau_nv` (the exact [C, N, V]
    form) gives, and the freed capacity is that prefix's request sum."""
    jsnap, tsnap = _jax_and_port(400 + seed, n_pods=60, n_nodes=16,
                                 pdb_frac=0.6)
    cfg = EngineConfig()
    ctx = tpre.precompute_nv(cfg, tsnap, 16)
    M = tsnap.running.valid.shape[0]
    N = tsnap.nodes.valid.shape[0]
    C = 32
    st = _auction_state(np.random.default_rng(seed), jsnap, M, N, C)
    ev, used, allowed, prio, req, can_plain, n_plain, rank = (
        torch.from_numpy(x) for x in st)
    can_plain = torch.zeros_like(can_plain)
    target, _, takes, vidx_t, freed, _, _ = tpre.preempt_auction(
        cfg, tsnap, ctx, prio, req, allowed, used, ev, can_plain, n_plain,
        rank=rank, pre_active=torch.ones(C, dtype=torch.bool))
    elig, wcost, wviol, fits, node_viol, node_cost = tpre._tableau_nv(
        cfg, tsnap, ctx, prio, req, used, ev)
    R = req.shape[1]
    checked = 0
    for c in torch.nonzero(takes)[:, 0].tolist():
        t = int(target[c])
        f = fits[c, t]
        key = [(int(wviol[c, t, v]), float(wcost[c, t, v]), v)
               for v in range(f.shape[0]) if f[v]]
        v_min = min(key)[2]
        assert (int(wviol[c, t, v_min]), float(wcost[c, t, v_min])) == (
            float(node_viol[c, t]), float(node_cost[c, t]))
        sel = elig[c, t] & (torch.arange(f.shape[0]) <= v_min)
        want_idx = torch.where(sel, ctx.vidx[t], M)
        assert torch.equal(vidx_t[c], want_idx)
        wreq = tpre.vprefix(torch.where(elig[c, t][:, None], ctx.vreq[t],
                                        0.0), 0)
        assert torch.equal(freed[c], wreq[v_min, :R])
        checked += 1
    assert checked > 0


def _jax_rows(jcfg, jsnap, jstatic, used, st, sel) -> tuple:
    """JAX's `vmap(pod_cycle)` + `pick_node` over the pods `sel`:
    (feasible, masked score, allowed, picked node), in numpy."""
    def rows(snap, static, used_, st_, sel_):
        def one(p):
            f, s, a = jassign.pod_cycle(jcfg, snap, static, p, used_, st_)
            m = jnp.where(f, s, -jnp.inf)
            return f, m, a, jassign.pick_node(jcfg, m, p)
        return jax.vmap(one)(sel_)
    return tuple(np.asarray(x) for x in jax.jit(rows)(
        jax.device_put(jsnap), jstatic, jnp.asarray(used), st,
        jnp.asarray(sel)))


def test_bidder_rows_equal_jax_pod_cycle():
    """The C-row plain evaluation of the preemption rounds (K11's
    pairwise rows into K5 on the gathered pod view, K6's pick) against
    JAX's `vmap(pod_cycle)` + `pick_node` on a config-3 snapshot with a
    mid-solve pair state: feasibility, the non-resource feasibility and
    the picked node exactly, the score at rtol 1e-6 (ROADMAP C1)."""
    jsnap, _ = jsynth.config3_pairwise(np.random.default_rng(43), 64, 16)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    for tie in ("first", "seeded"):
        jcfg = JConfig(tie_break=tie, tie_seed=7)
        tcfg = EngineConfig(tie_break=tie, tie_seed=7)
        jstatic = jassign.precompute_static(jcfg, jsnap, *jsat(jsnap))
        tstatic = tassign.precompute_static(tcfg, tsnap, *tsat(tsnap))
        P = tsnap.pods.valid.shape[0]
        N = tsnap.nodes.valid.shape[0]
        r = np.random.default_rng(1)
        placed = np.where(r.random(P) < 0.3, r.integers(0, N, P), -1)
        placed = np.where(np.asarray(jsnap.pods.valid), placed, -1)
        jst = jpair.pair_state_init(jsnap, jstatic.sig_match)
        jst = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                      jnp.asarray(placed, jnp.int32),
                                      jnp.asarray(placed >= 0))
        dom = tpair.sig_domains(tsnap)
        tst = tpair.pair_counts(tstatic.sig_match, dom, tsnap.running,
                                tsnap.pods,
                                assigned=torch.from_numpy(
                                    placed.astype(np.int32)))
        used = (np.asarray(jsnap.nodes.used)
                * r.uniform(0.9, 1.1, (N, 1))).astype(np.float32)
        sel = np.asarray(r.permutation(P)[:24], np.int32)
        jf, jm, ja, jn = _jax_rows(jcfg, jsnap, jstatic, used, jst, sel)
        tf, tm, tn, _, pair_ok, view = tassign._bidder_rows(
            tcfg, tsnap, tstatic, torch.from_numpy(sel),
            torch.from_numpy(used), tst, dom, tassign.KERNELS)
        ta = view[1].mask & pair_ok
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(ta.numpy(), ja)
        np.testing.assert_array_equal(tn.numpy(), jn)
        fin = np.isfinite(jm)
        np.testing.assert_array_equal(np.isfinite(tm.numpy()), fin)
        np.testing.assert_allclose(tm.numpy()[fin], jm[fin], rtol=1e-6)
        assert jf.any() and (~jf & ja).any()


# -- config 5 at a CPU size, beside the JAX fast engine ----------------------


def counts(P: int, N: int, seed: int = 45, split: bool = False,
           **kw) -> dict:
    """Placed and evicted counts of the port's fast preemption solve and
    the JAX fast engine's on config5_preemption(rng(seed), P, N). With
    split, also each side's preemption rounds: its rounds less its main
    rounds, those of the same solve without preemption, or without
    signatures at a pod bucket over 2 048 the main rounds under
    preemption's tranche rule (ROADMAP C6: no full-width round 1,
    tranches of 2 rounds)."""
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed), P, N,
                                         **kw)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    cfgs = (FAST, dict(mode="fast")) if split else (FAST,)
    res = []
    for c in cfgs:
        teng = Engine(EngineConfig(**c), device="cpu")
        jeng = JEngine(JConfig(**c))
        try:
            res.append((teng.solve(tsnap), jeng.solve(jsnap)))
        finally:
            teng.close()
            jeng.close()
    tres, jres = res[0]
    extra = {}
    if split:
        main = (res[1][0].rounds, res[1][1].rounds)
        if tsnap.sigs.key.shape[0] == 0:
            got, want, _ = _main_rounds(P, N, seed, **FAST)
            main = (int(got[4]), int(want[4]))
        extra = {"port_preempt_rounds": tres.rounds - main[0],
                 "jax_preempt_rounds": jres.rounds - main[1]}
    return {**extra, "port_placed": int((tres.assignment >= 0).sum()),
            "jax_placed": int((jres.assignment >= 0).sum()),
            "port_evicted": int(tres.evicted.sum()),
            "jax_evicted": int(jres.evicted.sum()),
            "port_rounds": tres.rounds, "jax_rounds": jres.rounds,
            "port_host_reads": tres.host_reads,
            "same_assignment": bool(np.array_equal(tres.assignment,
                                                   jres.assignment)),
            "same_evicted": bool(np.array_equal(tres.evicted, jres.evicted)),
            "violations": len(validate_assignment(
                jsnap, JConfig(**FAST), tres.assignment,
                commit_key=tres.commit_key, evicted=tres.evicted))}


@pytest.mark.parametrize("kw", [{}, dict(spread_frac=0.3, interpod_frac=0.3)],
                         ids=["plain", "pairwise"])
def test_config5_fast_counts(kw):
    """BASELINE config 5 at 400 x 100: valid, and placed within 2 of the
    JAX fast engine (printed with the evictions; -s shows them)."""
    out = counts(400, 100, **kw)
    print(f"config5 400x100 {kw or 'plain'}: {out}")
    assert out["violations"] == 0
    assert out["port_placed"] >= out["jax_placed"] - 2
    assert out["port_evicted"] > 0


def _first_diff(a: np.ndarray, b: np.ndarray):
    d = np.nonzero(a != b)[0]
    return (int(d.shape[0]), int(d[0]), a[d[0]].item(), b[d[0]].item()) \
        if d.shape[0] else (0,)


def drain_on_port_state(P: int, N: int, seed: int = 45, **kw) -> dict:
    """ROADMAP C6: where the port's fast preemption solve parts from the
    JAX fast engine's on config5_preemption(rng(seed), P, N, **kw). The
    main rounds alone (preemption off) on both engines, as (number of
    pods that differ, first pod, port's value, JAX's) per field, and the
    first round after which they differ (max_rounds cut); without
    signatures also the main rounds under preemption's tranche rule
    (`_solve_rounds_nosig` with preemption on); then
    the preemption rounds of both packages from the SAME state, the
    port's main-round result (with preemption's rule where it applies): which of their outputs are bitwise equal
    (chosen: the largest ulp distance); where their assignments differ,
    a preemption round after which they first differ (bisected over
    both packages' round caps), with the first differing pod, the
    largest difference in `used` after the round before it, and there
    each differing pod's node pick and its scores at both picks in both
    packages' bidder rows."""
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed), P, N,
                                         **kw)
    jsnap = jax.device_put(jsnap)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    out = {}
    S = tsnap.sigs.key.shape[0]
    t = Engine(EngineConfig(mode="fast"), device="cpu").solve(tsnap)
    j = JEngine(JConfig(mode="fast")).solve(jsnap)
    out["main rounds placed (port, jax)"] = (int((t.assignment >= 0).sum()),
                                             int((j.assignment >= 0).sum()))
    out["main rounds (port, jax)"] = (t.rounds, j.rounds)
    for f in ("assignment", "commit_key"):
        out[f"main rounds {f} diff"] = _first_diff(getattr(t, f),
                                                   getattr(j, f))
    if not np.array_equal(t.assignment, j.assignment):
        # The first main round after which the assignments differ, and
        # the largest difference in `used` after the round before it.
        used_diff = 0.0
        for r in range(1, j.rounds + 1):
            tr = Engine(EngineConfig(mode="fast", max_rounds=r),
                        device="cpu").solve(tsnap)
            jr = JEngine(JConfig(mode="fast", max_rounds=r)).solve(jsnap)
            if not np.array_equal(tr.assignment, jr.assignment):
                out["first differing main round"] = (
                    r - 1, _first_diff(tr.assignment, jr.assignment),
                    "used max abs diff before it", used_diff)
                break
            used_diff = float(np.abs(tr.final_used.astype(np.float64)
                                     - jr.final_used).max())
    tcfg, jcfg = EngineConfig(**FAST), JConfig(**FAST)
    if S == 0:
        # With preemption the main rounds follow the tranche rule (C6):
        # compare them so, and start both drains from the port's.
        got, want, _ = _main_rounds(P, N, seed, **FAST)
        used, asg, chosen, round_of, rounds = got
        out["main rounds with preemption (port, jax)"] = (int(got[4]),
                                                          int(want[4]))
        for f, i in (("assignment", 1), ("commit_key", 3)):
            out[f"main rounds with preemption {f} diff"] = _first_diff(
                got[i].numpy(), np.asarray(want[i]))
        out["main rounds with preemption used max abs diff"] = float(np.abs(
            used.numpy().astype(np.float64) - np.asarray(want[0])).max())
        order = tassign.pop_order(tcfg, tsnap)
    else:
        asg, chosen, used, order, round_of, rounds, _ = tassign.solve_rounds(
            EngineConfig(mode="fast"), tsnap, *tsat(tsnap))
    static = tassign.precompute_static(tcfg, tsnap, *tsat(tsnap))
    rank = torch.zeros_like(asg)
    rank[order] = torch.arange(asg.shape[0], dtype=torch.int32)
    st = dom = None
    has_pair = torch.zeros(asg.shape[0], dtype=torch.bool)
    if tsnap.sigs.key.shape[0]:
        dom = tpair.sig_domains(tsnap)
        st0 = tpair.pair_counts(static.sig_match, dom, tsnap.running,
                                tsnap.pods)
        has_pair = tassign._sig_involvement(tsnap, static, st0)[1]
        st = tpair.pair_counts(static.sig_match, dom, tsnap.running,
                               tsnap.pods, assigned=asg)
    jstatic = jassign.precompute_static(jcfg, jsnap, *jsat(jsnap))
    jst = jpair.pair_state_init(jsnap, jstatic.sig_match)
    jx = lambda x: jnp.asarray(x.numpy())
    if st is not None:
        jst = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                      jx(asg), jx(asg >= 0))

    def drains(cap: int):
        tcap, jcap = tassign._PREEMPT_MAX_ROUNDS, jassign._PREEMPT_MAX_ROUNDS
        tassign._PREEMPT_MAX_ROUNDS = jassign._PREEMPT_MAX_ROUNDS = cap
        try:
            return (tassign._preempt_rounds(
                tcfg, tsnap, static, rank, order, int(rounds), used.clone(),
                asg.clone(), st and tpair.PairState(
                    st.counts.clone(), st.anti.clone(), st.match_tot.clone()),
                round_of.clone(), chosen.clone(), has_pair, dom,
                tassign.KERNELS, tassign.RoundStats()),
                jassign._preempt_rounds(
                    jcfg, jsnap, jstatic, jx(rank),
                    jx(order.to(torch.int32)), int(rounds), jx(used),
                    jx(asg), jst,
                    jnp.zeros(tsnap.running.valid.shape[0], bool),
                    jx(round_of), jx(chosen), has_pair=jx(has_pair)))
        finally:
            tassign._PREEMPT_MAX_ROUNDS, jassign._PREEMPT_MAX_ROUNDS = (
                tcap, jcap)

    got, want = drains(tassign._PREEMPT_MAX_ROUNDS)
    if not np.array_equal(got[1].numpy(), np.asarray(want[1])):
        lo, hi = 0, max(int(got[6]), int(want[6]))  # agree after lo
        used_diff = 0.0
        while hi - lo > 1:
            mid = (lo + hi) // 2
            g, w = drains(mid)
            if np.array_equal(g[1].numpy(), np.asarray(w[1])):
                lo = mid
                used_diff = float(np.abs(g[0].numpy().astype(np.float64)
                                         - np.asarray(w[0])).max())
            else:
                hi = mid
        g, w = drains(hi)
        ga, wa = g[1].numpy(), np.asarray(w[1])
        out["first differing preemption round"] = (
            hi - 1, _first_diff(ga, wa), "used max abs diff before it",
            used_diff)
        sel = np.nonzero(ga != wa)[0].astype(np.int32)
        g, w = drains(lo)
        _, jm, _, jn = _jax_rows(jcfg, jsnap, jstatic, np.asarray(w[0]),
                                 w[2], sel)
        tm, tn = (x.numpy() for x in tassign._bidder_rows(
            tcfg, tsnap, static, torch.from_numpy(sel), g[0], g[2], dom,
            tassign.KERNELS)[1:3])
        out["there: (pod, port pick, jax pick, port scores at both, jax "
            "scores at both)"] = [
            (int(p), int(a), int(b), float(tm[i, a]), float(tm[i, b]),
             float(jm[i, a]), float(jm[i, b]))
            for i, (p, a, b) in enumerate(zip(sel, tn, jn))]
    for i, f in enumerate(("used", "assignment", "pair state", "evicted",
                           "commit_key", "chosen", "rounds")):
        if f == "pair state":
            if st is not None:
                out["drain pair state equal"] = all(np.array_equal(
                    getattr(got[2], k).numpy(), np.asarray(getattr(
                        want[2], k))) for k in ("counts", "anti",
                                                "match_tot"))
            continue
        g, w = np.asarray(got[i]), np.asarray(want[i])
        out[f"drain {f} equal"] = bool(np.array_equal(g, w))
        if f == "chosen" and not np.array_equal(g, w):
            fin = np.isfinite(w)
            out["drain chosen max ulp"] = int(np.abs(
                g[fin].view(np.int32).astype(np.int64)
                - w[fin].view(np.int32).astype(np.int64)).max())
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    what, P, N = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    for kw in ({}, dict(spread_frac=0.3, interpod_frac=0.3)):
        out = (counts(P, N, split=True, **kw) if what == "counts"
               else drain_on_port_state(P, N, **kw))
        print(f"config5_preemption(rng(45), {P}, {N}) {kw or 'plain'}:",
              out)
