"""Fast mode with pairwise signatures in the port (topology spread and
inter-pod constraints in `Engine(EngineConfig(mode="fast"))`), its
building blocks against the JAX package's functions, on the CPU, where
every kernel wrapper runs its plain version. The whole solves are in
tests/test_torch_fastsig_solve.py.

Tolerances:
  * `_sig_involvement`, `pair_state_commit` (both signs),
    `ia_ok_at_choice`, `pairwise_from_counts` with exclude_self_node,
    `_spread_waterfill_deal`, `_spread_excess_mask`, and
    `batched_cycle(return_relaxed=True)`'s feasible and relaxed masks:
    bitwise equal to JAX's (bool and int outputs; f32 outputs that are
    integer counts or gathers of the same input scores);
  * `batched_cycle`'s scores: rtol 1e-4 / atol 1e-3, the JAX package's
    parity tolerance (XLA on the CPU contracts multiply-adds, ROADMAP
    C1);
  * `_node_add`: rtol 1e-6. JAX adds each node's segment total at once,
    the port its rows one at a time in rank order (another association,
    as ROADMAP C2 records for the sub-step commits);
  * the compaction twin: compacted rounds (compact_cap = 8) bitwise
    equal to full-width rounds (compact_cap = 0) in assignment, chosen
    score, commit key, final usage, rounds and host reads.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels import assign as jassign
from tpusched.kernels import pairwise as jpair
from tpusched.oracle import validate_assignment
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_pairwise import (
    KERNEL_CASES,
    _kernel_setup,
    _some_assignment,
    _state_eq,
    _states,
)

# Cases with DoNotSchedule spread members (the water-fill and the excess
# validator have work), then the kernel cases of the pairwise slice.
CASES = KERNEL_CASES + ["spread", "interpod", "fuzz_parity_3"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _setup(name, seed):
    """Both packages' snapshot, StaticCtx and the same pair state with
    pending members, plus numpy rank (pop order) and the state's sig
    domains on the port side."""
    jsnap, tsnap, _, _, jstatic, tstatic = _kernel_setup(name)
    jst, tst = _states(jsnap, tsnap, jstatic, tstatic, seed)
    order = tassign.pop_order(EngineConfig(), tsnap)
    rank = torch.zeros_like(order, dtype=torch.int32)
    rank[order] = torch.arange(order.shape[0], dtype=torch.int32)
    return (jsnap, tsnap, jstatic, tstatic, jst, tst, rank,
            kpair.sig_domains(tsnap))


def _choice_kept(tsnap, seed):
    """A committed subset (about 70 %) at random valid nodes."""
    rng = np.random.default_rng(seed)
    P = tsnap.pods.valid.shape[0]
    n_valid = int(tsnap.nodes.valid.sum())
    choice = rng.integers(-1, n_valid, size=P).astype(np.int32)
    kept = (rng.random(P) < 0.7) & (choice >= 0) & tsnap.pods.valid.numpy()
    return choice, kept


@pytest.mark.parametrize("name", CASES)
def test_sig_involvement_matches_jax(name):
    jsnap, tsnap, jstatic, tstatic, _, _, _, dom = _setup(name, 4)
    jst0 = jpair.pair_state_init(jsnap, jstatic.sig_match)
    tst0 = kpair.pair_counts(tstatic.sig_match, dom, tsnap.running,
                             tsnap.pods)
    jinv, jhp = jassign._sig_involvement(jsnap, jstatic, jst0)
    tinv, thp = tassign._sig_involvement(tsnap, tstatic, tst0)
    np.testing.assert_array_equal(tinv.numpy(), _np(jinv))
    np.testing.assert_array_equal(thp.numpy(), _np(jhp))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("name", CASES)
def test_pair_state_commit_matches_jax(name, sign):
    """K10's commit entry point (plain, and the wrapper on the CPU) is
    JAX pair_state_commit, adding and taking back. Both consume the state
    they are handed (each call gets its own copy) and return its tensors,
    updated in place."""
    jsnap, tsnap, jstatic, tstatic, jst, tst, _, dom = _setup(name, 5)
    choice, kept = _choice_kept(tsnap, 6)
    want = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                   jnp.asarray(choice), jnp.asarray(kept),
                                   sign=sign)
    for fn in (kpair.pair_commit_plain, kpair.pair_commit):
        given = kpair.copy_state(tst)
        got = fn(tsnap, given, tstatic.sig_match, dom, _t(choice), _t(kept),
                 sign)
        _state_eq(want, got)
        for f in ("counts", "anti", "match_tot"):
            assert getattr(got, f) is getattr(given, f)
    # Taking back what was added gives the state back.
    there = kpair.pair_commit(tsnap, kpair.copy_state(tst),
                              tstatic.sig_match, dom, _t(choice), _t(kept),
                              1.0)
    back = kpair.pair_commit(tsnap, there, tstatic.sig_match, dom,
                             _t(choice), _t(kept), -1.0)
    for f in ("counts", "anti", "match_tot"):
        assert torch.equal(getattr(back, f), getattr(tst, f))


@pytest.mark.parametrize("name", CASES)
def test_ia_ok_at_choice_matches_jax_and_full_matrix(name):
    """K14's plain version equals JAX ia_ok_at_choice, and the port's own
    pairwise_from_counts(exclude_self_node=esn) at the chosen column
    (the relation tests/test_fast.py pins on the JAX side); that
    pairwise_from_counts equals JAX's in all four outputs."""
    jsnap, tsnap, jstatic, tstatic, jst, tst, _, dom = _setup(name, 7)
    choice, kept = _choice_kept(tsnap, 8)
    jst2 = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                   jnp.asarray(choice), jnp.asarray(kept))
    tst2 = kpair.pair_commit(tsnap, tst, tstatic.sig_match, dom, _t(choice),
                             _t(kept))
    esn = np.where(kept, choice, -1).astype(np.int32)
    want = _np(jpair.ia_ok_at_choice(jsnap, jst2, jstatic.sig_match,
                                     jnp.asarray(choice), jnp.asarray(esn)))
    for fn in (kpair.ia_ok_at_choice_plain, kpair.ia_ok_at_choice):
        got = fn(tsnap, tst2, tstatic.sig_match, dom, _t(choice), _t(esn))
        np.testing.assert_array_equal(got.numpy(), want)
    aff_ok = _t(jstatic.aff_ok)
    full = kpair.pairwise_from_counts(tsnap, tst2, aff_ok, tstatic.sig_match,
                                      dom, exclude_self_node=_t(esn))
    jfull = jpair.pairwise_from_counts(jsnap, jst2, jstatic.aff_ok,
                                       jstatic.sig_match,
                                       exclude_self_node=jnp.asarray(esn))
    for g, w in zip(full, jfull):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    P = choice.shape[0]
    col = full[2][torch.arange(P), _t(np.maximum(choice, 0)).long()]
    np.testing.assert_array_equal(col.numpy()[kept], want[kept])


def _cycle_inputs(name, seed):
    """JAX and port batched_cycle(return_relaxed=True) against the same
    state and usage (every valid pod pending)."""
    s = _setup(name, seed)
    jsnap, tsnap, jstatic, tstatic, jst, tst, rank, dom = s
    used = _np(jsnap.nodes.used)
    jout = jassign.batched_cycle(JConfig(), jsnap, jstatic, jnp.asarray(used),
                                 jst, return_relaxed=True)
    tout = tassign.batched_cycle(EngineConfig(), tsnap, tstatic, _t(used),
                                 pair_st=tst, pending=tsnap.pods.valid,
                                 return_relaxed=True)
    return s, used, jout, tout


@pytest.mark.parametrize("name", CASES)
def test_batched_cycle_relaxed_matches_jax(name):
    _, _, (jf, js, jr), (tf, ts, tr) = _cycle_inputs(name, 9)
    np.testing.assert_array_equal(tf.numpy(), _np(jf))
    np.testing.assert_array_equal(tr.numpy(), _np(jr))
    assert (_np(jr) | ~_np(jf)).all()          # relaxed contains feasible
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", CASES)
def test_spread_waterfill_deal_matches_jax(name):
    """K12's plain version and its torch tables against JAX
    `_spread_waterfill_deal`, on JAX's relaxed rows and scores."""
    s, used, (_, jscore, jrel), _ = _cycle_inputs(name, 10)
    jsnap, tsnap, _, _, jst, tst, rank, dom = s
    rng = np.random.default_rng(11)
    allowed = _np(jrel).any(axis=1) & (rng.random(rank.shape[0]) < 0.8)
    N = dom.shape[1]
    K = tassign._fallback_depth(N)
    want = jassign._spread_waterfill_deal(
        jsnap, jst, jnp.asarray(used), jrel, jscore, jnp.asarray(allowed),
        jnp.asarray(rank.numpy()), K)
    for ops in (tassign.PLAIN, tassign.KERNELS):
        got = tassign._spread_waterfill_deal(
            tsnap, tst, _t(used), _t(jrel), _t(jscore), _t(allowed), rank, K,
            dom, ops)
        for g, w, f in zip(got, want, ("cand", "val", "ok")):
            np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=f)
    if name in ("config3", "spread"):
        assert got[2].any()                    # members were dealt


@pytest.mark.parametrize("name", CASES)
def test_spread_excess_mask_matches_jax(name):
    """K13's two entry points (plain) inside `_spread_excess_mask`
    against JAX, against an end-of-round state holding the kept pods."""
    jsnap, tsnap, jstatic, tstatic, jst, tst, rank, dom = _setup(name, 12)
    choice, kept = _choice_kept(tsnap, 13)
    jst2 = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                   jnp.asarray(choice), jnp.asarray(kept))
    tst2 = kpair.pair_commit(tsnap, tst, tstatic.sig_match, dom, _t(choice),
                             _t(kept))
    want = _np(jassign._spread_excess_mask(
        jsnap, jstatic.aff_ok, jnp.asarray(rank.numpy()),
        jnp.asarray(choice), jnp.asarray(kept), jst2))
    for ops in (tassign.PLAIN, tassign.KERNELS):
        got = tassign._spread_excess_mask(tsnap, tstatic.aff_ok, rank,
                                          _t(choice), _t(kept), tst2, dom,
                                          ops)
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "spread":
        assert want.any()                      # some excess to revert


def test_excess_survive_segmented_min():
    """K13's group walk on hand-made groups: the running count and the
    running minimum restart at each group; non-members are never bad."""
    # Sorted rows: group 0 = pods 4, 0, 6; group 3 = pod 1; the
    # non-member group 9 = pods 2, 3, 5.
    gid = torch.tensor([0, 0, 0, 3, 9, 9, 9], dtype=torch.int32)
    perm = torch.tensor([4, 0, 6, 1, 2, 3, 5], dtype=torch.int32)
    member = torch.tensor([1, 1, 0, 0, 1, 0, 1], dtype=torch.bool)
    T = torch.tensor([3., 5., 0., 0., 9., 0., 2.])
    b_fixed = torch.tensor([0., 2., 0., 0., 1., 0., 1.])
    # Group 0: b + q = 2, 2, 4 against running minima 9, 3, 2: pod 6 is
    # bad. Group 3 starts afresh: 2 + 1 <= 5 (not <= 2), pod 1 stays.
    want = torch.zeros(7, dtype=torch.bool)
    want[6] = True
    for fn in (tassign.excess_survive_plain, tassign.excess_survive):
        np.testing.assert_array_equal(fn(gid, perm, member, T, b_fixed),
                                      want)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("name", ["config3", "kitchen_sink",
                                  "config3_anti_ns_keyless"])
def test_node_add_matches_jax(name, sign):
    """K8's node_add as the rounds call it: the commits added to the
    snapshot's usage (sign +1), and a part of them taken back from that
    (sign -1, the validator's reverts)."""
    jsnap, tsnap, _, _, _, _, rank, _ = _setup(name, 14)
    choice, kept = _choice_kept(tsnap, 15)
    P = choice.shape[0]
    used = _np(jsnap.nodes.used)
    jr = jnp.asarray(rank.numpy())
    req = jsnap.pods.requests
    mask = kept
    if sign < 0:
        used = _np(jassign._node_add(jnp.asarray(used), jnp.asarray(choice),
                                     jnp.asarray(kept), req, jr, P))
        mask = kept & (np.random.default_rng(16).random(P) < 0.5)
    want = _np(jassign._node_add(jnp.asarray(used), jnp.asarray(choice),
                                 jnp.asarray(mask), req, jr, P, sign=sign))
    for fn in (tassign.node_add_plain, tassign.node_add):
        got = fn(_t(used), _t(choice), _t(mask), tsnap.pods.requests, rank,
                 sign)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("skew", ["one_hot", "two_hot"])
def test_node_add_skewed_matches_jax(skew, sign):
    """K8's node_add on skewed segments (a gang rolled back on one node,
    two hot nodes beside a spread tail), with runs of equal ranks (ties by
    row index), against JAX's _node_add: rtol 1e-6, JAX adds each node's
    segment total at once."""
    rng = np.random.default_rng(17)
    P, N, R = 400, 12, 3
    node = rng.integers(0, N, P).astype(np.int32)
    if skew == "one_hot":
        node[:] = 4
    else:
        u = rng.random(P)
        node[u < 0.5] = 2
        node[(u >= 0.5) & (u < 0.85)] = 9
    mask = rng.random(P) < 0.9
    rank = (rng.permutation(P) // 3).astype(np.int32)
    used = rng.uniform(1e3, 1e5, (N, R)).astype(np.float32)
    req = rng.uniform(0, 100, (P, R)).astype(np.float32)
    want = _np(jassign._node_add(jnp.asarray(used), jnp.asarray(node),
                                 jnp.asarray(mask), jnp.asarray(req),
                                 jnp.asarray(rank), P, sign=sign))
    for fn in (tassign.node_add_plain, tassign.node_add):
        got = fn(_t(used), _t(node), _t(mask), _t(req), _t(rank), sign)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_desirability_fixed_point_is_width_invariant():
    """K7's fixed-point form: the same column means over any row order
    and with extra rows that no pod allows (a view against the full
    width), and JAX's formula."""
    rng = np.random.default_rng(16)
    P, N = 40, 9
    feasible = torch.from_numpy(rng.random((P, N)) < 0.6)
    masked = torch.from_numpy(
        (rng.random((P, N)) * 300).astype(np.float32))
    masked = torch.where(feasible, masked, float("-inf"))
    allowed = torch.from_numpy(rng.random(P) < 0.8)
    got = tassign.desirability(feasible, masked, allowed, fixed=True)
    perm = torch.from_numpy(rng.permutation(P))
    np.testing.assert_array_equal(
        tassign.desirability(feasible[perm], masked[perm], allowed[perm],
                             fixed=True), got)
    pad = torch.zeros(7, dtype=torch.bool)
    np.testing.assert_array_equal(
        tassign.desirability(torch.cat([feasible, pad[:, None].expand(7, N)]),
                             torch.cat([masked, torch.zeros(7, N)]),
                             torch.cat([allowed, pad]), fixed=True), got)
    contrib = np.where(feasible.numpy() & allowed.numpy()[:, None],
                       masked.numpy(), 0.0)
    iq = np.clip(np.round(contrib * 16.0), -32767, 32767).astype(np.int32)
    want = iq.sum(axis=0).astype(np.float32) / np.float32(
        16.0 * max(int(allowed.sum()), 1))
    want = np.where((feasible.numpy() & allowed.numpy()[:, None]).any(0),
                    want, -np.inf)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the frontier-compaction contract -------------------------------------


def _frontier_snap(seed):
    """tests/test_frontier.py:63's cluster parameters, one snapshot per
    seed, no churn."""
    return jsynth.make_cluster(
        np.random.default_rng(seed), 48, 12, spread_frac=0.4,
        interpod_frac=0.4, run_anti_frac=0.2, namespace_count=2,
        cordon_frac=0.1, selector_frac=0.2, taint_frac=0.15,
        toleration_frac=0.2)[0]


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_compacted_rounds_equal_full_width(seed, tie_break):
    """compact_cap = 8 (compacted [8, N] views once at most 8 pods are
    pending) gives the full-width rounds' (compact_cap = 0) bits, and
    the result is valid with its commit key."""
    jsnap = _frontier_snap(seed)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    res = {}
    for cap in (0, 8):
        cfg = EngineConfig(mode="fast", compact_cap=cap, tie_break=tie_break,
                           tie_seed=5)
        eng = Engine(cfg, device="cpu")
        try:
            res[cap] = eng.solve(tsnap)
        finally:
            eng.close()
    a, b = res[0], res[8]
    for f in ("assignment", "chosen_score", "commit_key", "final_used",
              "order", "rounds"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
    assert b.host_reads > a.host_reads          # the hand-off's read
    viol = validate_assignment(jsnap, JConfig(mode="fast"), b.assignment,
                               commit_key=b.commit_key)
    assert viol == [], viol


def test_compacted_rounds_run_on_views(monkeypatch):
    """With compact_cap = 8 the rounds past the hand-off run on [8, N]
    views (K11/K5 see 8 rows), and the full-width rounds on all P."""
    jsnap = _frontier_snap(21)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    widths = []
    real = tassign.PLAIN.waterfill

    def record(fill, ord_dom, dom_s, s_p, *rest):
        widths.append(s_p.shape[-1])
        return real(fill, ord_dom, dom_s, s_p, *rest)

    ops = dataclasses.replace(tassign.PLAIN, waterfill=record)
    cfg = EngineConfig(mode="fast", compact_cap=8)
    stats = tassign.RoundStats()
    tassign.solve_rounds(cfg, tsnap, *_sat_tables_plain(tsnap), ops=ops,
                         stats=stats)
    P = tsnap.pods.valid.shape[0]
    assert widths[0] == P and widths[-1] == 8
    assert set(widths) == {P, 8}


def _sat_tables_plain(tsnap):
    from tpusched_torch.engine import _sat_tables
    return _sat_tables(tsnap, tassign.PLAIN)
