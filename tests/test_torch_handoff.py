"""The fast round's hand-off from K7 to K8 (`kernels.assign.deal_lists`,
K23's dealing and the candidate lists), K10's in-place `pair_commit`, and
the card's limits (`tpusched_torch.limits`), on the CPU.

- `deal_lists_plain` against the JAX lines it replaces
  (tpusched/kernels/assign.py:815-888, `_deal_commit` after the
  desirability, transcribed with jnp and run per tenant) on inputs whose
  prefix sums are exact in any order, so XLA's cumsum order cannot move a
  dealt position; and against the torch sequence `_deal_commit` ran
  before (kept here) on arbitrary floats, bit for bit.
- `pair_commit_plain` in place against JAX `pair_state_commit`, a tenant
  batch included; a whole solve whose commits poison every state they
  are handed gives the same outputs as one that does not (no solve path
  reads a state after handing it over) and meets the JAX fast contract.
- The refusals by name, and TPUSCHED_PREEMPT_MAX_ROUNDS as JAX reads it
  (a subprocess, so that both packages read it at import).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels import pairwise as jpair
from tpusched.oracle import validate_assignment
from tpusched_torch import Buckets, Engine, EngineConfig, limits
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import _pack_solve, solve_core
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.snapshot import snapshot_from_numpy
from tpusched_torch.tenants import solve_many, stack_snapshots
from test_torch_fastsig import _choice_kept, _setup, _state_eq, _t

ROOT = Path(__file__).resolve().parent.parent
K = 4

# -- the hand-off -------------------------------------------------------------


def _desir(rng, N):
    """Desirabilities with ties, both zeros and -inf (a node no allowed
    pod can take), as K7 gives them, and one +inf."""
    d = rng.choice(np.array([-3.5, -0.0, 0.0, 1.25, 2.5, 7.0, -np.inf],
                            np.float32), N)
    d[rng.integers(N)] = np.inf
    return d.astype(np.float32)


def _handoff_inputs(seed: int, mode: str, seeded: bool, exact: bool,
                    V: int = 40, N: int = 23, R: int = 3):
    """One tenant's arguments of deal_lists (numpy). mode: "scatter"
    (rank a permutation, the full-width rounds), "sorted" (rank-sorted
    view rows, the tranches and drains), "width" (a compacted view's
    global ranks in a 2V-row demand, with K12's override). exact: every
    request and capacity a multiple of 1/4 below 2**10, so every prefix
    is exact in any order."""
    rng = np.random.default_rng(seed)
    if exact:
        alloc = rng.integers(0, 64, (N, R)).astype(np.float32) / 4 + 8
        used = rng.integers(0, 64, (N, R)).astype(np.float32) / 4
        req = rng.integers(0, 12, (V, R)).astype(np.float32) / 4
    else:
        alloc = rng.uniform(1, 9, (N, R)).astype(np.float32)
        used = rng.uniform(0, 9, (N, R)).astype(np.float32)
        req = rng.uniform(0, 2, (V, R)).astype(np.float32)
    feasible = rng.random((V, N)) < 0.6
    feasible[:3] = False                  # all-infeasible rows
    score = rng.choice(np.float32([10.0, 20.0, 20.5, 33.0]), (V, N))
    masked = np.where(feasible, score, -np.inf).astype(np.float32)
    allowed = feasible.any(axis=1) & (rng.random(V) < 0.9)
    if mode == "sorted":
        rank = np.sort(rng.choice(3 * V, V, replace=False))
    elif mode == "width":
        rank = rng.choice(2 * V, V, replace=False)
    else:
        rank = rng.permutation(V)
    topv, topi = (t.numpy() for t in tassign.row_topk_plain(
        torch.from_numpy(masked), K)[:2])
    pick = None
    if seeded:
        # A maximum of each row, not always the lowest-index one.
        top = masked == masked.max(axis=1, keepdims=True)
        pick = np.array([rng.choice(np.flatnonzero(r)) for r in top],
                        np.int32)
    override = None
    if mode == "width":
        override = (rng.integers(0, N, (V, K + 1)).astype(np.int32),
                    rng.choice(np.float32([5.0, -np.inf]), (V, K + 1)),
                    rng.random(V) < 0.3)
    return dict(desir=_desir(rng, N), alloc=alloc, used=used, requests=req,
                allowed=allowed, rank=rank.astype(np.int32),
                feasible=feasible, masked=masked, topv=topv,
                topi=topi.astype(np.int32), tie_pick=pick, override=override,
                rank_is_sorted=mode == "sorted",
                cum_width=2 * V if mode == "width" else None)


def _stack(cases: list[dict]) -> dict:
    """B tenants' arguments on a leading axis (one mode for all)."""
    out = {}
    for k, v in cases[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([c[k] for c in cases])
        elif isinstance(v, tuple):
            out[k] = tuple(np.stack([c[k][i] for c in cases])
                           for i in range(len(v)))
        else:
            out[k] = v
    return out


def _torch_args(a: dict) -> dict:
    conv = (lambda x: None if x is None else
            tuple(map(torch.from_numpy, x)) if isinstance(x, tuple)
            else torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
    return {k: conv(v) for k, v in a.items()}


def _jax_lists(a: dict):
    """tpusched/kernels/assign.py:820-888 on one tenant, with jnp: the
    node order, the dealing, then the candidate lists."""
    desir = jnp.asarray(a["desir"])
    alloc, used = jnp.asarray(a["alloc"]), jnp.asarray(a["used"])
    requests, allowed = jnp.asarray(a["requests"]), jnp.asarray(a["allowed"])
    rank, feasible = jnp.asarray(a["rank"]), jnp.asarray(a["feasible"])
    masked = jnp.asarray(a["masked"])
    topv, topi = jnp.asarray(a["topv"]), jnp.asarray(a["topi"])
    N = alloc.shape[0]
    node_order = jnp.argsort(-desir)
    remaining = jnp.maximum(alloc - used, 0.0)
    remaining = jnp.where(jnp.isfinite(desir)[:, None], remaining, 0.0)
    dem = jnp.where(allowed[:, None], requests, 0.0)
    if a["cum_width"] is not None:
        rm = jnp.zeros((a["cum_width"], dem.shape[1]), dem.dtype).at[
            rank].set(dem)
        my_dem = jnp.cumsum(rm, axis=0)[rank]
    elif a["rank_is_sorted"]:
        my_dem = jnp.cumsum(dem, axis=0)
    else:
        rm = jnp.zeros_like(dem).at[rank].set(dem)
        my_dem = jnp.cumsum(rm, axis=0)[rank]
    cum_rem = jnp.cumsum(remaining[node_order], axis=0)
    pos = jnp.zeros(dem.shape[0], jnp.int32)
    for ri in range(cum_rem.shape[1]):
        pos = jnp.maximum(pos, jnp.searchsorted(
            cum_rem[:, ri], my_dem[:, ri], side="left").astype(jnp.int32))
    dealt = node_order[jnp.clip(pos, 0, N - 1)].astype(jnp.int32)
    dealt_ok = jnp.take_along_axis(feasible, dealt[:, None], axis=1)[:, 0]
    first = topi[:, 0]
    if a["tie_pick"] is not None:
        tie_pick = jnp.asarray(a["tie_pick"])
        tp_val = jnp.take_along_axis(masked, tie_pick[:, None], axis=1)
        topi = topi.at[:, 0].set(tie_pick)
        topv = topv.at[:, 0].set(tp_val[:, 0])
    dealt_score = jnp.take_along_axis(masked, dealt[:, None], axis=1)
    use_dealt = dealt_ok
    if a["tie_pick"] is not None:
        use_dealt = dealt_ok & (dealt_score[:, 0] < topv[:, 0])
    topi = jnp.concatenate(
        [jnp.where(use_dealt, dealt, topi[:, 0])[:, None], topi], axis=1)
    topv = jnp.concatenate(
        [jnp.where(use_dealt, dealt_score[:, 0], topv[:, 0])[:, None],
         topv], axis=1)
    if a["override"] is not None:
        cand, val, ok = (jnp.asarray(x) for x in a["override"])
        topi = jnp.where(ok[:, None], cand, topi)
        topv = jnp.where(ok[:, None], val, topv)
    return np.asarray(topi), np.asarray(topv), np.asarray(first)


def _old_sequence(desir, alloc, used, requests, allowed, rank, feasible,
                  masked, topv, topi, tie_pick, override, rank_is_sorted,
                  cum_width):
    """The torch steps `_deal_commit` ran between K7 and K8 before the
    hand-off became one entry point (K23 called alone), as they were."""
    lead = rank.shape[:-1]
    P = rank.shape[-1]
    N, R = alloc.shape[-2:]
    zero = torch.zeros((), dtype=torch.float32)
    node_order = tassign._desc_order(desir)
    remaining = (alloc - used).clamp_min(0.0)
    remaining = torch.where(torch.isfinite(desir)[..., None], remaining, zero)
    rem_s = remaining.gather(-2, node_order[..., None].expand(*lead, N, R))
    dem = torch.where(allowed[..., None], requests, zero)
    if rank_is_sorted and cum_width is None:
        pos = tassign.deal_plain(dem, rem_s)
    else:
        rank64 = rank.long()
        rm = dem.new_zeros((*lead, P if cum_width is None else cum_width, R))
        rm.scatter_(-2, rank64[..., None].expand(*lead, P, R), dem)
        pos = tassign.deal_plain(rm, rem_s, rank64)
    dealt = node_order.gather(-1, pos.clamp(0, N - 1))
    dealt_ok = feasible.gather(-1, dealt[..., None])[..., 0]
    first_best = topi[..., 0]
    if tie_pick is not None:
        tp_val = masked.gather(-1, tie_pick.long()[..., None])[..., 0]
        topi = torch.cat([tie_pick[..., None], topi[..., 1:]], dim=-1)
        topv = torch.cat([tp_val[..., None], topv[..., 1:]], dim=-1)
    dealt_score = masked.gather(-1, dealt[..., None])[..., 0]
    use_dealt = dealt_ok
    if tie_pick is not None:
        use_dealt = dealt_ok & (dealt_score < topv[..., 0])
    topi = torch.cat([torch.where(use_dealt, dealt.to(torch.int32),
                                  topi[..., 0])[..., None], topi], dim=-1)
    topv = torch.cat([torch.where(use_dealt, dealt_score,
                                  topv[..., 0])[..., None], topv], dim=-1)
    if override is not None:
        cand, val, ok = override
        topi = torch.where(ok[..., None], cand, topi)
        topv = torch.where(ok[..., None], val, topv)
    return topi, topv, first_best


def _cases(seed: int, mode: str, seeded: bool, exact: bool, B):
    if B is None:
        return _handoff_inputs(seed, mode, seeded, exact)
    return _stack([_handoff_inputs(seed + 100 * b, mode, seeded, exact)
                   for b in range(B)])


HANDOFF = [(mode, seeded, B) for mode in ("scatter", "sorted", "width")
           for seeded in (False, True) for B in (None, 3)]


@pytest.mark.parametrize("mode,seeded,B", HANDOFF)
def test_deal_lists_plain_matches_jax(mode, seeded, B):
    """The hand-off's plain version gives JAX's dealt lists bit for bit:
    no tenant axis and B = 3, seeded and not, full-width, rank-sorted and
    compacted (cum_width with K12's override) rows, all-infeasible rows,
    -0.0 / +-inf desirabilities."""
    a = _cases(11, mode, seeded, True, B)
    got = [t.numpy() for t in tassign.deal_lists_plain(
        **_torch_args(a))]
    if B is None:
        want = _jax_lists(a)
    else:
        per = [_jax_lists({k: (v[b] if isinstance(v, np.ndarray) else
                               tuple(x[b] for x in v)
                               if isinstance(v, tuple) else v)
                           for k, v in a.items()}) for b in range(B)]
        want = [np.stack([p[i] for p in per]) for i in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The dealer did work: some list is led by a node that is not the
    # pod's own first choice.
    assert (got[0][..., 0] != got[0][..., 1]).any()


@pytest.mark.parametrize("mode,seeded,B", HANDOFF)
def test_deal_lists_plain_is_the_old_sequence(mode, seeded, B):
    """On arbitrary floats (and a NaN desirability), the entry point on
    CPU tensors, its plain version and the torch steps it replaces give
    the same bits."""
    a = _cases(23, mode, seeded, False, B)
    a["desir"].reshape(-1)[5] = np.nan
    t = _torch_args(a)
    want = _old_sequence(**t)
    for fn in (tassign.deal_lists_plain, tassign.deal_lists):
        got = fn(**t)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


# -- K10's commit in place ----------------------------------------------------


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_pair_commit_in_place_tenants_match_jax(sign):
    """Three tenants (one config-3 cluster, three commit draws): the
    batch commit adds into the stacked state it is handed, and each
    tenant's slice is JAX pair_state_commit of that tenant."""
    jsnap, tsnap, jstatic, tstatic, jst, tst, _, dom = _setup("config3", 5)
    B = 3
    draws = [_choice_kept(tsnap, 6 + b) for b in range(B)]
    snap = stack_snapshots([tsnap] * B)
    st = kpair.PairState(*(torch.stack([getattr(tst, f)] * B)
                           for f in ("counts", "anti", "match_tot")))
    given = kpair.copy_state(st)
    got = kpair.pair_commit(
        snap, given, torch.stack([tstatic.sig_match] * B),
        torch.stack([dom] * B), _t(np.stack([c for c, _ in draws])),
        _t(np.stack([k for _, k in draws])), sign)
    assert got.counts is given.counts and got.match_tot is given.match_tot
    for b, (choice, kept) in enumerate(draws):
        want = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                       jnp.asarray(choice),
                                       jnp.asarray(kept), sign=sign)
        _state_eq(want, got.tenant(b))


def _poisoned(ops):
    """ops whose pair_commit hands back a fresh state and fills the one
    it was handed with NaN: a solve that read a state after handing it
    over would read NaN counts."""
    calls = []

    def commit(snap, st, *args):
        out = kpair.copy_state(kpair.pair_commit(snap, st, *args))
        for t in (st.counts, st.anti, st.match_tot):
            t.fill_(float("nan"))
        calls.append(1)
        return out

    return dataclasses.replace(ops, pair_commit=commit), calls


POISON = {
    "signatures": (lambda: jsynth.config3_pairwise(
        np.random.default_rng(43), 90, 18)[0], {}),
    "gangs": (lambda: jsynth.make_cluster(
        np.random.default_rng(44), 96, 10, initial_utilization=0.6,
        gang_frac=0.7, gang_size=4, spread_frac=0.4,
        interpod_frac=0.4)[0], {}),
    "preemption": (lambda: jsynth.config5_preemption(
        np.random.default_rng(45), 90, 24, spread_frac=0.3,
        interpod_frac=0.3)[0], dict(preemption=True)),
}


@pytest.mark.parametrize("name", sorted(POISON))
def test_no_solve_reads_a_state_it_handed_over(name):
    """A whole fast solve (signatures; gangs rolled back through the
    commit with sign -1; preemption's pairwise fixpoint) gives the same
    outputs when every commit poisons the state it was handed, and they
    meet the JAX fast contract on the same snapshot: no violation, and
    at least as many placements as the JAX fast engine less 2."""
    make, extra = POISON[name]
    jsnap = make()
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    cfg = EngineConfig(mode="fast", **extra)
    outs = []
    for ops in (tassign.KERNELS, _poisoned(tassign.KERNELS)[0]):
        outs.append(_pack_solve(solve_core(cfg, tsnap, ops=ops)))
    poisoned, calls = _poisoned(tassign.KERNELS)
    solve_core(cfg, tsnap, ops=poisoned)
    assert len(calls) >= 1
    assert torch.equal(outs[0], outs[1])
    res = Engine.unpack(tsnap, outs[1])
    jcfg = JConfig(mode="fast", **extra)
    jeng = JEngine(jcfg)
    try:
        jres = jeng.solve(jsnap)
    finally:
        jeng.close()
    viol = validate_assignment(jsnap, jcfg, res.assignment,
                               commit_key=res.commit_key,
                               evicted=res.evicted if extra else None)
    assert viol == [], viol
    placed = lambda r: int((r.assignment >= 0).sum())  # noqa: E731
    assert placed(res) >= placed(jres) - 2, (placed(res), placed(jres))


def test_no_tenant_batch_reads_a_state_it_handed_over():
    """The same for a fast tenant batch with signatures (solve_many)."""
    gen = lambda b, **kw: tsynth.config3_pairwise(  # noqa: E731
        np.random.default_rng(70 + b), 60 - 5 * b, 12, **kw)
    sizes = [dataclasses.asdict(gen(b)[1].buckets) for b in range(2)]
    floor = Buckets(**{k: max(s[k] for s in sizes) for k in sizes[0]})
    snaps = [gen(b, buckets=floor)[0] for b in range(2)]
    stack = stack_snapshots(snaps)
    cfg = EngineConfig(mode="fast")
    poisoned, calls = _poisoned(tassign.KERNELS)
    want = solve_many(cfg, stack, device="cpu")
    got = solve_many(cfg, stack, device="cpu", ops=poisoned)
    assert calls
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the card's limits ----------------------------------------------------------


def _shapes(P=8, N=4, R=3, C=1, M=2, B=None):
    """A snapshot-shaped tree of empty CPU tensors (the check reads
    shapes only)."""
    lead = () if B is None else (B,)
    t = lambda *s: torch.empty((*lead, *s))  # noqa: E731
    return types.SimpleNamespace(
        pods=types.SimpleNamespace(valid=t(P), ts_sig=t(P, C)),
        nodes=types.SimpleNamespace(valid=t(N), allocatable=t(N, R)),
        running=types.SimpleNamespace(valid=t(M)))


def test_card_limits_refuse_by_name():
    """Each card limit raises a ValueError naming it and the value found;
    shapes inside every limit pass."""
    fast = EngineConfig(mode="fast", preemption=True)
    limits.check_card_limits(fast, _shapes(P=10_240, N=5_120, R=8, C=16,
                                           M=40_960))
    limits.check_card_limits(EngineConfig(), _shapes(P=40_000, N=5_120))
    res = tuple(f"r{i}" for i in range(9))
    with pytest.raises(ValueError, match="9 resource axes.*MAX_R = 8"):
        limits.check_config(EngineConfig(resources=res))
    with pytest.raises(ValueError, match="9 resource axes.*MAX_R = 8"):
        limits.check_card_limits(EngineConfig(), _shapes(R=9))
    with pytest.raises(ValueError, match="17 spread constraints.*MAX_C = 16"):
        limits.check_card_limits(EngineConfig(), _shapes(C=17, B=4))
    with pytest.raises(ValueError, match="40000 rows.*DEAL_ROWS = 29056"):
        limits.check_card_limits(EngineConfig(mode="fast"),
                                 _shapes(P=40_000))
    # K18 at Q = 1 (a batch past the SMs, here one SM): 1 024 bidders
    # and 20 000 nodes need 208 580 bytes a CTA.
    big = _shapes(P=2_048, N=20_000, M=8)
    with pytest.raises(ValueError,
                       match="208580 bytes.*Q = 1.*CLAIM_SMEM = 204800"):
        limits.check_card_limits(fast, big, sms=1)
    limits.check_card_limits(fast, big)           # Q = 16 on 132 SMs
    limits.check_card_limits(EngineConfig(mode="fast"), big, sms=1)


def test_engine_refuses_past_a_limit_before_any_launch():
    """The engine runs the check where a card engine does: a CPU engine
    given the card's SM count (as a CUDA engine sets it) refuses a
    snapshot past MAX_C in put and solve, before anything runs; without
    it, the CPU engine solves it (the plain versions take any shape)."""
    cfg = EngineConfig(mode="fast")
    snap = jsynth.make_cluster(np.random.default_rng(3), 12, 4)[0]
    tsnap = snapshot_from_numpy(jax.device_get(snap))
    pods = dataclasses.replace(
        tsnap.pods, ts_sig=tsnap.pods.ts_sig.new_zeros(
            (tsnap.pods.ts_sig.shape[0], 17)))
    wide = dataclasses.replace(tsnap, pods=pods)
    eng = Engine(cfg, device="cpu")
    try:
        eng._sms = limits.H100_SMS
        for call in (eng.put, eng.solve):
            with pytest.raises(ValueError, match="MAX_C = 16"):
                call(wide)
        eng.solve(tsnap)
    finally:
        eng.close()


ROUND_CAP = """
import json, jax, numpy as np
from tpusched import Engine as JEngine, synth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels import assign as ja
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.kernels import assign as ta
from tpusched_torch.snapshot import snapshot_from_numpy
snap = synth.config5_preemption(np.random.default_rng(45), 200, 50)[0]
kw = dict(mode="fast", preemption=True)
j = JEngine(JConfig(**kw))
jr, jx, _ = j.solve_explained(snap)
j.close()
t = Engine(EngineConfig(**kw), device="cpu")
tr, tx, _ = t.solve_explained(snapshot_from_numpy(jax.device_get(snap)))
print(json.dumps(dict(
    caps=[ta._PREEMPT_MAX_ROUNDS, ja._PREEMPT_MAX_ROUNDS],
    rounds=[tr.rounds, jr.rounds],
    assignment=bool((tr.assignment == jr.assignment).all()),
    evicted=bool((tr.evicted == jr.evicted).all()),
    placed=int((tr.assignment >= 0).sum()), evicted_n=int(tr.evicted.sum()),
    stats=[list(tx.auction_stats.shape), list(np.shape(jx.auction_stats))])))
"""


def test_preempt_round_cap_override_acts_as_in_jax():
    """TPUSCHED_PREEMPT_MAX_ROUNDS caps the fast preemption rounds in
    both packages, read at import: a config-5 solve under a cap of 2
    gives JAX's rounds, assignment and evictions, and the explained
    solve's per-round table has 2 rows in both."""
    env = dict(os.environ, TPUSCHED_PREEMPT_MAX_ROUNDS="2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", ROUND_CAP], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["caps"] == [2, 2]
    assert got["rounds"][0] == got["rounds"][1]
    assert got["assignment"] and got["evicted"], got
    assert got["evicted_n"] > 0
    assert got["stats"] == [[2, len(tassign.EXPLAIN_AUCTION_STATS)]] * 2
    # Without the variable the cap is 128, as in JAX.
    assert "TPUSCHED_PREEMPT_MAX_ROUNDS" in os.environ or (
        tassign._PREEMPT_MAX_ROUNDS == 128)
