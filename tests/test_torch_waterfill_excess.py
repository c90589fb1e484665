"""K12's and K13's redesign (a warp a row) at the edges its kernels take,
on the CPU, where every wrapper runs its plain version: K12's per-domain
node lists against a brute-force build; the fill-level search its kernel
runs against the count the JAX code defines; K13 inside
`_spread_excess_mask` against JAX with two spread slots a pod, and over a
tenant batch against each tenant's solo call; the group walk on groups
longer than a warp. The kernels against these plain versions, bit for
bit, are in tests/test_torch_cuda.py.

Tolerance: none. Every value here is a bool, an integer or an f32
integer count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import snapshot as jsnapshot
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched.kernels import pairwise as jpair
from tpusched_torch import EngineConfig
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as ka
from tpusched_torch.kernels import pairwise as kp
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_cuda import (PAIR_MIXES, _floored, _on, fill_levels, k12_args,
                             k12_inputs)
from test_torch_pairwise import _states

ZONE = "topology.kubernetes.io/zone"
RACK = "example.com/rack"

# -- K12: the node lists and the fill-level search ----------------------------


def _brute_lists(dom: np.ndarray, cap: np.ndarray):
    """Each signature's nodes grouped by domain (ascending, keyless -1
    first), each group in cap order, one node at a time."""
    S, N = dom.shape
    dsort = np.empty((S, N), np.int32)
    dnode = np.empty((S, N), np.int32)
    for s in range(S):
        out = [n for d in sorted(set(dom[s].tolist())) for n in cap
               if dom[s, n] == d]
        dnode[s] = out
        dsort[s] = dom[s, out]
    return dsort, dnode


def _dom_case(name: str, rng, S: int, N: int) -> np.ndarray:
    if name == "keyless":
        dom = rng.integers(0, max(1, N // 4), (S, N))
        dom[rng.random((S, N)) < 0.3] = -1
    elif name == "one_node_domains":
        dom = np.stack([rng.permutation(N) for _ in range(S)])
    elif name == "empty_domain":
        # Domain 1 has no node (ids 0, 2, 3 and N - 1 only).
        dom = rng.choice([0, 2, 3, N - 1], (S, N))
    else:                                     # every node in one domain
        dom = np.zeros((S, N))
    return dom.astype(np.int32)


@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("case", ["keyless", "one_node_domains",
                                  "empty_domain", "one_domain"])
def test_waterfill_lists_match_brute_force(case, N):
    rng = np.random.default_rng(N)
    S = 3
    dom = _dom_case(case, rng, S, N)
    cap = rng.permutation(N).astype(np.int32)
    got = ka.waterfill_lists(torch.from_numpy(dom), torch.from_numpy(cap))
    for g, w in zip(got, _brute_lists(dom, cap)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # Over a tenant axis: each tenant's lists from its own cap order.
    dom2 = np.stack([dom, _dom_case(case, rng, S, N)])
    cap2 = np.stack([cap, rng.permutation(N).astype(np.int32)])
    got2 = ka.waterfill_lists(torch.from_numpy(dom2), torch.from_numpy(cap2))
    for b in range(2):
        for g, w in zip(got2, _brute_lists(dom2[b], cap2[b])):
            np.testing.assert_array_equal(g[b].numpy(), w)


def _prefix_count(pred: np.ndarray) -> int:
    """K12's search (csrc/waterfill.cu prefix_count), a lane a probe: the
    count of leading true entries of pred, found in steps that each
    probe 32 evenly spaced positions of the open range."""
    lo, hi = 0, len(pred)
    while lo < hi:
        step = (hi - lo + 31) // 32
        probes = [lo + lane * step for lane in range(32)]
        k = sum(1 for i in probes if i < hi and pred[i])
        if k == 0:
            break
        lo, hi = lo + (k - 1) * step + 1, min(hi, lo + k * step)
    return lo


def _fill_rows(case: str, rng, S: int, N: int):
    """Domain counts and signature domains for the fill levels: random
    counts, ties, one signature with no keyed node (every level a
    sentinel), large counts near 2**20, one domain."""
    D = max(1, N // 3)
    dom = rng.integers(0, D, (S, N))
    dom[rng.random((S, N)) < 0.2] = -1
    hi = {"ties": 1, "large": 1 << 20}.get(case, 30)
    counts = rng.integers(0, hi + 1, (S, N)).astype(np.float32)
    if case == "ties":
        counts[:] = 3.0
    if case == "sentinels":
        dom[0] = -1
    if case == "one_domain":
        dom[:] = 0
    return (torch.from_numpy(counts),
            torch.from_numpy(dom.astype(np.int32)))


@pytest.mark.parametrize("N", [1, 5, 33, 1000])
@pytest.mark.parametrize("case", ["random", "ties", "sentinels", "large",
                                  "one_domain"])
def test_fill_search_equals_count(case, N):
    """`fill <= q` holds on a prefix of every fill row K12's tables build
    (real domains nondecreasing, sentinels far above q, a row with no
    real domain all 0), so K12's 32-way search gives the count JAX
    defines, for q = -1 (a non-member), every level and past the last."""
    rng = np.random.default_rng(N)
    S = 4
    counts, dom = _fill_rows(case, rng, S, N)
    fill, _ = fill_levels(counts, dom)
    real = fill[fill < 1e8]
    top = float(real.max()) if real.numel() else 0.0
    qs = sorted({-1.0, 0.0, 1.0, top, top + 1.0, top * 2 + 7.0,
                 *(float(x) for x in rng.integers(0, int(top) + 2, 20))})
    for s in range(S):
        row = fill[s].numpy()
        for q in qs:
            pred = row <= np.float32(q)
            count = int(pred.sum())
            assert pred[:count].all() and not pred[count:].any(), (s, q)
            assert _prefix_count(pred) == count, (s, q)


def test_waterfill_edge_rows_match_the_count():
    """K12's plain version (the count) over k12_inputs' rows: a signature
    with every level a sentinel, rows with no relaxed node, non-members;
    the kernel's search gives the same j_p on each row."""
    x = _on(k12_inputs(np.random.default_rng(5), 300, 40, 4), "cpu")
    fill, ord_dom, dom, s_p, q, relaxed, cap, score, member, K1 = \
        k12_args(x, 9)
    cand, val, ok = ka.waterfill(fill, ord_dom, dom, s_p, q, relaxed, cap,
                                 score, member, K1)
    for p in range(300):
        row = fill[s_p[p].long()].numpy()
        pred = row <= q[p].numpy()
        assert _prefix_count(pred) == int(pred.sum())
    no_node = ~relaxed.any(dim=1)
    assert not ok[no_node].any()
    assert torch.isinf(val[no_node]).all()
    assert (cand[no_node] == cap[-1]).all()
    assert ok.any()


@pytest.mark.parametrize("B", [0, 3])
def test_waterfill_members_and_q_match_brute_force(B):
    """K12's [P] tables (members, their sort keys, the rank positions q)
    against a pod-by-pod build: the first DoNotSchedule slot's signature,
    q = the members of that signature ahead in rank, -1 off members;
    negative ranks (a gathered view's) included."""
    rng = np.random.default_rng(B)
    P, C, S = 200, 3, 5
    lead = (B,) if B else ()
    ts_sig = rng.integers(-1, S, (*lead, P, C)).astype(np.int32)
    ts_valid = rng.random((*lead, P, C)) < 0.7
    ts_when = rng.integers(0, 2, (*lead, P, C)).astype(np.int8)
    allowed = rng.random((*lead, P)) < 0.8
    rank = np.stack([rng.permutation(P) - 7 for _ in range(max(B, 1))])
    rank = (rank if B else rank[0]).astype(np.int32)
    t = [torch.from_numpy(a) for a in (ts_sig, ts_valid, ts_when, allowed,
                                       rank)]
    s_p, member, key = ka.waterfill_members(*t, S)
    q = ka.waterfill_q(*torch.sort(key, dim=-1), S)
    for b in np.ndindex(*lead):
        dns = ts_valid[b] & (ts_when[b] == 0)
        first = np.where(dns.any(1), dns.argmax(1), 0)
        want_s = np.maximum(ts_sig[b][np.arange(P), first], 0)
        want_m = allowed[b] & dns.any(1)
        want_q = np.array([
            ((want_m & (want_s == want_s[p]) & (rank[b] < rank[b][p])).sum()
             if want_m[p] else -1) for p in range(P)], np.float32)
        np.testing.assert_array_equal(s_p[b].numpy(), want_s)
        np.testing.assert_array_equal(member[b].numpy(), want_m)
        np.testing.assert_array_equal(q[b].numpy(), want_q)


# -- K13: two spread slots against JAX, the tenant axis, long groups ----------


def _two_slot_snap(m):
    """Pods with two DoNotSchedule spread constraints each (zone, maxSkew
    1; rack, maxSkew 2); a fifth of the nodes lack the rack key."""
    sel = (m.MatchExpression("app", "In", ("web",)),)
    b = m.SnapshotBuilder(JConfig())
    for i in range(15):
        labels = {ZONE: "abc"[i % 3]}
        if i % 5:
            labels[RACK] = f"r{i % 4}"
        b.add_node(f"n{i}", {"cpu": 8000, "memory": 32 << 30}, labels=labels)
    for i in range(48):
        b.add_pod(f"p{i}", {"cpu": 100, "memory": 1 << 28},
                  priority=float(i % 7), labels={"app": "web"},
                  topology_spread=[
                      m.TopologySpreadConstraint(ZONE, 1, "DoNotSchedule",
                                                 sel),
                      m.TopologySpreadConstraint(RACK, 2, "DoNotSchedule",
                                                 sel)])
    return b.build()[0]


def test_spread_excess_mask_two_slots_matches_jax():
    """_spread_excess_mask with C = 2 slots (one K13 pass for both, one
    sort, one walk ORing both) against JAX's, which loops over the slots,
    on an end-of-round state holding most pods at a few nodes."""
    jsnap = _two_slot_snap(jsnapshot)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    assert tsnap.pods.ts_key.shape[1] == 2
    jsat, jmem = jax_sat_tables(jsnap)
    jstatic = jassign.precompute_static(JConfig(), jsnap, jsat, jmem)
    tstatic = ka.precompute_static(EngineConfig(), tsnap,
                                   *_sat_tables(tsnap))
    jst, tst = _states(jsnap, tsnap, jstatic, tstatic, 3)
    dom = kp.sig_domains(tsnap)
    order = ka.pop_order(EngineConfig(), tsnap)
    rank = ka._rank_of(order)
    rng = np.random.default_rng(4)
    P = tsnap.pods.valid.shape[0]
    choice = rng.integers(0, 4, P).astype(np.int32)
    kept = (rng.random(P) < 0.8) & tsnap.pods.valid.numpy()
    jst2 = jpair.pair_state_commit(jsnap, jst, jstatic.sig_match,
                                   jnp.asarray(choice), jnp.asarray(kept))
    tst2 = kp.pair_commit(tsnap, tst, tstatic.sig_match, dom,
                          torch.from_numpy(choice), torch.from_numpy(kept))
    want = np.asarray(jassign._spread_excess_mask(
        jsnap, jstatic.aff_ok, jnp.asarray(rank.numpy()),
        jnp.asarray(choice), jnp.asarray(kept), jst2))
    for ops in (ka.PLAIN, ka.KERNELS):
        got = ka._spread_excess_mask(tsnap, tstatic.aff_ok, rank,
                                     torch.from_numpy(choice),
                                     torch.from_numpy(kept), tst2, dom, ops)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_spread_excess_mask_tenants_match_solo():
    """Over eight config-3 tenants under one floor: the batch's verdict,
    tenant by tenant, is that tenant's solo call."""
    B = 8
    snaps, snap = _floored(lambda b, **x: tsynth.make_cluster(
        np.random.default_rng(90 + b), 60 + 5 * b, 12 + b,
        **PAIR_MIXES["config3"], **x), B)
    cfg = EngineConfig(mode="fast")
    static = ka.precompute_static(cfg, snap, *_sat_tables(snap))
    dom = kp.sig_domains(snap)
    st = kp.pair_counts(static.sig_match, dom, snap.running, snap.pods)
    rng = np.random.default_rng(B)
    _, P = snap.pods.valid.shape
    choice = torch.from_numpy(rng.integers(0, 4, (B, P)).astype(np.int32))
    kept = torch.from_numpy(rng.random((B, P)) < 0.7) & snap.pods.valid
    st = kp.pair_commit(snap, st, static.sig_match, dom, choice, kept)
    rank = ka._rank_of(ka.pop_order(cfg, snap))
    bad = ka._spread_excess_mask(snap, static.aff_ok, rank, choice, kept, st,
                                 dom, ka.KERNELS)
    assert bad.shape == (B, P) and bad.any()
    for t in range(B):
        np.testing.assert_array_equal(
            bad[t].numpy(), ka._spread_excess_mask(
                snap.tenant(t), static.aff_ok[t], rank[t], choice[t],
                kept[t], st.tenant(t), dom[t], ka.KERNELS).numpy())


def _walk_brute(key_s, perm, T, cnt_total, g_cnt) -> np.ndarray:
    """The walk from its definition, one row at a time."""
    C, P = key_s.shape
    SN = g_cnt.shape[1] - 1
    bad = np.zeros(P, bool)
    for c in range(C):
        g = (key_s[c] + (1 << 31)) >> 32
        i = 0
        while i < P:
            j = i
            q, pm = 0, np.inf
            while j < P and g[j] == g[i]:
                if g[i] < SN:
                    p = perm[c, j]
                    q += 1
                    pm = min(pm, T[c, p])
                    if not cnt_total[c, p] - g_cnt[c, g[i]] + q <= pm:
                        bad[p] = True
                j += 1
            i = j
    return bad


@pytest.mark.parametrize("seed", range(4))
def test_walk_groups_past_a_warp(seed):
    """K13's walk on two slots of 300 sorted rows whose groups run 1, 31,
    32, 33, 45 and 70 rows from offsets that are not multiples of 32 (the
    kernel's warp steps), with non-members last: against the walk's
    definition, and slot by slot against the one-slot form."""
    rng = np.random.default_rng(seed)
    C, P, SN = 2, 300, 50
    key_s = np.empty((C, P), np.int64)
    perm = np.stack([rng.permutation(P) for _ in range(C)])
    g_cnt = np.zeros((C, SN + 1), np.int32)
    for c in range(C):
        sizes = rng.permutation([1, 31, 32, 33, 45, 70])
        gids = np.sort(rng.choice(SN, len(sizes), replace=False))
        g = np.full(P, SN)
        g[:sizes.sum()] = np.repeat(gids, sizes)
        ranks = np.sort(rng.integers(-5, 1000, P))
        key_s[c] = (g.astype(np.int64) << 32) + ranks
        np.add.at(g_cnt[c], g[g < SN], 1)
    T = rng.integers(0, 60, (C, P)).astype(np.float32)
    cnt_total = rng.integers(20, 90, (C, P)).astype(np.float32)
    want = _walk_brute(key_s, perm, T, cnt_total, g_cnt)
    args = (torch.from_numpy(key_s), torch.from_numpy(perm),
            torch.from_numpy(T), torch.from_numpy(cnt_total),
            torch.from_numpy(g_cnt))
    got = ka.excess_walk(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    one = [ka.excess_survive(*ka.excess_survive_args(*args, c))
           for c in range(C)]
    np.testing.assert_array_equal((one[0] | one[1]).numpy(), want)
