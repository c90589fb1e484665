"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small shapes. Exact: every kernel is built with --fmad=false and
follows its plain version's order of f32 operations (K7's column sum in
ascending rows, K8's Hillis-Steele prefix and rank-ordered adds; K10's
atomic adds of +-1.0 stay exact integers in any order; K12-K14 count,
compare and take minima; K15's victim prefix sums follow its plain
version's chunked Hillis-Steele order).

These tests need a CUDA device and nvcc: without a card each one skips.
The file imports nothing of JAX, so that it runs where the port runs:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's
tests.) `chip_smoke.py` makes the same comparisons at full size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpusched_torch import Engine, EngineConfig
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import (
    _pack_solve,
    _sat_tables,
    score_core,
    score_topk_core,
    solve_core,
)
from tpusched_torch.kernels import assign as ka
from tpusched_torch.kernels import pairwise as kp
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.snapshot import SnapshotBuilder

# Pairwise mixes: config 3, and config 3 with running anti-affinity
# holders, three namespaces and key-less nodes.
PAIR_MIXES = {
    "config3": dict(spread_frac=0.5, interpod_frac=0.5),
    "anti_ns_keyless": dict(spread_frac=0.5, interpod_frac=0.5,
                            run_anti_frac=0.2, namespace_count=3,
                            keyless_node_frac=0.1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _snap(cuda, seed=0, pods=96, nodes=24, **kw):
    kw = dict(dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.1, with_qos=True), **kw)
    snap, _ = tsynth.make_cluster(np.random.default_rng(seed), pods, nodes,
                                  **kw)
    return snap.to(cuda)


def _equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _static(cfg, snap):
    return ka.precompute_static(cfg, snap, _sat_tables(snap)[0])


def test_k1_to_k3_equal_plain(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    args = (snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
            snap.nodes.label_nums)
    _equal([ka.atom_sat(*args)], [ka.atom_sat_plain(*args)])
    sat = _sat_tables(snap)[0]
    cells = ka._tableau_cells(snap, snap.pods, snap.nodes, sat)
    _equal(cells, ka._tableau_cells_plain(snap, snap.pods, snap.nodes, sat))
    static = _static(cfg, snap)
    w = (cells[2], cells[3], snap.nodes.valid, static.w_lr, static.w_ba)
    _equal([ka.finalize_score(*w)], [ka.finalize_score_plain(*w)])


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_equal_plain(cuda, tie_break):
    snap = _snap(cuda)
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    _equal(ka.parity_scan(cfg, snap, static, order),
           ka.parity_scan_plain(cfg, snap, static, order))


@pytest.mark.parametrize("masked", [False, True])
def test_k5_equal_plain_and_view(cuda, masked):
    snap = _snap(cuda)
    static = _static(EngineConfig(), snap)
    used = snap.nodes.used + 0.3 * snap.nodes.allocatable
    args = (snap.nodes.allocatable, used, snap.pods.requests, static.mask,
            static.score, static.w_lr, static.w_ba, static.w_ts, static.rw)
    _equal(ka.cycle(*args, masked=masked), ka.cycle_plain(*args,
                                                          masked=masked))
    rows = torch.arange(1, snap.pods.valid.shape[0], 3, dtype=torch.int32,
                        device=cuda)
    pend = torch.arange(rows.shape[0], device=cuda) % 2 == 0
    view = ka.cycle(*args, rows=rows, pending=pend, masked=masked)
    _equal(view, ka.cycle_plain(*args, rows=rows, pending=pend,
                                masked=masked))
    # Reading rows in place equals running on gathered copies.
    r = rows.long()
    gathered = (snap.nodes.allocatable, used, snap.pods.requests[r].clone(),
                static.mask[r].clone(), static.score[r].clone(),
                static.w_lr[r].clone(), static.w_ba[r].clone(),
                static.w_ts[r].clone(), static.rw)
    _equal(view, ka.cycle(*gathered, pending=pend, masked=masked))


@pytest.mark.parametrize("K", [1, 3, 8, 16])
def test_k6_equal_plain(cuda, K):
    rng = np.random.default_rng(K)
    m = rng.integers(0, 4, size=(40, 300)).astype(np.float32) * 25.0
    m[rng.random(m.shape) < 0.3] = -np.inf
    m[5] = -np.inf
    m = torch.from_numpy(m).to(cuda)
    ids = torch.arange(40, dtype=torch.int32, device=cuda).flip(0)
    _equal(ka.row_topk(m, K), ka.row_topk_plain(m, K))
    _equal(ka.row_topk(m, K, True, 99, ids),
           ka.row_topk_plain(m, K, True, 99, ids))


def test_k7_equal_plain(cuda):
    snap = _snap(cuda)
    static = _static(EngineConfig(), snap)
    f, m = ka.cycle_plain(snap.nodes.allocatable, snap.nodes.used,
                          snap.pods.requests, static.mask, static.score,
                          static.w_lr, static.w_ba, static.w_ts, static.rw,
                          masked=True)
    allowed = f.any(dim=1)
    _equal([ka.desirability(f, m, allowed)],
           [ka.desirability_plain(f, m, allowed)])


def test_k8_equal_plain(cuda):
    """Random (node, rank)-sorted candidates over a tight cluster, so
    some rows fit, some do not and some are prefix-blocked."""
    rng = np.random.default_rng(3)
    P, N, R = 500, 37, 3
    cand = rng.integers(0, N + 1, size=P)            # N = inactive
    rank = rng.permutation(P)
    perm = np.lexsort((rank, cand)).astype(np.int32)
    cand_s = cand[perm].astype(np.int32)
    req = rng.integers(1, 9, size=(P, R)).astype(np.float32) * 0.37
    alloc = np.full((N, R), 12.0, np.float32)
    used = rng.uniform(0, 6, size=(N, R)).astype(np.float32)
    choice = np.full(P, -1, np.int32)
    ptr = rng.integers(0, 3, size=P).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda)
         for a in (perm, cand_s, req, alloc, used, choice, ptr)]
    got = ka.prefix_commit(*t, 9)
    want = ka.prefix_commit_plain(*t, 9)
    _equal(got, want)
    assert (got[1] >= 0).any() and (got[2] == 0).any()


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_solve_equal_plain(cuda, tie_break):
    """The whole fast solve through the kernels equals the same solve
    through the plain versions on the same CUDA tensors, with both the
    direct rounds and (cap 16) the tranche path."""
    snap = _snap(cuda, pods=120, nodes=20, initial_utilization=0.5)
    cfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=1)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    P, N = static.mask.shape
    rank = torch.zeros(P, dtype=torch.int32, device=cuda)
    rank[order] = torch.arange(P, dtype=torch.int32, device=cuda)
    runs = [ka._solve_rounds_nosig(cfg, snap, static, rank, order,
                                   2 * P + 8, ka._fallback_depth(N), cap=16,
                                   ops=ops) for ops in (ka.KERNELS, ka.PLAIN)]
    _equal(runs[0][:4], runs[1][:4])
    assert runs[0][4] == runs[1][4]


def test_score_equal_plain(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    _equal(score_core(cfg, snap), score_core(cfg, snap, ops=ka.PLAIN))
    _equal(score_topk_core(cfg, snap, 8),
           score_topk_core(cfg, snap, 8, ops=ka.PLAIN))


def test_engine_runs_on_the_card(cuda):
    eng = Engine(EngineConfig(mode="fast"))
    try:
        assert eng.device.type == "cuda"
        snap, _ = tsynth.make_cluster(np.random.default_rng(0), 40, 12)
        res = eng.solve(snap)
        assert (res.assignment >= 0).sum() > 0 and res.host_reads > 0
    finally:
        eng.close()


def _pair_snap(cuda, mix, pods=120, nodes=24):
    snap, _ = tsynth.make_cluster(np.random.default_rng(43), pods, nodes,
                                  **PAIR_MIXES[mix])
    return snap.to(cuda)


def _pair_setup(cfg, snap):
    static = ka.precompute_static(cfg, snap, *_sat_tables(snap))
    dom = kp.sig_domains(snap)
    return static, dom, kp.pair_counts(static.sig_match, dom, snap.running,
                                       snap.pods)


def _state(st):
    return [st.counts, st.anti, st.match_tot]


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k9_to_k11_equal_plain(cuda, mix):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig()
    _, member_sat_t = _sat_tables(snap)
    ns = kp.merge_members(snap.running.namespace, snap.pods.namespace)
    _equal([kp.sig_match(member_sat_t, snap.sigs, ns)],
           [kp.sig_match_plain(member_sat_t, snap.sigs, ns)])
    static, dom, st = _pair_setup(cfg, snap)
    args = (static.sig_match, dom, snap.running, snap.pods)
    _equal(_state(st), _state(kp.pair_counts_plain(*args)))
    asg = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 24, size=snap.pods.valid.shape[0]).astype(np.int32)).to(cuda)
    _equal(_state(kp.pair_counts(*args, assigned=asg)),
           _state(kp.pair_counts_plain(*args, assigned=asg)))
    b = (snap, st, static.aff_ok, static.sig_match, dom)
    _equal(kp.pairwise_batch(*b), kp.pairwise_batch_plain(*b))


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_pair_equal_plain(cuda, mix, tie_break):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static, dom, st = _pair_setup(cfg, snap)
    order = ka.pop_order(cfg, snap)
    got = ka.parity_scan_pair(cfg, snap, static, order, st, dom)
    want = ka.parity_scan_pair_plain(cfg, snap, static, order, st, dom)
    _equal(got[:3], want[:3])
    _equal(_state(got[3]), _state(want[3]))
    # The final state is K10's recount at the final assignment.
    _equal(_state(got[3]), _state(kp.pair_counts(
        static.sig_match, dom, snap.running, snap.pods, assigned=got[0])))


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_pairwise_solve_and_score_equal_plain(cuda, mix):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig()
    assert torch.equal(_pack_solve(solve_core(cfg, snap)),
                       _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN)))
    _equal(score_core(cfg, snap), score_core(cfg, snap, ops=ka.PLAIN))
    _equal(score_topk_core(cfg, snap, 8),
           score_topk_core(cfg, snap, 8, ops=ka.PLAIN))


def _round_inputs(cfg, snap, cuda):
    """A fast pairwise round's inputs: the state with a third of the pods
    committed at random nodes, every valid pod pending."""
    static, dom, st = _pair_setup(cfg, snap)
    rng = np.random.default_rng(2)
    P = snap.pods.valid.shape[0]
    choice = torch.from_numpy(rng.integers(0, 24, size=P).astype(
        np.int32)).to(cuda)
    kept = (torch.from_numpy(rng.random(P) < 0.6).to(cuda)
            & snap.pods.valid)
    st = kp.pair_commit_plain(snap, st, static.sig_match, dom, choice, kept)
    order = ka.pop_order(cfg, snap)
    rank = torch.zeros(P, dtype=torch.int32, device=cuda)
    rank[order] = torch.arange(P, dtype=torch.int32, device=cuda)
    return static, dom, st, choice, kept, rank


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k12_to_k14_and_entry_points_equal_plain(cuda, mix):
    """K12-K14 and the fast pairwise entry points of K5, K7, K8, K10 and
    K11 against their plain versions."""
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig(mode="fast")
    static, dom, st, choice, kept, rank = _round_inputs(cfg, snap, cuda)
    used = snap.nodes.used
    pend = snap.pods.valid
    kw = dict(pair_st=st, pending=pend, return_relaxed=True)
    got = ka.batched_cycle(cfg, snap, static, used, ops=ka.KERNELS, **kw)
    want = ka.batched_cycle(cfg, snap, static, used, ops=ka.PLAIN, **kw)
    _equal(got, want)
    feasible, score, relaxed = got
    masked = torch.where(feasible, score, float("-inf"))
    allowed = feasible.any(dim=1)
    _equal([ka.desirability(feasible, masked, allowed, fixed=True)],
           [ka.desirability_plain(feasible, masked, allowed, fixed=True)])
    K = ka._fallback_depth(snap.nodes.valid.shape[0])
    wf = (snap, st, used, relaxed, score, relaxed.any(dim=1), rank, K, dom)
    deal = ka._spread_waterfill_deal(*wf, ka.KERNELS)
    _equal(deal, ka._spread_waterfill_deal(*wf, ka.PLAIN))
    assert deal[2].any()
    for sign in (1.0, -1.0):
        a = (snap, st, static.sig_match, dom, choice, kept, sign)
        _equal(_state(kp.pair_commit(*a)), _state(kp.pair_commit_plain(*a)))
        n = (used, choice, kept, snap.pods.requests, rank, sign)
        _equal([ka.node_add(*n)], [ka.node_add_plain(*n)])
    esn = torch.where(kept, choice, -1)
    ia = (snap, st, static.sig_match, dom, choice, esn)
    _equal([kp.ia_ok_at_choice(*ia)], [kp.ia_ok_at_choice_plain(*ia)])
    ex = (snap, static.aff_ok, rank, choice, kept, st, dom)
    _equal([ka._spread_excess_mask(*ex, ka.KERNELS)],
           [ka._spread_excess_mask(*ex, ka.PLAIN)])


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_pairwise_solve_equal_plain(cuda, mix, tie_break):
    """A fast solve with signatures equals its plain-version solve (host
    reads included), and compacted rounds equal full-width ones."""
    snap = _pair_snap(cuda, mix)
    outs = []
    for cap, ops in ((-1, ka.KERNELS), (-1, ka.PLAIN), (8, ka.KERNELS),
                     (0, ka.KERNELS)):
        cfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=5,
                           compact_cap=cap)
        stats = ka.RoundStats()
        outs.append((_pack_solve(solve_core(cfg, snap, ops=ops,
                                            stats=stats)),
                     stats.host_reads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert torch.equal(outs[2][0], outs[3][0])


# -- gangs and preemption ---------------------------------------------------


def _victim_case(case):
    """Victim tables for K15: ties (identical victims on identical
    nodes), all-inf (no victim is eligible), exhausted budgets (every
    victim under a budget with nothing left) and one huge segment (one
    node holding more victims than the CTA has threads, so that its
    segment spans many threads' chunks). (snapshot, preemptor priority,
    requests [cpu, memory, pods])."""
    b = SnapshotBuilder(EngineConfig(preemption=True))
    mem = 64 << 30
    if case == "huge_segment":
        b.add_node("big", {"cpu": 3000 * 10, "memory": mem, "pods": 5000})
        for i in range(3000):
            b.add_running_pod("big", {"cpu": 10, "memory": 1 << 20},
                              priority=i % 7, slack=(i % 13) / 40.0,
                              pdb_group=f"b{i % 3}" if i % 4 == 0 else None,
                              pdb_disruptions_allowed=i % 3)
        return b.build()[0], 500.0, [400.0, 1 << 28, 1.0]
    for n in range(6):
        b.add_node(f"n{n}", {"cpu": 4000, "memory": mem})
        for j in range(4):
            kw = {}
            if case == "exhausted_budgets":
                kw = dict(pdb_group=f"g{(n + j) % 3}",
                          pdb_disruptions_allowed=0)
            prio, slack = ((10.0, 0.1) if case == "ties"
                           else (10.0 + j, 0.05 * j))
            b.add_running_pod(f"n{n}", {"cpu": 1000, "memory": 1 << 30},
                              priority=prio, slack=slack, **kw)
    p_prio = 1.0 if case == "all_inf" else 500.0
    return b.build()[0], p_prio, [2500.0, float(1 << 30), 1.0]


@pytest.mark.parametrize("case", ["ties", "all_inf", "exhausted_budgets",
                                  "huge_segment"])
def test_k15_equal_plain(cuda, case):
    snap, p_prio, req = _victim_case(case)
    snap = snap.to(cuda)
    cfg = EngineConfig(preemption=True)
    ctx = kpre.precompute(cfg, snap)
    M = ctx.perm.shape[0]
    N = snap.nodes.valid.shape[0]
    rng = np.random.default_rng(0)
    req_t = torch.tensor(req, dtype=torch.float32, device=cuda)
    prio = torch.tensor(p_prio, dtype=torch.float32, device=cuda)
    found = 0
    for trial in range(6):
        ev = torch.from_numpy(rng.random(M) < 0.15 * (trial % 3)).to(cuda)
        ev &= snap.running.valid
        allowed = torch.from_numpy(rng.random(N) < 0.9).to(cuda)
        allowed[0] = True
        used = snap.nodes.used * torch.from_numpy(rng.uniform(
            0.9, 1.0, size=(N, 1)).astype(np.float32)).to(cuda)
        a = (cfg, snap, ctx, prio, req_t, allowed, used, ev)
        got, want = kpre.preempt_step(*a), kpre.preempt_step_plain(*a)
        _equal(got, want)
        found += bool(got[1])
    assert found == 0 if case == "all_inf" else found > 0


def _preempt_snap(cuda, pair, seed=45):
    kw = dict(spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2) \
        if pair else {}
    snap, _ = tsynth.config5_preemption(np.random.default_rng(seed), 96, 16,
                                        **kw)
    return snap.to(cuda)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_preempt_equal_plain(cuda, pair, tie_break):
    """K4's preemption variants against their plain versions: assignment,
    chosen, used, evictions (and the final pair state with signatures,
    which is K10's recount at the assignment less the evicted pods)."""
    snap = _preempt_snap(cuda, pair)
    cfg = EngineConfig(preemption=True, tie_break=tie_break, tie_seed=3)
    ctx = kpre.precompute(cfg, snap)
    order = ka.pop_order(cfg, snap)
    if not pair:
        static = _static(cfg, snap)
        got = ka.parity_scan_preempt(cfg, snap, static, order, ctx)
        want = ka.parity_scan_preempt_plain(cfg, snap, static, order, ctx)
        _equal(got, want)
        assert got[3].any()
        return
    static, dom, st = _pair_setup(cfg, snap)
    assert dom.shape[0] > 0
    got = ka.parity_scan_pair_preempt(cfg, snap, static, order, st, dom, ctx)
    want = ka.parity_scan_pair_preempt_plain(cfg, snap, static, order, st,
                                             dom, ctx)
    _equal(got[:3], want[:3])
    _equal(_state(got[3]), _state(want[3]))
    _equal([got[4]], [want[4]])
    assert got[4].any()
    rec = kp.pair_counts(static.sig_match, dom, snap.running, snap.pods,
                         assigned=got[0])
    left = kp.pair_state_evict(snap, rec, static.sig_match, dom, got[4])
    _equal(_state(got[3]), _state(left))


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("pair", [False, True])
def test_gang_solve_equal_plain(cuda, mode, pair):
    """Gang snapshots through the four solve paths (K4 and its pairwise
    variant, fast rounds with and without signatures) with the gang gate
    (K8's node_add and K10's pair_commit, sign -1) equal their plain
    solves, and no group is left partial."""
    kw = dict(spread_frac=0.4, interpod_frac=0.4) if pair else {}
    snap, _ = tsynth.config4_gangs(np.random.default_rng(44), n_groups=24,
                                   gang_size=4, n_nodes=10, **kw)
    snap = snap.to(cuda)
    cfg = EngineConfig(mode=mode)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)
    res = Engine.unpack(snap, got.cpu().numpy())
    group = snap.pods.group.cpu().numpy()
    gmin = snap.group_min_member.cpu().numpy()
    for g in range(gmin.shape[0]):
        n = int(((group == g) & (res.assignment >= 0)).sum())
        assert n == 0 or n >= gmin[g]
    assert ((group >= 0) & (res.assignment < 0)).any()


@pytest.mark.parametrize("pair", [False, True])
def test_preempt_solve_equal_plain(cuda, pair):
    snap = _preempt_snap(cuda, pair, seed=7)
    cfg = EngineConfig(preemption=True)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)


# -- the fast preemption auction: K16-K18 and K6 at K = 256 -------------------


def _auction_args(cuda, P, N, seed=45, C=None, pair=False):
    """A config-5 snapshot on the card, its node-major victim table and a
    random mid-solve auction state: (cfg, snap, ctx, evicted, used,
    bidders' rows, priorities, requests, plain claimants, their nodes,
    ranks)."""
    kw = dict(spread_frac=0.3, interpod_frac=0.3) if pair else {}
    snap, _ = tsynth.config5_preemption(np.random.default_rng(seed), P, N,
                                        **kw)
    snap = snap.to(cuda)
    cfg = EngineConfig(mode="fast", preemption=True)
    ctx = kpre.precompute_nv(cfg, snap, ka._PREEMPT_VICTIM_CAP)
    M = snap.running.valid.shape[0]
    Pb, Nb = snap.pods.valid.shape[0], snap.nodes.valid.shape[0]
    C = C or min(Pb, ka._PREEMPT_BATCH)
    g = torch.Generator(device="cpu").manual_seed(seed)
    ev = (torch.rand(M, generator=g) < 0.1).to(cuda) & snap.running.valid
    used = snap.nodes.used * (0.95 + 0.1 * torch.rand(Nb, 1, generator=g)).to(
        cuda)
    rows = torch.randperm(Pb, generator=g)[:C].to(torch.int32).to(cuda)
    prio = ka.effective_priority(cfg, snap.pods.base_priority,
                                 snap.pods.slo_target,
                                 snap.pods.observed_avail)[rows.long()]
    req = snap.pods.requests[rows.long()].contiguous()
    can_plain = (torch.rand(C, generator=g) < 0.1).to(cuda)
    n_plain = torch.randint(0, Nb, (C,), generator=g).to(torch.int32).to(cuda)
    rank = torch.randperm(C, generator=g).to(torch.int32).to(cuda)
    return cfg, snap, ctx, ev, used, rows, prio, req, can_plain, n_plain, rank


@pytest.mark.parametrize("size", ["small", "full"])
def test_k16_to_k18_equal_plain(cuda, size):
    """Each auction kernel against its plain version on the same CUDA
    tensors, exactly, on the arguments the auction gives it: K17's
    auction_ok, K16 on the thresholds of the active bidders, K17's
    ranking, K6 at K = 256 on the bids, K18 on K6's candidates; at a small
    size and at config 5's 10 000 x 5 000 (C = 1 024 bidders)."""
    P, N = (96, 16) if size == "small" else (10000, 5000)
    (cfg, snap, ctx, ev, used, rows, prio, req, can_plain, n_plain,
     rank) = _auction_args(cuda, P, N)
    C = rows.shape[0]
    Nb = snap.nodes.valid.shape[0]
    pre = ~can_plain
    mask = ka.precompute_static(cfg, snap, _sat_tables(snap)[0]).mask
    got_ok = kpre.auction_ok(mask, rows, None, pre, snap.nodes.valid)
    want_ok = kpre.auction_ok_plain(mask, rows, None, pre, snap.nodes.valid)
    _equal(got_ok, want_ok)
    pair_ok = torch.rand(C, Nb, device=cuda) < 0.8
    _equal(kpre.auction_ok(mask[rows.long()].contiguous(), None, pair_ok,
                           pre, snap.nodes.valid),
           kpre.auction_ok_plain(mask[rows.long()], None, pair_ok, pre,
                                 snap.nodes.valid))
    ok, any_ok = got_ok
    thr = kpre.prio_thresholds(prio, any_ok & pre)
    lanes = torch.cat([thr, torch.full((1,), float("inf"), device=cuda)])
    rem = kpre.pdb_remaining(snap, ev).contiguous()
    tabs = kpre.auction_tables(ctx, ev, lanes, rem, 0.0)
    _equal(tabs, kpre.auction_tables_plain(ctx, ev, lanes, rem, 0.0))
    lane = kpre.bucket_of(thr, prio)
    args = (*tabs, lane, ok, used, snap.nodes.allocatable, req)
    bid, could = kpre.auction_rank(*args)
    _equal((bid, could), kpre.auction_rank_plain(*args))
    assert torch.isfinite(bid).any()
    K = min(256, Nb)
    topv, topi, _ = ka.row_topk(bid, K)
    _equal((topv, topi), ka.row_topk_plain(bid, K)[:2])
    cargs = (topv, topi, can_plain, n_plain, rank, ctx, ev, prio, req,
             used, snap.nodes.allocatable, could, 0.0,
             snap.pdb_allowed.shape[0])
    got = kpre.auction_claim(*cargs)
    _equal(got, kpre.auction_claim_plain(*cargs))
    assert got[2].any()


@pytest.mark.parametrize("N", [300, 5120])
def test_k6_k256_equal_plain(cuda, N):
    """K6 at the auction's K = 256 on a bid-like block (negated costs
    with ties, -inf where no bid) against its plain version, exactly."""
    g = torch.Generator(device="cpu").manual_seed(N)
    m = -torch.randint(1, 50, (64, N), generator=g).to(torch.float32)
    m[torch.rand(64, N, generator=g) < 0.5] = float("-inf")
    m[:2] = float("-inf")
    m = m.to(cuda)
    _equal(ka.row_topk(m, 256)[:2], ka.row_topk_plain(m, 256)[:2])


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_preempt_solve_equal_plain(cuda, pair, tie_break):
    """A fast solve with preemption (the auction rounds; with signatures
    the pairwise-involved claimants and the validation fixpoint) equals
    its plain solve on the same CUDA tensors, evictions and host reads
    included, and evicts."""
    snap = _preempt_snap(cuda, pair, seed=9)
    cfg = EngineConfig(mode="fast", preemption=True, tie_break=tie_break,
                       tie_seed=5)
    s1, s2 = ka.RoundStats(), ka.RoundStats()
    got = _pack_solve(solve_core(cfg, snap, stats=s1))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN, stats=s2))
    assert torch.equal(got, want)
    assert s1.host_reads == s2.host_reads
    res = Engine.unpack(snap, got.cpu().numpy())
    assert res.evicted.any()
