"""Preemption (PostFilter), the sequential half: the port of
`tpusched/kernels/preempt.py`'s `precompute`, `_tableau` and
`preempt_step`.

A pod with no feasible node looks for a node where evicting running
pods of lower effective priority makes it fit. The victims are sorted
once per snapshot by (node, eviction cost) (`precompute`); one
preemptor's search (`preempt_step`) is then a masked prefix scan over
that order: within each node's segment, the eligible victims' running
sums of requests, cost and PodDisruptionBudget violations. Among the
prefixes after which the pod fits, on nodes its static and pairwise
predicates allow, the search takes the lexicographic minimum of
(violations, cost), ties to the lowest node, then the shortest prefix.

Kernel K15 (`csrc/preempt.cuh`, one 1024-thread CTA) runs one search;
its standalone entry point `tpusched_preempt_step` is `preempt_step` on
CUDA tensors, and the parity scan's preemption variant (K4,
`kernels/assign.parity_scan_preempt`) runs the same device function for
each pod that fails Filter.

The f32 sums of requests and cost restart at each node's segment and
have one fixed order on every device, K15's (`segment_prefix`): each of
the 1024 threads sums its contiguous chunk of ceil(M / 1024) victims in
order, a segmented Hillis-Steele scan carries a segment across chunks.
JAX and the oracle take a prefix over all M victims and subtract its
value at the segment's start instead: at config 5's full size that sum
reaches ~1e14 bytes, and the cancellation costs ~1e7 bytes a term, so
their fits and near-equal costs depend on the order of adds (ROADMAP C5).
The capacity freed on the chosen node is the chosen victim's segment
sum, the value its fit was tested with, subtracted in one step as JAX
subtracts its `freed` row. Violation and budget counts are integers,
exact in any order.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import check, ptrs, stream_of
from tpusched_torch.qos import evict_cost_raw, victim_effective_priority
from tpusched_torch.snapshot import ClusterSnapshot

THREADS = 1024  # K15's CTA: the prefix sums chunk the victims over it


@dataclasses.dataclass
class PreemptCtx:
    """Snapshot-static victim order and costs (the running pods sorted
    by (node, cost), invalid ones last in a sentinel segment N)."""

    perm: torch.Tensor       # [M] int32 sorted position -> running pod
    node_s: torch.Tensor     # [M] int32 node of the sorted victim (N: none)
    seg_start: torch.Tensor  # [M] int32 first position of its node's segment
    cost_s: torch.Tensor     # [M] f32 eviction cost, shifted positive
    vprio_s: torch.Tensor    # [M] f32 victim effective priority
    req_s: torch.Tensor      # [M, R] f32 victim requests
    pdb_s: torch.Tensor      # [M] int32 budget of the victim (-1: none)


def precompute(cfg: EngineConfig, snap: ClusterSnapshot) -> PreemptCtx:
    """JAX `precompute`, on the snapshot's device. Its `lexsort((cost,
    node))` is two stable library sorts, by cost and then by node."""
    run = snap.running
    M = run.valid.shape[0]
    N = snap.nodes.valid.shape[0]
    dev = run.valid.device
    vprio = victim_effective_priority(cfg, run.priority, run.slack)
    raw = evict_cost_raw(cfg, run.priority, run.slack)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    mn = torch.where(run.valid, raw, inf).amin() if M else inf
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    # Shifted positive (+1 a victim): prefix costs strictly increase,
    # which also prefers fewer victims.
    cost = raw - mn + 1.0
    node_m = torch.where(run.valid & (run.node_idx >= 0), run.node_idx,
                         torch.full((), N, dtype=torch.int32, device=dev))
    # + 0.0 makes -0.0 sort with +0.0 (a CUDA radix sort orders them).
    by_cost = torch.sort(cost + 0.0, stable=True).indices
    perm = by_cost[torch.sort(node_m[by_cost], stable=True).indices]
    node_s = node_m[perm]
    idx = torch.arange(M, device=dev)
    boundary = torch.ones(M, dtype=torch.bool, device=dev)
    boundary[1:] = node_s[1:] != node_s[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
    return PreemptCtx(
        perm=perm.to(torch.int32), node_s=node_s.contiguous(),
        seg_start=seg_start.to(torch.int32), cost_s=cost[perm],
        vprio_s=vprio[perm], req_s=run.requests[perm].contiguous(),
        pdb_s=run.pdb_group[perm].contiguous())


def pdb_remaining(snap: ClusterSnapshot, evicted: torch.Tensor) -> torch.Tensor:
    """[GP] f32: each budget's disruptions allowed less the evictions
    made so far (0/1 adds, exact in any order)."""
    run = snap.running
    pdb = run.pdb_group
    gp = snap.pdb_allowed.shape[0]
    consumed = torch.zeros(gp, dtype=torch.float32, device=pdb.device)
    if gp:
        hit = evicted & (pdb >= 0) & run.valid
        consumed.index_add_(0, pdb.clamp(min=0).long(),
                            hit.to(torch.float32))
    return snap.pdb_allowed - consumed


def segment_prefix(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of [M, K] f32 along dim 0 that restarts at
    every row where `start` is set (each node's segment), in K15's
    order: 1024 chunks of ceil(M / 1024) rows, each summed in row order
    from 0.0 (again from 0.0 at a segment start); the chunk tails through
    a segmented Hillis-Steele scan (at step d a chunk adds the tail d
    back unless a segment starts in it); the rows before a chunk's first
    segment start then add the carry from the chunks before. Never an
    f32 `torch.cumsum`, whose order depends on the device."""
    M, K = x.shape
    dev = x.device
    c = max(1, -(-M // THREADS))
    pad = THREADS * c - M
    xs = torch.cat([x, torch.zeros((pad, K), dtype=x.dtype, device=dev)])
    xs = xs.reshape(THREADS, c, K)
    fs = torch.cat([start, torch.ones(pad, dtype=torch.bool, device=dev)])
    fs = fs.reshape(THREADS, c)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    acc = torch.zeros((THREADS, K), dtype=x.dtype, device=dev)
    run = []
    for k in range(c):
        acc = torch.where(fs[:, k, None], zero, acc) + xs[:, k]
        run.append(acc)
    loc = torch.stack(run, dim=1)                            # [T, c, K]
    v, f = loc[:, -1], fs.any(dim=1)
    d = 1
    while d < THREADS:
        v = torch.cat([v[:d], torch.where(f[d:, None], v[d:], v[:-d] + v[d:])])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d <<= 1
    carry = torch.cat([torch.zeros_like(v[:1]), v[:-1]])
    before = torch.cummax(fs.to(torch.int32), dim=1).values == 0
    out = torch.where(before[..., None], carry[:, None, :] + loc, loc)
    return out.reshape(THREADS * c, K)[:M]


def tableau_plain(cfg: EngineConfig, snap: ClusterSnapshot, ctx: PreemptCtx,
                  p_prio: torch.Tensor, p_req: torch.Tensor,
                  used: torch.Tensor, evicted: torch.Tensor,
                  remaining: torch.Tensor):
    """JAX `_tableau` without its per-node reductions: (elig [M],
    within [M, R + 1] f32 (each victim's segment prefix of the eligible
    victims' requests, then cost), within_viol [M] int32, fits [M],
    viol [M])."""
    M = ctx.perm.shape[0]
    N = snap.nodes.valid.shape[0]
    dev = ctx.perm.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    elig = ((ctx.node_s < N) & ~evicted[ctx.perm.long()]
            & (ctx.vprio_s + cfg.qos.preemption_margin < p_prio))
    # PDB violations: the eligible same-budget victims in the victim's
    # segment up to itself, beyond what its budget has left.
    seg = ctx.seg_start.long()
    has = elig & (ctx.pdb_s >= 0)
    pdb = ctx.pdb_s.clamp(min=0).long()
    gp = remaining.shape[0]
    viol = torch.zeros(M, dtype=torch.bool, device=dev)
    idx = torch.arange(M, device=dev)
    if gp:
        one = (torch.arange(gp, device=dev)[:, None] == pdb[None, :]) & has
        cum_g = torch.cumsum(one.to(torch.int32), dim=1)     # [GP, M]
        mine = cum_g[pdb, idx]
        off = torch.where(seg > 0, cum_g[pdb, (seg - 1).clamp(min=0)], 0)
        viol = has & ((mine - off).to(torch.float32) > remaining[pdb])
    vals = torch.cat([torch.where(elig[:, None], ctx.req_s, zero),
                      torch.where(elig, ctx.cost_s, zero)[:, None]], dim=1)
    within = segment_prefix(vals, seg == idx)                # [M, R + 1]
    cv = torch.cumsum(viol.to(torch.int32), dim=0)
    within_viol = cv - torch.where(seg > 0, cv[(seg - 1).clamp(min=0)], 0)
    node = ctx.node_s.clamp(max=N - 1).long()
    R = ctx.req_s.shape[1]
    fits = elig & ((used[node] - within[:, :R]) + p_req[None, :]
                   <= snap.nodes.allocatable[node]).all(dim=1)
    return elig, within, within_viol.to(torch.int32), fits, viol


def preempt_step_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                       ctx: PreemptCtx, p_prio: torch.Tensor,
                       p_req: torch.Tensor, allowed: torch.Tensor,
                       used: torch.Tensor, evicted: torch.Tensor):
    """One preemptor's victim search (JAX `preempt_step`): (best_n int32,
    can bool, evict_m [M] bool, freed [R] f32, the capacity its victims
    free on best_n: their segment sum, the value the fit was tested
    with). allowed [N]: the pod's static and pairwise
    feasibility before any eviction. Without a fitting prefix on an
    allowed node, best_n is 0 and can is false."""
    M = ctx.perm.shape[0]
    N = snap.nodes.valid.shape[0]
    dev = ctx.perm.device
    elig, within, wviol, fits, _ = tableau_plain(
        cfg, snap, ctx, p_prio, p_req, used, evicted,
        pdb_remaining(snap, evicted))
    R = ctx.req_s.shape[1]
    wcost = within[:, R]
    node = ctx.node_s.clamp(max=N - 1).long()
    cand = fits & (ctx.node_s < N) & allowed[node] & snap.nodes.valid[node]
    evict_m = torch.zeros(M, dtype=torch.bool, device=dev)
    freed = torch.zeros(R, dtype=torch.float32, device=dev)
    if not bool(cand.any()):
        return (torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev), evict_m,
                freed)
    big = torch.iinfo(torch.int32).max
    minv = torch.where(cand, wviol, big).amin()
    cand = cand & (wviol == minv)
    minc = torch.where(cand, wcost, float("inf")).amin()
    best_pos = int(torch.nonzero(cand & (wcost == minc))[0, 0])
    best_n = ctx.node_s[best_pos]
    sel = elig.clone()
    sel[:int(ctx.seg_start[best_pos])] = False
    sel[best_pos + 1:] = False
    evict_m[ctx.perm[sel].long()] = True
    return (best_n, torch.ones((), dtype=torch.bool, device=dev), evict_m,
            within[best_pos, :R])


def _padded(M: int) -> tuple[int, int]:
    """(chunk, Mp): K15's victims a thread and the padded length."""
    c = max(1, -(-M // THREADS))
    return c, c * THREADS


def interleave(x: torch.Tensor, fill) -> torch.Tensor:
    """K15's thread-interleaved layout of a sorted victim array: [M] ->
    [Mp], [M, R] -> [R, Mp], victim i at (i % chunk) * 1024 + i // chunk,
    so that the j-th victims of the threads' contiguous chunks sit side by
    side (coalesced loads); padding holds `fill`."""
    M = x.shape[0]
    c, Mp = _padded(M)
    pad = torch.full((Mp - M, *x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    xs = torch.cat([x, pad]).reshape(THREADS, c, *x.shape[1:])
    xs = xs.transpose(0, 1)                                  # [c, T, ...]
    if x.dim() == 2:
        return xs.permute(2, 0, 1).reshape(x.shape[1], Mp).contiguous()
    return xs.reshape(Mp).contiguous()


def deinterleave(x: torch.Tensor, M: int) -> torch.Tensor:
    """The sorted order of an [Mp] array in K15's layout."""
    c, Mp = _padded(M)
    return x.reshape(c, THREADS).T.reshape(Mp)[:M]


def _victim_args(k: str, cfg: EngineConfig, snap: ClusterSnapshot,
                 ctx: PreemptCtx) -> tuple:
    """Check the victim table and put it in K15's layout: (M, GP, its
    tensors, the margin)."""
    dev = ctx.perm.device
    M, R = ctx.req_s.shape
    N = snap.nodes.valid.shape[0]
    for t in (ctx.perm, ctx.node_s, ctx.seg_start, ctx.pdb_s):
        check(k, dev, t, torch.int32, (M,))
    for t in (ctx.cost_s, ctx.vprio_s):
        check(k, dev, t, torch.float32, (M,))
    check(k, dev, ctx.req_s, torch.float32, (M, R))
    return (M, snap.pdb_allowed.shape[0], interleave(ctx.perm, 0),
            interleave(ctx.node_s, N),
            interleave(ctx.seg_start, 0), interleave(ctx.cost_s, 0.0),
            interleave(ctx.vprio_s, 0.0), interleave(ctx.req_s, 0.0),
            interleave(ctx.pdb_s, -1), float(cfg.qos.preemption_margin))


def victim_scratch(M: int, R: int, dev: torch.device) -> tuple:
    """K15's device scratch, in its layout (`deinterleave` reads it in
    sorted order): eligibility [Mp] bytes, the [R + 1, Mp] f32 segment
    sums (requests, then cost) and the [Mp] int32 segment sums of the
    violation flags."""
    Mp = _padded(M)[1]
    return (torch.empty(Mp, dtype=torch.uint8, device=dev),
            torch.empty((R + 1) * Mp, dtype=torch.float32, device=dev),
            torch.empty(Mp, dtype=torch.int32, device=dev))


def preempt_step(cfg: EngineConfig, snap: ClusterSnapshot, ctx: PreemptCtx,
                 p_prio: torch.Tensor, p_req: torch.Tensor,
                 allowed: torch.Tensor, used: torch.Tensor,
                 evicted: torch.Tensor, scratch: tuple | None = None):
    """Kernel K15 on CUDA tensors (one CTA, one preemptor), the plain
    version on CPU tensors. scratch: `victim_scratch`'s buffers, for a
    caller that reads the tableau K15 leaves there (the eligibility
    flags, and third each victim's violation count in its segment)."""
    dev = ctx.perm.device
    if dev.type == "cpu":
        return preempt_step_plain(cfg, snap, ctx, p_prio, p_req, allowed,
                                  used, evicted)
    k = "preempt_step"
    vic = _victim_args(k, cfg, snap, ctx)
    M = vic[0]
    N, R = used.shape
    alloc = snap.nodes.allocatable
    check(k, dev, alloc, torch.float32, (N, R))
    check(k, dev, used, torch.float32, (N, R))
    check(k, dev, allowed, torch.bool, (N,))
    check(k, dev, snap.nodes.valid, torch.bool, (N,))
    check(k, dev, evicted, torch.bool, (M,))
    prio = p_prio.to(torch.float32).reshape(1).contiguous()
    req = p_req.to(torch.float32).contiguous()
    check(k, dev, req, torch.float32, (R,))
    remaining = pdb_remaining(snap, evicted).contiguous()
    best = torch.zeros(2, dtype=torch.int32, device=dev)
    evict_m = torch.zeros(M, dtype=torch.bool, device=dev)
    freed = torch.zeros(R, dtype=torch.float32, device=dev)
    if M == 0:
        return best[0], best[1] > 0, evict_m, freed
    scratch = scratch or victim_scratch(M, R, dev)
    _build.launch("tpusched_preempt_step", N, R, *ptrs(
        (*vic, prio, req, allowed, snap.nodes.valid, used, alloc, evicted,
         remaining, *scratch, best, evict_m, freed)), stream_of(dev))
    preempt_step.launches += 1
    return best[0], best[1] > 0, evict_m, freed


preempt_step.launches = 0
