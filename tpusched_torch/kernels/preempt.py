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

Kernel K15 (`csrc/preempt.cuh`, one 1024-thread CTA, a thread a node)
runs one search; its standalone entry point `tpusched_preempt_step` is
`preempt_step` on CUDA tensors, and the parity scan's preemption variant
(K4, `kernels/assign.parity_scan_preempt`) runs the same device function
for each pod that fails Filter. `precompute` lays the victims out for
it node-major: the node offsets [N + 1] and each node's first V victims
in [V, N] planes (a warp taking 32 consecutive nodes reads its j-th
victims coalesced); a longer segment's tail is read in the sorted order.

The f32 sums of requests and cost restart at each node's segment and
run left to right from 0.0 in blocks of 16 rows, the block totals added
left to right (`segment_prefix`): up to 16 victims a node that is
`vprefix`'s order, and a long segment's error stays a few dozen
roundings. JAX and the oracle take a prefix over all M victims and
subtract its value at the segment's start instead: at config 5's full size that sum reaches ~1e14 bytes, and the cancellation
costs ~1e7 bytes a term, so their fits and near-equal costs depend on
the order of adds (ROADMAP C5). The capacity freed on the chosen node is
the chosen victim's segment sum, the value its fit was tested with,
subtracted in one step as JAX subtracts its `freed` row. Violation and
budget counts are integers, exact in any order.

The fast mode's half is the batched preemption auction
(`preempt_auction`, JAX's of the same name) over the node-major victim
table (`precompute_nv`: each node's first V victims by cost, [N, V]).
Three kernels carry it, each with a plain twin:
  * K16 `auction_tables`: per priority lane (quantile buckets of the
    active bidders' priorities, and the optimistic lane at +inf) and per
    node, the V-long prefixes of the eligible victims' requests, cost and
    PDB violations;
  * K17 `auction_rank` (after its entry point `auction_ok`, each
    bidder's allowed nodes): per (bidder, node) the first prefix that
    frees the bidder's demand, the bidder's lane or the optimistic one,
    and the lexicographic (violations, cost) row ranking as bids; K6
    (`assign.row_topk`) then keeps each bidder's 256 best nodes;
  * K18 `auction_claim`: the claim iterations that deal bidders distinct
    nodes (integer work over a thread-block cluster a tenant, a warp a
    bidder), then the exact [C, V] validation of each claim on its node.
Every V-long f32 prefix is summed from 0.0 left to right (JAX leaves
the order of its cumsums to XLA), and the capacity a kept prefix frees
is that prefix's own sum, the value its fit was tested with.

Tenant axis (tenants.solve_many, JAX's vmap of the same functions):
every function here but K15's standalone `preempt_step` also takes a
leading [B] axis on the snapshot and the state. Each tenant sorts its
own victims and gets its own offsets, planes (V shared) and budgets;
the auction's thresholds are each tenant's own
quantiles; K16 and K17 launch once over the B tenants' lanes and rows,
K18 with one cluster a tenant. The plain versions go tenant by tenant.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import check, per_tenant, ptrs, stream_of
from tpusched_torch.qos import evict_cost_raw, victim_effective_priority
from tpusched_torch.snapshot import ClusterSnapshot, _Tree

PLANE_CAP = 16  # K15's planes hold each node's first min(16, M) victims
SEG_BLOCK = 16  # rows a block of K15's segment sums (PRE_BLOCK)


@dataclasses.dataclass
class PreemptCtx(_Tree):
    """Snapshot-static victim order and costs (the running pods sorted
    by (node, cost), invalid ones last in a sentinel segment N), and the
    same victims node-major for K15: the offsets of the nodes' segments
    and the planes, victim j < V of node n at [j, n] (V = min(PLANE_CAP,
    M)): its (priority, cost) as f32 bits, budget and running pod in one
    16-byte record (one load), its requests in [R, V, N]; pads hold
    vprio +inf, cost 0, pdb -1, perm 0, requests 0. A tenant batch gives
    every field a leading [B] axis."""

    perm: torch.Tensor       # [M] int32 sorted position -> running pod
    node_s: torch.Tensor     # [M] int32 node of the sorted victim (N: none)
    seg_start: torch.Tensor  # [M] int32 first position of its node's segment
    cost_s: torch.Tensor     # [M] f32 eviction cost, shifted positive
    vprio_s: torch.Tensor    # [M] f32 victim effective priority
    req_s: torch.Tensor      # [M, R] f32 victim requests
    pdb_s: torch.Tensor      # [M] int32 budget of the victim (-1: none)
    off: torch.Tensor        # [N + 1] int32 first position of node n's segment
    pl_vic: torch.Tensor     # [V, N, 4] int32 (vprio, cost bits, pdb, perm)
    pl_req: torch.Tensor     # [R, V, N] f32


def _victim_order(cfg: EngineConfig, snap: ClusterSnapshot):
    """The running pods in (node, cost) order, JAX's `lexsort((cost,
    node))` as two stable library sorts, by cost and then by node:
    (cost [M] shifted positive, vprio [M], perm [M] int64, node_s [M]
    int32 with N for no node, seg_start [M] int64); a tenant batch sorts
    each tenant's [M] row on its own ([B, M] each)."""
    run = snap.running
    M = run.valid.shape[-1]
    N = snap.nodes.valid.shape[-1]
    dev = run.valid.device
    vprio = victim_effective_priority(cfg, run.priority, run.slack)
    raw = evict_cost_raw(cfg, run.priority, run.slack)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    mn = (torch.where(run.valid, raw, inf).amin(dim=-1, keepdim=True) if M
          else inf)
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    # Shifted positive (+1 a victim): prefix costs strictly increase,
    # which also prefers fewer victims.
    cost = raw - mn + 1.0
    node_m = torch.where(run.valid & (run.node_idx >= 0), run.node_idx,
                         torch.full((), N, dtype=torch.int32, device=dev))
    # + 0.0 makes -0.0 sort with +0.0 (a CUDA radix sort orders them).
    by_cost = torch.sort(cost + 0.0, dim=-1, stable=True).indices
    perm = by_cost.gather(-1, torch.sort(node_m.gather(-1, by_cost), dim=-1,
                                         stable=True).indices)
    node_s = node_m.gather(-1, perm)
    idx = torch.arange(M, device=dev)
    boundary = torch.ones(node_s.shape, dtype=torch.bool, device=dev)
    boundary[..., 1:] = node_s[..., 1:] != node_s[..., :-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), dim=-1).values
    return cost, vprio, perm, node_s, seg_start


def precompute(cfg: EngineConfig, snap: ClusterSnapshot) -> PreemptCtx:
    """JAX `precompute`, on the snapshot's device (per tenant for a
    batch), with K15's node offsets and planes beside it."""
    run = snap.running
    M = run.valid.shape[-1]
    N = snap.nodes.valid.shape[-1]
    dev = run.valid.device
    cost, vprio, perm, node_s, seg_start = _victim_order(cfg, snap)
    R = run.requests.shape[-1]
    cost_s, vprio_s = cost.gather(-1, perm), vprio.gather(-1, perm)
    req_s = run.requests.gather(
        -2, perm[..., None].expand(*perm.shape, R)).contiguous()
    pdb_s = run.pdb_group.gather(-1, perm).contiguous()
    perm32 = perm.to(torch.int32)
    nodes = torch.arange(N + 1, dtype=torch.int32, device=dev)
    off = torch.searchsorted(node_s.contiguous(),
                             nodes.expand(*node_s.shape[:-1], N + 1)
                             .contiguous()).to(torch.int32)
    # Victim j of node n at plane cell j * N + n; the rest (past V, on no
    # node) at the dropped cell V * N.
    V = max(1, min(PLANE_CAP, M))
    pos = torch.arange(M, device=dev) - seg_start
    cell = torch.where((node_s < N) & (pos < V), pos * N + node_s, V * N)
    lead = cell.shape[:-1]

    def plane(x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        """x [.., M, k] in the sorted order -> [.., V, N, k], pad [k]
        where no victim lies."""
        k = x.shape[-1]
        out = pad.to(dev).expand(*lead, V * N + 1, k).clone()
        out.scatter_(len(lead), cell[..., None].expand(x.shape), x)
        return out.narrow(len(lead), 0, V * N).reshape(*lead, V, N, k)

    bits = lambda t: t.view(torch.int32)
    rec = torch.stack([bits(vprio_s), bits(cost_s), pdb_s, perm32], dim=-1)
    pad_rec = torch.tensor([float("inf"), 0.0]).view(torch.int32)
    pad_rec = torch.cat([pad_rec, torch.tensor([-1, 0], dtype=torch.int32)])
    return PreemptCtx(
        perm=perm32, node_s=node_s.contiguous(),
        seg_start=seg_start.to(torch.int32), cost_s=cost_s,
        vprio_s=vprio_s, req_s=req_s, pdb_s=pdb_s, off=off,
        pl_vic=plane(rec, pad_rec).contiguous(),
        pl_req=plane(req_s, torch.zeros(R)).movedim(-1, -3).contiguous())


def pdb_remaining(snap: ClusterSnapshot, evicted: torch.Tensor) -> torch.Tensor:
    """[GP] f32 ([B, GP] for a tenant batch): each budget's disruptions
    allowed less the evictions made so far (0/1 adds, exact in any
    order)."""
    run = snap.running
    pdb = run.pdb_group
    consumed = torch.zeros(snap.pdb_allowed.shape, dtype=torch.float32,
                           device=pdb.device)
    if snap.pdb_allowed.shape[-1]:
        hit = evicted & (pdb >= 0) & run.valid
        consumed.scatter_add_(-1, pdb.clamp(min=0).long(),
                              hit.to(torch.float32))
    return snap.pdb_allowed - consumed


def segment_prefix(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of [M, K] f32 along dim 0 that restarts at
    every row where `start` is set (each node's segment), in K15's order:
    each SEG_BLOCK-row block of a segment summed left to right from 0.0,
    the block totals added left to right, and a row's prefix the totals
    before its block plus its block's sum up to the row. A segment of up
    to SEG_BLOCK rows is summed left to right from 0.0, `vprefix`'s
    order. Never an f32 `torch.cumsum`, whose order depends on the
    device. One step a row of the longest segment: step j adds row j of
    every segment to the row before it."""
    M = x.shape[0]
    dev = x.device
    idx = torch.arange(M, device=dev)
    rank = idx - torch.cummax(torch.where(start, idx, 0), dim=0).values
    by_rank = torch.sort(rank, stable=True).indices
    counts = torch.bincount(rank, minlength=1).tolist() if M else []
    tot = torch.empty_like(x)    # the block totals before the row's block
    run = torch.empty_like(x)    # the row's block summed up to the row
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    lo = 0
    for j, n in enumerate(counts):
        rows = by_rank[lo:lo + n]
        if j % SEG_BLOCK:
            tot[rows] = tot[rows - 1]
            run[rows] = run[rows - 1] + x[rows]
        else:
            tot[rows] = tot[rows - 1] + run[rows - 1] if j else zero
            run[rows] = zero + x[rows]
        lo += n
    return tot + run


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
    # The victims on no node are never eligible: each its own segment
    # (their sums stay 0.0 either way) keeps the steps to the longest
    # node's segment.
    within = segment_prefix(vals, (seg == idx) | (ctx.node_s >= N))
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


def _victim_args(k: str, cfg: EngineConfig, snap: ClusterSnapshot,
                 ctx: PreemptCtx) -> tuple:
    """Check K15's victim table (each tenant's on its own for a batch):
    (M, GP, V, the offsets, the planes, the sorted order, the margin)."""
    dev = ctx.perm.device
    lead = ctx.perm.shape[:-1]             # () or (B,): the tenant axis
    M, R = ctx.req_s.shape[-2:]
    V, N = ctx.pl_vic.shape[-3:-1]
    if N != snap.nodes.valid.shape[-1]:
        raise ValueError(f"{k}: planes of {N} nodes, the snapshot has "
                         f"{snap.nodes.valid.shape[-1]}")
    check(k, dev, ctx.off, torch.int32, (*lead, N + 1))
    check(k, dev, ctx.pl_vic, torch.int32, (*lead, V, N, 4))
    check(k, dev, ctx.pl_req, torch.float32, (*lead, R, V, N))
    for t in (ctx.perm, ctx.pdb_s):
        check(k, dev, t, torch.int32, (*lead, M))
    for t in (ctx.cost_s, ctx.vprio_s):
        check(k, dev, t, torch.float32, (*lead, M))
    check(k, dev, ctx.req_s, torch.float32, (*lead, M, R))
    return (M, snap.pdb_allowed.shape[-1], V, ctx.off, ctx.pl_vic,
            ctx.pl_req, ctx.perm, ctx.cost_s, ctx.vprio_s, ctx.req_s,
            ctx.pdb_s, float(cfg.qos.preemption_margin))


def preempt_step(cfg: EngineConfig, snap: ClusterSnapshot, ctx: PreemptCtx,
                 p_prio: torch.Tensor, p_req: torch.Tensor,
                 allowed: torch.Tensor, used: torch.Tensor,
                 evicted: torch.Tensor):
    """Kernel K15 on CUDA tensors (one CTA, one preemptor), the plain
    version on CPU tensors."""
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
    # The evictions in the victims' sorted order (K15 marks its own).
    ev_s = evicted[ctx.perm.long()].to(torch.uint8)
    _build.launch("tpusched_preempt_step", N, R, *ptrs(
        (*vic, prio, req, allowed, snap.nodes.valid, used, alloc, ev_s,
         remaining, best, evict_m, freed)), stream_of(dev))
    preempt_step.launches += 1
    return best[0], best[1] > 0, evict_m, freed


preempt_step.launches = 0


# -- the fast mode's batched auction ----------------------------------------

# Priority-quantile buckets of the active bidders (JAX `_PRIO_BUCKETS`):
# each bucket's lane masks the victims eligible at the bucket's lower
# bound, a subset of every member bidder's own eligible set; one more
# lane, the optimistic one, admits every victim (threshold +inf).
PRIO_BUCKETS = 2
CLAIM_ITERS = 6  # the claim iterations of a round (JAX's default)


@dataclasses.dataclass
class PreemptCtxNV(_Tree):
    """The node-major victim table of the fast auction: per node its
    first V victims in ascending cost (the (node, cost) order of
    `precompute`), padded. A prefix that needs more than V evictions on
    one node is out of the fast mode's reach (JAX's documented cap). A
    tenant batch gives every field a leading [B] axis."""

    vreq: torch.Tensor    # [N, V, R] f32 victim requests
    vcost: torch.Tensor   # [N, V] f32 eviction cost, shifted positive
    vprio: torch.Tensor   # [N, V] f32 victim effective priority (+inf pad)
    vpdb: torch.Tensor    # [N, V] int32 budget (-1: none or pad)
    vvalid: torch.Tensor  # [N, V] bool
    vidx: torch.Tensor    # [N, V] int32 running-pod index (M: pad)


def precompute_nv(cfg: EngineConfig, snap: ClusterSnapshot,
                  cap: int) -> PreemptCtxNV:
    """JAX `precompute_nv`: the victims in `precompute`'s order, each at
    (its node, its position in the node's segment) of an [N + 1, V]
    table by a plain indexed scatter; victims past V and running pods on
    no node go to the sentinel row N, which is dropped. A tenant batch
    gives each tenant its own [N, V] table from its own order."""
    run = snap.running
    M = run.valid.shape[-1]
    N = snap.nodes.valid.shape[-1]
    lead = run.valid.shape[:-1]            # () or (B,): the tenant axis
    dev = run.valid.device
    V = max(1, min(cap, M))
    cost, vprio, perm, node_s, seg_start = _victim_order(cfg, snap)
    pos = torch.arange(M, device=dev) - seg_start
    ok = (node_s < N) & (pos < V)
    at = (torch.where(ok, node_s.long(), N), torch.where(ok, pos, 0))
    if lead:
        at = (torch.arange(lead[0], device=dev)[:, None].expand(ok.shape),
              *at)

    def scat(vals: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((*lead, N + 1, V, *vals.shape[ok.dim():]), fill,
                         dtype=vals.dtype, device=dev)
        keep = ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim()))
        out[at] = torch.where(keep, vals, torch.full((), fill,
                                                     dtype=vals.dtype,
                                                     device=dev))
        return out.narrow(len(lead), 0, N).contiguous()

    def by(x: torch.Tensor) -> torch.Tensor:
        """x in the victim order (x [.., M] or [.., M, R])."""
        if x.dim() == perm.dim():
            return x.gather(-1, perm)
        return x.gather(-2, perm[..., None].expand(*perm.shape,
                                                   x.shape[-1]))

    vvalid = torch.zeros((*lead, N + 1, V), dtype=torch.bool, device=dev)
    vvalid[at] = ok
    return PreemptCtxNV(
        vreq=scat(by(run.requests), 0.0), vcost=scat(by(cost), 0.0),
        vprio=scat(by(vprio), float("inf")),
        vpdb=scat(by(run.pdb_group), -1),
        vvalid=vvalid.narrow(len(lead), 0, N).contiguous(),
        vidx=scat(perm.to(torch.int32), M))


def vprefix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along `dim` from 0.0, left to right: the one
    order of every V-long f32 prefix of the auction, on every device
    (never an f32 `torch.cumsum`)."""
    acc = torch.zeros_like(x.select(dim, 0))
    out = []
    for v in range(x.shape[dim]):
        acc = acc + x.select(dim, v)
        out.append(acc)
    return torch.stack(out, dim=dim)


def _base_elig(ctx: PreemptCtxNV, evicted: torch.Tensor) -> torch.Tensor:
    """[N, V]: real victims not evicted yet."""
    M = evicted.shape[0]
    ev = evicted[ctx.vidx.clamp(0, M - 1).long()] & ctx.vvalid
    return ctx.vvalid & ~ev


def _tableau_nv(cfg: EngineConfig, snap: ClusterSnapshot, ctx: PreemptCtxNV,
                p_prio: torch.Tensor, p_req: torch.Tensor,
                used: torch.Tensor, evicted: torch.Tensor):
    """All C bidders' exact victim-prefix tableaus on the node-major
    table, [C, N, V] (JAX `_tableau_nv`, which no product path calls):
    (elig, wcost, wviol, fits, node_viol [C, N], node_cost [C, N]), the
    lexicographic (violations, cost) minimum over each node's fitting
    prefixes. Plain torch, the tests' reference for the auction's exact
    validation."""
    nodes = snap.nodes
    base = _base_elig(ctx, evicted)
    elig = base[None] & (ctx.vprio[None] + cfg.qos.preemption_margin
                         < p_prio[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=base.device)
    wreq = vprefix(torch.where(elig[..., None], ctx.vreq[None], zero), 2)
    fits = elig & ((used[None, :, None, :] - wreq) + p_req[:, None, None, :]
                   <= nodes.allocatable[None, :, None, :]).all(dim=-1)
    wcost = vprefix(torch.where(elig, ctx.vcost[None], zero), 2)
    viol = _violations(elig, ctx.vpdb, pdb_remaining(snap, evicted))
    wviol = torch.cumsum(viol.to(torch.int32), dim=2)
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=base.device)
    wv = wviol.to(torch.float32)
    node_viol = torch.where(fits, wv, inf).amin(dim=2)
    fits_v = fits & (wv == node_viol[..., None])
    node_cost = torch.where(fits_v, wcost, inf).amin(dim=2)
    return elig, wcost, wviol, fits, node_viol, node_cost


def _violations(elig: torch.Tensor, vpdb: torch.Tensor,
                remaining: torch.Tensor) -> torch.Tensor:
    """[..., N, V] bool: an eligible victim under a budget whose count of
    eligible same-budget victims at or before it in its node exceeds the
    budget's remaining disruptions (JAX's triangular [V, V] contraction,
    here an integer count)."""
    if remaining.shape[0] == 0:
        return torch.zeros_like(elig)
    V = vpdb.shape[1]
    has = vpdb >= 0
    tri = torch.ones((V, V), dtype=torch.bool, device=vpdb.device).tril()
    same = (vpdb[:, :, None] == vpdb[:, None, :]) & has[:, :, None] & tri
    eligp = elig & has
    wcnt = (same & eligp[..., None, :]).sum(dim=-1)
    rem = remaining[vpdb.clamp(min=0).long()]
    return eligp & (wcnt.to(torch.float32) > rem)


def prio_thresholds(p_prio: torch.Tensor, active: torch.Tensor,
                    buckets: int = PRIO_BUCKETS) -> torch.Tensor:
    """[buckets] f32: `jnp.nanquantile(where(active, p_prio, nan),
    linspace(0, 1, buckets, endpoint=False))` in the installed JAX's
    linear-interpolation formula, with explicit f32 operations (the same
    code on every device; `torch.nanquantile` interpolates with `lerp`,
    which rounds differently on CUDA). NaN where no bidder is active. A
    tenant batch ([B, C]) gives each tenant the quantiles of its own
    active bidders, [B, buckets]."""
    dev = p_prio.device
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
    vals = torch.sort(torch.where(active, p_prio, nan),
                      dim=-1).values                         # NaN last
    n = active.sum(dim=-1, keepdim=True).to(torch.float32)
    q = torch.tensor([b / buckets for b in range(buckets)],
                     dtype=torch.float32, device=dev) * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    top = n - 1.0
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    return (vals.gather(-1, low.long()) * lw
            + vals.gather(-1, high.long()) * hw)


def bucket_of(thr: torch.Tensor, p_prio: torch.Tensor) -> torch.Tensor:
    """[C] int32 ([B, C] for a batch): each bidder's bucket, the largest
    b with thr[b] <= p_prio (a NaN threshold compares false: bucket 0)."""
    b = (thr[..., None, :] <= p_prio[..., :, None]).sum(dim=-1) - 1
    return b.clamp(0, thr.shape[-1] - 1).to(torch.int32)


# -- K16: the bidder-independent lane tables ----------------------------------


def auction_tables_plain(ctx: PreemptCtxNV, evicted: torch.Tensor,
                         thr: torch.Tensor, remaining: torch.Tensor,
                         margin: float):
    """Per lane l (threshold thr[l]) and node: the victims eligible at
    that threshold (not evicted, vprio + margin < thr[l]) and their
    V-long prefixes (cum_req [L, N, V, R] f32, cum_cost [L, N, V] f32,
    cum_viol [L, N, V] int32), JAX `preempt_auction`'s node_rank
    tables; a tenant batch tenant by tenant ([B, L, N, V, ...])."""
    if evicted.dim() == 2:
        return per_tenant(auction_tables_plain, evicted.shape[0], ctx,
                          evicted, thr, remaining, margin)
    base = _base_elig(ctx, evicted)
    elig = base[None] & (ctx.vprio[None] + margin < thr[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=base.device)
    cum_req = vprefix(torch.where(elig[..., None], ctx.vreq[None], zero), 2)
    cum_cost = vprefix(torch.where(elig, ctx.vcost[None], zero), 2)
    viol = _violations(elig, ctx.vpdb, remaining)
    cum_viol = torch.cumsum(viol.to(torch.int32), dim=2).to(torch.int32)
    return cum_req, cum_cost, cum_viol


def _check_ctx(k: str, dev, ctx: PreemptCtxNV, N: int, R: int) -> int:
    lead = ctx.vvalid.shape[:-2]           # () or (B,): the tenant axis
    V = ctx.vvalid.shape[-1]
    check(k, dev, ctx.vreq, torch.float32, (*lead, N, V, R))
    check(k, dev, ctx.vcost, torch.float32, (*lead, N, V))
    check(k, dev, ctx.vprio, torch.float32, (*lead, N, V))
    check(k, dev, ctx.vpdb, torch.int32, (*lead, N, V))
    check(k, dev, ctx.vvalid, torch.bool, (*lead, N, V))
    check(k, dev, ctx.vidx, torch.int32, (*lead, N, V))
    if V > 32 or R > 8:
        raise ValueError(f"{k}: V={V}, R={R}; the kernel takes V <= 32, "
                         "R <= 8")
    return V


def auction_tables(ctx: PreemptCtxNV, evicted: torch.Tensor,
                   thr: torch.Tensor, remaining: torch.Tensor,
                   margin: float):
    """Kernel K16 on CUDA tensors (one launch for a tenant batch), the
    plain version on CPU tensors."""
    dev = ctx.vreq.device
    if dev.type == "cpu":
        return auction_tables_plain(ctx, evicted, thr, remaining, margin)
    k = "auction_tables"
    lead = evicted.shape[:-1]              # () or (B,): the tenant axis
    N, V, R = ctx.vreq.shape[-3:]
    _check_ctx(k, dev, ctx, N, R)
    L = thr.shape[-1]
    M = evicted.shape[-1]
    GP = remaining.shape[-1]
    check(k, dev, evicted, torch.bool, (*lead, M))
    check(k, dev, thr, torch.float32, (*lead, L))
    check(k, dev, remaining, torch.float32, (*lead, GP))
    cum_req = torch.empty((*lead, L, N, V, R), dtype=torch.float32,
                          device=dev)
    cum_cost = torch.empty((*lead, L, N, V), dtype=torch.float32, device=dev)
    cum_viol = torch.empty((*lead, L, N, V), dtype=torch.int32, device=dev)
    if cum_cost.numel() == 0:
        return cum_req, cum_cost, cum_viol
    _build.launch("tpusched_auction_tables", lead[0] if lead else 1, L, N, V,
                  R, M, GP, *ptrs((
                      ctx.vreq, ctx.vcost, ctx.vprio, ctx.vpdb, ctx.vvalid,
                      ctx.vidx, evicted, thr, remaining)), float(margin),
                  *ptrs((cum_req, cum_cost, cum_viol)), stream_of(dev))
    auction_tables.launches += 1
    return cum_req, cum_cost, cum_viol


auction_tables.launches = 0


# -- K17: the [C, N] node ranking -------------------------------------------


def auction_ok_plain(mask: torch.Tensor, rows: torch.Tensor | None,
                     pair_ok: torch.Tensor | None, pre_active: torch.Tensor,
                     node_valid: torch.Tensor):
    """(ok [C, N] bool, active_any [C] bool): the nodes each bidder may
    preempt on, its static mask row (rows[c] of `mask`, or row c) and
    pairwise verdict (when given) on a valid node, for active bidders
    only; and whether any is left. A tenant batch tenant by tenant
    ([B, C, N], rows index the tenant's own mask rows)."""
    if pre_active.dim() == 2:
        return per_tenant(auction_ok_plain, pre_active.shape[0], mask, rows,
                          pair_ok, pre_active, node_valid)
    if rows is not None:
        mask = mask[rows.long()]
    ok = mask & node_valid[None, :] & pre_active[:, None]
    if pair_ok is not None:
        ok = ok & pair_ok
    return ok, ok.any(dim=1)


def auction_ok(mask: torch.Tensor, rows: torch.Tensor | None,
               pair_ok: torch.Tensor | None, pre_active: torch.Tensor,
               node_valid: torch.Tensor):
    """K17's auction_ok entry point on CUDA tensors (one launch for a
    tenant batch), the plain version on CPU tensors."""
    dev = mask.device
    if dev.type == "cpu":
        return auction_ok_plain(mask, rows, pair_ok, pre_active, node_valid)
    k = "auction_ok"
    lead = pre_active.shape[:-1]           # () or (B,): the tenant axis
    Pm, N = mask.shape[-2:]
    C = pre_active.shape[-1]
    check(k, dev, mask, torch.bool, (*lead, Pm, N))
    if rows is not None:
        check(k, dev, rows, torch.int32, (*lead, C))
    elif Pm != C:
        raise ValueError(f"{k}: {Pm} mask rows for {C} bidders")
    if pair_ok is not None:
        check(k, dev, pair_ok, torch.bool, (*lead, C, N))
    check(k, dev, pre_active, torch.bool, (*lead, C))
    check(k, dev, node_valid, torch.bool, (*lead, N))
    ok = torch.empty((*lead, C, N), dtype=torch.bool, device=dev)
    any_ok = torch.empty((*lead, C), dtype=torch.bool, device=dev)
    if ok.numel() == 0:
        return ok, any_ok.fill_(False)
    _build.launch("tpusched_auction_ok", lead[0] if lead else 1, C, N, Pm,
                  *ptrs((mask, rows, pair_ok, pre_active, node_valid, ok,
                         any_ok)), stream_of(dev))
    auction_ok.launches += 1
    return ok, any_ok


auction_ok.launches = 0


def auction_rank_plain(cum_req: torch.Tensor, cum_cost: torch.Tensor,
                       cum_viol: torch.Tensor, lane: torch.Tensor,
                       ok: torch.Tensor, used: torch.Tensor,
                       alloc: torch.Tensor, p_req: torch.Tensor):
    """(bid [C, N] f32, could [C] bool). Per (bidder c, node n): the demand
    need = (used[n] + p_req[c]) - alloc[n]; in a lane, the first prefix
    position that frees it (pos: the most, over resources, of the prefix
    entries below the need), whether the whole table frees it (feas), and
    the prefix's cost and violations at pos. The bidder's bucket lane
    ranks, unless no allowed node is feasible there but one is in the
    optimistic lane (the last), which then ranks instead. Over the
    feasible allowed nodes with the fewest violations, bid = -cost, else
    -inf. could: some allowed node is feasible in the optimistic lane.
    A tenant batch tenant by tenant ([B, C, N] bids)."""
    if lane.dim() == 2:
        return per_tenant(auction_rank_plain, lane.shape[0], cum_req,
                          cum_cost, cum_viol, lane, ok, used, alloc, p_req)
    L, N, V, R = cum_req.shape
    C = lane.shape[0]
    need = (used[None] + p_req[:, None, :]) - alloc[None]          # [C, N, R]

    def rank_in(l: int):
        pos = torch.zeros((C, N), dtype=torch.int64, device=ok.device)
        for r in range(R):
            pos = torch.maximum(pos, (cum_req[l, None, :, :, r]
                                      < need[:, :, None, r]).sum(dim=2))
        feas = (need <= cum_req[l, None, :, V - 1, :]).all(dim=-1)
        posc = pos.clamp(0, V - 1)[..., None]
        return (feas,
                cum_cost[l][None].expand(C, N, V).gather(2, posc)[..., 0],
                cum_viol[l][None].expand(C, N, V).gather(2, posc)[..., 0])

    lanes = [rank_in(l) for l in range(L)]
    pick = lane.long()[None, :, None].expand(1, C, N)
    feas_b, cost_b, viol_b = (torch.stack([t[i] for t in lanes]).gather(
        0, pick)[0] for i in range(3))
    feas_o, cost_o, viol_o = lanes[L - 1]
    could = (ok & feas_o).any(dim=1)
    use_fb = (~(ok & feas_b).any(dim=1) & could)[:, None]
    feas = torch.where(use_fb, feas_o, feas_b)
    cost = torch.where(use_fb, cost_o, cost_b)
    viol = torch.where(use_fb, viol_o, viol_b)
    big = torch.iinfo(torch.int32).max
    vt = torch.where(ok & feas, viol, big)
    min_viol = vt.amin(dim=1, keepdim=True)
    bid = torch.where(ok & feas & (vt == min_viol), -cost,
                      torch.full((), float("-inf"), dtype=torch.float32,
                                 device=ok.device))
    return bid, could


def auction_rank(cum_req: torch.Tensor, cum_cost: torch.Tensor,
                 cum_viol: torch.Tensor, lane: torch.Tensor,
                 ok: torch.Tensor, used: torch.Tensor, alloc: torch.Tensor,
                 p_req: torch.Tensor):
    """Kernel K17 on CUDA tensors (one launch for a tenant batch), the
    plain version on CPU tensors."""
    dev = ok.device
    if dev.type == "cpu":
        return auction_rank_plain(cum_req, cum_cost, cum_viol, lane, ok,
                                  used, alloc, p_req)
    k = "auction_rank"
    lead = lane.shape[:-1]                 # () or (B,): the tenant axis
    L, N, V, R = cum_req.shape[-4:]
    C = lane.shape[-1]
    check(k, dev, cum_req, torch.float32, (*lead, L, N, V, R))
    check(k, dev, cum_cost, torch.float32, (*lead, L, N, V))
    check(k, dev, cum_viol, torch.int32, (*lead, L, N, V))
    check(k, dev, lane, torch.int32, (*lead, C))
    check(k, dev, ok, torch.bool, (*lead, C, N))
    check(k, dev, used, torch.float32, (*lead, N, R))
    check(k, dev, alloc, torch.float32, (*lead, N, R))
    check(k, dev, p_req, torch.float32, (*lead, C, R))
    if V > 32 or R > 8:
        raise ValueError(f"{k}: V={V}, R={R}; the kernel takes V <= 32, "
                         "R <= 8")
    bid = torch.empty((*lead, C, N), dtype=torch.float32, device=dev)
    could = torch.empty((*lead, C), dtype=torch.bool, device=dev)
    if bid.numel() == 0:
        return bid, could.fill_(False)
    _build.launch("tpusched_auction_rank", lead[0] if lead else 1, L, N, V,
                  R, C, *ptrs((cum_req, cum_cost, cum_viol, lane, ok, used,
                               alloc, p_req, bid, could)), stream_of(dev))
    auction_rank.launches += 1
    return bid, could


auction_rank.launches = 0


# -- K18: the claim iterations and the exact validation ----------------------


def auction_claim_plain(topv: torch.Tensor, topi: torch.Tensor,
                        can_plain: torch.Tensor, n_plain: torch.Tensor,
                        rank: torch.Tensor, ctx: PreemptCtxNV,
                        evicted: torch.Tensor,
                        p_prio: torch.Tensor, p_req: torch.Tensor,
                        used: torch.Tensor, alloc: torch.Tensor,
                        could: torch.Tensor, margin: float, GP: int):
    """JAX `preempt_auction` from its candidates on (`:564-679`).

    Candidates: each bidder's top-K nodes by bid (topv/topi, from K6;
    finite ones only), a plain bidder (can_plain) its scored node n_plain
    alone. CLAIM_ITERS iterations deal the still-unclaimed bidders
    distinct untaken candidates: the one with active-rank a bids its (a
    mod #available + 1)-th available candidate, and per node the lowest
    `rank` wins. Then per bidder, on its claimed node: the true-priority
    eligibility, the V-long prefix of the eligible requests from 0.0, the
    first prefix after which the bidder fits (the lexicographic minimum,
    since all three prefixes only grow). A preemption claim that fits
    nowhere is released. Returns (target [C] int32, -1 unclaimed;
    claimed, takes_evict [C] bool; vidx_t [C, V] int32, the kept
    prefix's running pods, M elsewhere; freed_req [C, R] f32, that
    prefix's sum, the value its fit was tested with; usage [C, GP]
    int32, its evictions per budget; could_bid [C] bool). A tenant batch
    tenant by tenant (a leading [B] axis on every argument but margin
    and GP)."""
    if topi.dim() == 3:
        return per_tenant(auction_claim_plain, topi.shape[0], topv, topi,
                          can_plain, n_plain, rank, ctx, evicted, p_prio,
                          p_req, used, alloc, could, margin, GP)
    C, K = topi.shape
    N, V = ctx.vvalid.shape
    M = evicted.shape[0]
    dev = topi.device
    big = torch.iinfo(torch.int32).max
    first = (torch.arange(K, device=dev) == 0)[None, :]
    cand = torch.where(can_plain[:, None],
                       torch.where(first, n_plain[:, None], 0), topi)
    fin = torch.where(can_plain[:, None], first, torch.isfinite(topv))
    cand_c = cand.clamp(0, N - 1).long()
    taken = torch.zeros(N, dtype=torch.bool, device=dev)
    target = torch.full((C,), -1, dtype=torch.int32, device=dev)
    claimed = torch.zeros(C, dtype=torch.bool, device=dev)
    for _ in range(CLAIM_ITERS):
        avail = fin & ~taken[cand_c] & ~claimed[:, None]
        csum = torch.cumsum(avail.to(torch.int32), dim=1)
        navail = csum[:, -1]
        has = ~claimed & (navail > 0)
        r_active = torch.cumsum(has.to(torch.int32), dim=0) - 1
        tgt = torch.remainder(r_active, navail.clamp_min(1)) + 1
        j = (csum < tgt[:, None]).sum(dim=1).clamp(0, K - 1)
        want = cand.gather(1, j[:, None])[:, 0]
        want_c = want.clamp(0, N - 1).long()
        key = torch.where(has, rank, big)
        best = torch.full((N,), big, dtype=torch.int32, device=dev)
        best = best.scatter_reduce(0, want_c, key, "amin")
        winner = has & (best[want_c] == rank)
        target = torch.where(winner, want.to(torch.int32), target)
        claimed = claimed | winner
        taken[want_c[winner]] = True
    t = target.clamp(0, N - 1).long()
    vv = ctx.vvalid[t]                                       # [C, V]
    vi = ctx.vidx[t]
    ev = evicted[vi.clamp(0, M - 1).long()] & vv
    elig = vv & ~ev & (ctx.vprio[t] + margin < p_prio[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    wreq = vprefix(torch.where(elig[..., None], ctx.vreq[t], zero), 1)
    fits = elig & ((used[t][:, None, :] - wreq) + p_req[:, None, :]
                   <= alloc[t][:, None, :]).all(dim=-1)
    feas = fits.any(dim=1)
    released = claimed & ~can_plain & ~feas
    claimed = claimed & (can_plain | feas)
    target = torch.where(claimed, target, -1)
    takes = claimed & ~can_plain
    best_pos = torch.argmax(fits.to(torch.int32), dim=1)     # first fit
    sel = (takes[:, None] & elig
           & (torch.arange(V, device=dev)[None, :] <= best_pos[:, None]))
    vidx_t = torch.where(sel, vi, M).to(torch.int32)
    freed = torch.where(takes[:, None],
                        wreq.gather(1, best_pos[:, None, None].expand(
                            C, 1, wreq.shape[2]))[:, 0], zero)
    usage = torch.zeros((C, GP), dtype=torch.int32, device=dev)
    if GP:
        vp = ctx.vpdb[t]
        hit = sel & (vp >= 0)
        usage.scatter_add_(1, vp.clamp(min=0).long(), hit.to(torch.int32))
    could_bid = can_plain | (could & ~released)
    return target, claimed, takes, vidx_t, freed, usage, could_bid


# K18 spreads each tenant's bidders over a cluster of Q CTAs (16 is the
# card's non-portable cluster size) of at most CLAIM_WARPS warps, a warp a
# bidder; a warp keeps its first CLAIM_REG bidders' candidates in
# registers (csrc/auction.cu).
CLAIM_CLUSTERS = (1, 2, 4, 8, 16)
CLAIM_REG = 2
CLAIM_WARPS = 32
CLAIM_MIN_BIDDERS = 32     # bidders a CTA at least (one warp's worth)
CLAIM_MAX_K = 256          # candidates a bidder: 8 a lane


def claim_threads(C: int, Q: int) -> int:
    """K18's threads a CTA for C bidders over Q CTAs: a warp for every
    CLAIM_REG bidders of a CTA's ceil(C / Q), at most CLAIM_WARPS warps."""
    if Q not in CLAIM_CLUSTERS:
        raise ValueError(f"auction_claim: cluster size {Q}, want one of "
                         f"{CLAIM_CLUSTERS}")
    cpc = -(-max(C, 1) // Q)
    return 32 * min(CLAIM_WARPS, -(-cpc // CLAIM_REG))


def claim_cluster_size(B: int, C: int, sms: int) -> tuple[int, int]:
    """(Q, threads a CTA) for K18 over B tenants of C bidders on a card of
    `sms` SMs: the largest Q in CLAIM_CLUSTERS with B * Q <= sms (every
    CTA on an SM of its own) and at least CLAIM_MIN_BIDDERS bidders a
    CTA; Q = 1 when even B alone passes sms (the clusters then queue)."""
    if B < 1 or C < 1 or sms < 1:
        raise ValueError(f"auction_claim: B={B}, C={C}, sms={sms}: each "
                         "must be >= 1")
    Q = CLAIM_CLUSTERS[-1]
    while Q > 1 and (B * Q > sms or Q * CLAIM_MIN_BIDDERS > C):
        Q //= 2
    return Q, claim_threads(C, Q)


def auction_claim(topv: torch.Tensor, topi: torch.Tensor,
                  can_plain: torch.Tensor, n_plain: torch.Tensor,
                  rank: torch.Tensor, ctx: PreemptCtxNV,
                  evicted: torch.Tensor, p_prio: torch.Tensor,
                  p_req: torch.Tensor, used: torch.Tensor,
                  alloc: torch.Tensor, could: torch.Tensor, margin: float,
                  GP: int, cluster: int | None = None):
    """Kernel K18 on CUDA tensors (one cluster of Q CTAs a tenant, Q from
    `claim_cluster_size` or `cluster`, a warp a bidder, K6's [C, K] lists
    as they are; the entry point refuses K > 256 or more nodes and bidders
    than a CTA's shared memory holds), the plain version on CPU
    tensors."""
    dev = topi.device
    if dev.type == "cpu":
        return auction_claim_plain(topv, topi, can_plain, n_plain, rank,
                                   ctx, evicted, p_prio, p_req, used, alloc,
                                   could, margin, GP)
    k = "auction_claim"
    lead = topi.shape[:-2]                 # () or (B,): the tenant axis
    C, K = topi.shape[-2:]
    N, V, R = ctx.vreq.shape[-3:]
    M = evicted.shape[-1]
    _check_ctx(k, dev, ctx, N, R)
    check(k, dev, topv, torch.float32, (*lead, C, K))
    check(k, dev, topi, torch.int32, (*lead, C, K))
    for t in (can_plain, could):
        check(k, dev, t, torch.bool, (*lead, C))
    for t in (n_plain, rank):
        check(k, dev, t, torch.int32, (*lead, C))
    check(k, dev, evicted, torch.bool, (*lead, M))
    check(k, dev, p_prio, torch.float32, (*lead, C))
    check(k, dev, p_req, torch.float32, (*lead, C, R))
    check(k, dev, used, torch.float32, (*lead, N, R))
    check(k, dev, alloc, torch.float32, (*lead, N, R))
    if K > CLAIM_MAX_K:
        raise ValueError(f"{k}: {K} candidates a bidder, the kernel takes "
                         f"at most {CLAIM_MAX_K}")
    target = torch.empty((*lead, C), dtype=torch.int32, device=dev)
    claimed = torch.empty((*lead, C), dtype=torch.bool, device=dev)
    takes = torch.empty((*lead, C), dtype=torch.bool, device=dev)
    vidx_t = torch.empty((*lead, C, V), dtype=torch.int32, device=dev)
    freed = torch.empty((*lead, C, R), dtype=torch.float32, device=dev)
    usage = torch.zeros((*lead, C, GP), dtype=torch.int32, device=dev)
    could_bid = torch.empty((*lead, C), dtype=torch.bool, device=dev)
    out = (target, claimed, takes, vidx_t, freed, usage, could_bid)
    if target.numel() == 0:
        return out
    B = lead[0] if lead else 1
    if cluster is None:
        Q, threads = claim_cluster_size(
            B, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    else:
        Q, threads = cluster, claim_threads(C, cluster)
    _build.launch("tpusched_auction_claim", B, Q, threads, C, K, N, V, R, M,
                  GP, CLAIM_ITERS, *ptrs((
                      topv, topi, can_plain, n_plain, rank, ctx.vreq,
                      ctx.vprio, ctx.vpdb, ctx.vvalid, ctx.vidx, evicted,
                      p_prio, p_req, used, alloc, could)), float(margin),
                  *ptrs(out), stream_of(dev))
    auction_claim.launches += 1
    return out


auction_claim.launches = 0


def preempt_auction(cfg: EngineConfig, snap: ClusterSnapshot,
                    ctx: PreemptCtxNV, p_prio: torch.Tensor,
                    p_req: torch.Tensor, allowed: torch.Tensor,
                    used: torch.Tensor, evicted: torch.Tensor,
                    can_plain: torch.Tensor, n_plain: torch.Tensor,
                    rank: torch.Tensor, pre_active: torch.Tensor,
                    k_cand: int = 256, ops=None,
                    rows: torch.Tensor | None = None,
                    pair_ok: torch.Tensor | None = None):
    """Batched bidding of C preemptors (JAX `preempt_auction`): K17's
    allowed nodes, the priority thresholds of the active bidders, K16's
    lane tables, K17's bids, K6's top k_cand of each row (ties to the
    lower node), K18's claims and validation. allowed: the bidders'
    static masks ([C, N], or the rows `rows` of a wider mask), with
    pair_ok [C, N] their pairwise verdicts; rank [C] the bidders' claim
    precedence; pre_active [C] the bidders that may preempt (JAX's
    callers clear the others' allowed rows). A tenant batch carries a
    leading [B] axis on the snapshot, the table, the state and every
    bidder array (each tenant's bidders bid on its own cluster), and
    each kernel launches once for all tenants. Returns K18's (target,
    claimed, takes_evict, vidx_t, freed_req, usage, could_bid)."""
    if ops is None:
        from tpusched_torch.kernels.assign import KERNELS as ops
    N = snap.nodes.valid.shape[-1]
    dev = p_prio.device
    margin = float(cfg.qos.preemption_margin)
    ok, any_ok = ops.auction_ok(allowed, rows, pair_ok, pre_active,
                                snap.nodes.valid)
    thr = prio_thresholds(p_prio, any_ok & ~can_plain)
    lanes = torch.cat([thr, torch.full((*thr.shape[:-1], 1), float("inf"),
                                       dtype=torch.float32, device=dev)],
                      dim=-1)
    remaining = pdb_remaining(snap, evicted).contiguous()
    tables = ops.auction_tables(ctx, evicted, lanes, remaining, margin)
    bid, could = ops.auction_rank(*tables, bucket_of(thr, p_prio), ok, used,
                                  snap.nodes.allocatable, p_req)
    topv, topi, _ = ops.row_topk(bid, min(k_cand, N))
    return ops.auction_claim(topv, topi, can_plain, n_plain.to(torch.int32),
                             rank.to(torch.int32), ctx,
                             evicted, p_prio, p_req, used,
                             snap.nodes.allocatable, could, margin,
                             snap.pdb_allowed.shape[-1])
