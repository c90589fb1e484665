"""The solve paths: the port of `tpusched/kernels/assign.py`, with
pairwise signatures (topology spread, inter-pod affinity), gangs and
PostFilter preemption in both modes.

The scheduling cycle splits, as in the JAX package, into
  * a STATIC part computed once per snapshot (StaticCtx): the cell-local
    tableau (kernel K2, `_tableau_cells`), then its row-coupled
    normalisation times the per-pod QoS weights (kernel K3, inside
    `finalize_static`), and the signature x member match (K9,
    `kernels/pairwise.sig_match`);
  * a DYNAMIC part that depends on node `used` and the pair state:
    resource fit, LeastRequested and BalancedAllocation, and the spread
    and inter-pod terms. Parity mode evaluates it pod by pod in
    dynamic-priority order in the parity scan (kernel K4, `parity_scan`;
    with signatures its pairwise variant `parity_scan_pair`, from the
    pair state K10 counts), which commits each pod before the next one
    scores. ScoreBatch and fast mode evaluate it for a whole [rows, N]
    block at once (kernel K5, `cycle`, fed with signatures by K11's
    pairwise rows); a fast round then ranks each row (K6, `row_topk`),
    deals pods onto nodes by a node desirability (K7, `desirability`)
    and commits capacity prefixes per node in sub-steps (K8,
    `prefix_commit_loop`: all of a round's sub-steps in one launch). With signatures a round also water-fills spread
    members across their domains (K12, `waterfill`), adds its commits
    to the pair state (K10's `pair_commit`) and validates them against
    the end-of-round state until nothing more reverts: the inter-pod
    verdict at each chosen node (K14, `kernels/pairwise.ia_ok_at_choice`),
    the spread excess per (signature, domain) (K13, `excess_min` and
    `excess_survive`), the reverts out of `used` (K8's `node_add`) and
    the pair state.
  * With `cfg.preemption` and running pods, parity mode's scan runs its
    preemption variant (`parity_scan_preempt`, `parity_scan_pair_preempt`):
    a pod that fits nowhere searches the (node, cost)-sorted victims for
    the cheapest prefix to evict (K15, `kernels/preempt`), inside K4.
    Fast mode drains the pods its rounds left with batched auction
    rounds (`_preempt_rounds`): the best-ranked pending pods bid at once
    for victim prefixes on the node-major victim table (K16-K18 and K6,
    `kernels/preempt.preempt_auction`), one claimant a node.
  * Both modes end with the gang gate (`gang_rollback`): a pod group
    short of its min_member unwinds through K8's `node_add` and K10's
    `pair_commit` with sign -1.
  * A warm lineage keeps the static part's cell-local tables
    (`WarmTableau`) between cycles and refreshes only its dirty rows and
    columns (`refresh_tableau`: K1, K2 and K9 on views). The incremental
    solve (`solve_incremental`) seeds the fast rounds with the last
    cycle's placements: the frontier closes over signatures and dirty
    nodes (K20), the carried pods that still fit their node stay (K19),
    and only the frontier goes through the rounds.

Every kernel wrapper runs its plain version (`*_plain`) on CPU tensors.
The solve functions take an `Ops` table (default: the kernel wrappers);
`PLAIN` holds the plain versions, with which a caller can run a whole
solve on CUDA tensors without a kernel, to compare.

The JAX fast rounds are `lax.while_loop`s on the device. Here they are
Python loops that read one device flag per round (preemption rounds
included), per tranche, per validation pass and per hand-off from
full-width to compacted rounds; `RoundStats` counts those reads. A
round's commit sub-steps loop on the card, inside K8.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import DO_NOT_SCHEDULE, EngineConfig
from tpusched_torch.kernels import check, per_tenant, ptrs, stream_of
from tpusched_torch.kernels import explain as kexplain
from tpusched_torch.kernels import filter as kfilter
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.kernels import score as kscore
from tpusched_torch.kernels.atoms import atom_sat, atom_sat_plain
from tpusched_torch.qos import (
    effective_priority,
    effective_weights,
    pressure_of,
    tie_hash,
)
from tpusched_torch.snapshot import ClusterSnapshot, NodeArrays, PodArrays

NEG_INF = float("-inf")


@dataclasses.dataclass
class StaticCtx:
    """Snapshot-dependent but state-independent precomputation."""

    mask: torch.Tensor       # [P, N] bool: taints & node affinity & validity
    aff_ok: torch.Tensor     # [P, N] bool: node-affinity component alone
    score: torch.Tensor      # [P, N] f32: w_na*NodeAffinity + w_tt*TaintToleration
    sig_match: torch.Tensor  # [S, M+P] bool: signature x member match (K9)
    w_lr: torch.Tensor       # [P] f32 per-pod effective plugin weights (QoS)
    w_ba: torch.Tensor       # [P]
    w_ts: torch.Tensor       # [P]
    w_ia: torch.Tensor       # [P]
    rw: torch.Tensor         # [R] resource score weights

    # A tenant batch (tenants.solve_many) carries a leading [B] axis on
    # every field but rw, which the config fixes for all tenants.

    def tenant(self, b: int) -> "StaticCtx":
        return self._map(lambda t: t[b])

    def as_batch(self) -> "StaticCtx":
        return self._map(lambda t: t.unsqueeze(0))

    def _map(self, fn) -> "StaticCtx":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self) if f.name != "rw"})


# -- K2: the cell-local tableau ---------------------------------------------


def _tableau_cells_plain(snap: ClusterSnapshot, pods_v: PodArrays,
                         nodes_v: NodeArrays, node_sat_v: torch.Tensor):
    """(mask, aff_ok, na_raw, tt_count), each [P, N], in the JAX op
    sequence; [B, P, N] for a tenant batch, tenant by tenant."""
    if node_sat_v.dim() == 3:
        return per_tenant(_tableau_cells_plain, node_sat_v.shape[0], snap,
                          pods_v, nodes_v, node_sat_v)
    aff_ok = kfilter.node_affinity_mask(
        node_sat_v, pods_v.req_term_atoms, pods_v.req_term_valid
    )
    # Cordon (NodeUnschedulable): closed to new pods unless the pod
    # tolerates node.kubernetes.io/unschedulable.
    cordon_ok = (
        nodes_v.schedulable[None, :] | pods_v.tolerates_unsched[:, None]
    )
    mask = (
        aff_ok
        & kfilter.taint_mask(nodes_v.taint_ids, snap.taint_effect,
                             pods_v.tolerated)
        & nodes_v.valid[None, :]
        & cordon_ok
        & pods_v.valid[:, None]
    )
    na_raw = kscore.node_affinity_raw(
        node_sat_v, pods_v.pref_term_atoms, pods_v.pref_term_valid,
        pods_v.pref_weight,
    )
    tt_count = kscore.taint_intolerable_count(
        nodes_v.taint_ids, snap.taint_effect, pods_v.tolerated
    )
    return mask, aff_ok, na_raw, tt_count


def _tableau_cells(snap: ClusterSnapshot, pods_v: PodArrays,
                   nodes_v: NodeArrays, node_sat_v: torch.Tensor):
    """Kernel K2 on CUDA tensors, the plain version on CPU tensors."""
    dev = node_sat_v.device
    if dev.type == "cpu":
        return _tableau_cells_plain(snap, pods_v, nodes_v, node_sat_v)
    lead = node_sat_v.shape[:-2]           # () or (B,): the tenant axis
    A, N = node_sat_v.shape[-2:]
    P, T, AT = pods_v.req_term_atoms.shape[-3:]
    PT = pods_v.pref_term_atoms.shape[-2]
    TN = nodes_v.taint_ids.shape[-1]
    VT = snap.taint_effect.shape[-1]
    k = "tableau_cells"
    check(k, dev, node_sat_v, torch.bool, (*lead, A, N))
    check(k, dev, pods_v.req_term_atoms, torch.int32, (*lead, P, T, AT))
    check(k, dev, pods_v.req_term_valid, torch.bool, (*lead, P, T))
    check(k, dev, pods_v.pref_term_atoms, torch.int32, (*lead, P, PT, AT))
    check(k, dev, pods_v.pref_term_valid, torch.bool, (*lead, P, PT))
    check(k, dev, pods_v.pref_weight, torch.float32, (*lead, P, PT))
    check(k, dev, nodes_v.taint_ids, torch.int32, (*lead, N, TN))
    check(k, dev, snap.taint_effect, torch.int8, (*lead, VT))
    check(k, dev, pods_v.tolerated, torch.bool, (*lead, P, VT))
    check(k, dev, nodes_v.schedulable, torch.bool, (*lead, N))
    check(k, dev, nodes_v.valid, torch.bool, (*lead, N))
    check(k, dev, pods_v.tolerates_unsched, torch.bool, (*lead, P))
    check(k, dev, pods_v.valid, torch.bool, (*lead, P))
    mask = torch.empty((*lead, P, N), dtype=torch.bool, device=dev)
    aff_ok = torch.empty((*lead, P, N), dtype=torch.bool, device=dev)
    na_raw = torch.empty((*lead, P, N), dtype=torch.float32, device=dev)
    tt_count = torch.empty((*lead, P, N), dtype=torch.float32, device=dev)
    if mask.numel() == 0:
        return mask, aff_ok, na_raw, tt_count
    args = (node_sat_v, pods_v.req_term_atoms, pods_v.req_term_valid,
            pods_v.pref_term_atoms, pods_v.pref_term_valid,
            pods_v.pref_weight, nodes_v.taint_ids, snap.taint_effect,
            pods_v.tolerated, nodes_v.schedulable, nodes_v.valid,
            pods_v.tolerates_unsched, pods_v.valid,
            mask, aff_ok, na_raw, tt_count)
    _build.launch("tpusched_tableau_cells", lead[0] if lead else 1, P, N,
                  A, T, AT, PT, TN, VT,
                  *(t.data_ptr() for t in args), stream_of(dev))
    _tableau_cells.launches += 1
    return mask, aff_ok, na_raw, tt_count


_tableau_cells.launches = 0


# -- K3: row-coupled normalisation x QoS weights ----------------------------


def finalize_score_plain(na_raw: torch.Tensor, tt_count: torch.Tensor,
                         node_valid: torch.Tensor, w_na: torch.Tensor,
                         w_tt: torch.Tensor) -> torch.Tensor:
    """[P, N] f32 w_na*default_normalize(na_raw) + w_tt*tt_score; a
    tenant batch tenant by tenant."""
    if na_raw.dim() == 3:
        return per_tenant(finalize_score_plain, na_raw.shape[0], na_raw,
                          tt_count, node_valid, w_na, w_tt)
    na = kscore.default_normalize(na_raw, node_valid)
    tt = kscore.taint_toleration_from_count(tt_count, node_valid)
    return w_na[:, None] * na + w_tt[:, None] * tt


def finalize_score(na_raw: torch.Tensor, tt_count: torch.Tensor,
                   node_valid: torch.Tensor, w_na: torch.Tensor,
                   w_tt: torch.Tensor) -> torch.Tensor:
    """Kernel K3 on CUDA tensors, the plain version on CPU tensors."""
    dev = na_raw.device
    if dev.type == "cpu":
        return finalize_score_plain(na_raw, tt_count, node_valid, w_na, w_tt)
    lead = na_raw.shape[:-2]               # () or (B,): the tenant axis
    P, N = na_raw.shape[-2:]
    k = "finalize_static"
    check(k, dev, na_raw, torch.float32, (*lead, P, N))
    check(k, dev, tt_count, torch.float32, (*lead, P, N))
    check(k, dev, node_valid, torch.bool, (*lead, N))
    check(k, dev, w_na, torch.float32, (*lead, P))
    check(k, dev, w_tt, torch.float32, (*lead, P))
    score = torch.empty((*lead, P, N), dtype=torch.float32, device=dev)
    if score.numel() == 0:
        return score
    _build.launch("tpusched_finalize_static", lead[0] if lead else 1, P, N,
                  *(t.data_ptr() for t in (na_raw, tt_count, node_valid,
                                           w_na, w_tt, score)),
                  stream_of(dev))
    finalize_score.launches += 1
    return score


finalize_score.launches = 0


# -- the warm tableau: K1, K2 and K9 on the whole snapshot or on views -------


@dataclasses.dataclass
class WarmTableau:
    """The cell-local static tables of one snapshot (JAX `WarmTableau`):
    cell (p, n) depends only on pod p's row, node n's row and the atom
    and signature tables, so a delta cycle recomputes exactly its dirty
    pod rows, node columns and member columns (`refresh_tableau`) and
    gets what a full build gives. Everything coupled across rows (QoS
    weights, the score normalisation, pop order, pair counts) is left to
    `finalize_static` and the solve, every solve. A warm lineage carries
    it on the device between cycles (engine.WarmState); the cold path
    builds one and drops it (member_sat_t None without signatures)."""

    node_sat_t: torch.Tensor           # [A, N] bool (K1, node labels)
    member_sat_t: torch.Tensor | None  # [A, M+P] bool (K1, member labels)
    sig_match: torch.Tensor | None     # [S, M+P] bool (K9)
    mask: torch.Tensor                 # [P, N] bool static feasibility
    aff_ok: torch.Tensor               # [P, N] bool node-affinity part
    na_raw: torch.Tensor               # [P, N] f32 preferred-affinity sums
    tt_count: torch.Tensor             # [P, N] f32 PreferNoSchedule counts

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def build_tableau(cfg: EngineConfig, snap: ClusterSnapshot,
                  node_sat_t: torch.Tensor,
                  member_sat_t: torch.Tensor | None = None,
                  ops: "Ops | None" = None) -> WarmTableau:
    """The full tableau from the snapshot's label tables (K2; K9 with
    signatures, which needs member_sat_t). Without signatures sig_match
    is an empty [0, M+P] table."""
    ops = ops or KERNELS
    cells = ops.tableau_cells(snap, snap.pods, snap.nodes, node_sat_t)
    if snap.sigs.key.shape[-1] > 0:
        sm = ops.sig_match(member_sat_t, snap.sigs, kpair.member_ns(snap))
    else:
        sm = torch.zeros((*node_sat_t.shape[:-2], 0,
                          snap.running.valid.shape[-1]
                          + snap.pods.valid.shape[-1]),
                         dtype=torch.bool, device=node_sat_t.device)
    return WarmTableau(node_sat_t, member_sat_t, sm, *cells)


def refresh_tableau(cfg: EngineConfig, snap: ClusterSnapshot,
                    tab: WarmTableau, dirty_pods=None, dirty_nodes=None,
                    dirty_members=None, pod_perm=None, node_perm=None,
                    member_perm=None, ops: "Ops | None" = None) -> WarmTableau:
    """O(churn) tableau upkeep (JAX `refresh_tableau`): the reorder
    gathers (the permutations DeviceSnapshot applied to the snapshot's
    rows), then the dirty node label rows (K1), the dirty member
    columns (K1, then K9), the dirty pod rows against every node (K2 on
    the gathered pods) and every pod against the dirty node columns (K2
    on the gathered nodes), in JAX's order: the pod-row and node-column
    cells read the refreshed node label rows, and a (dirty pod, dirty
    node) cell is written twice with the same value. Index arrays are
    int64 device tensors and may repeat an index (pow2 padding): the
    repeated writes carry identical content. The tensors of `tab` are
    updated in place where no reorder made new ones; the lineage holds
    the only reference. Vocabulary growth is not expressible here
    (DeviceSnapshot.warm_delta sends it down the cold path)."""
    ops = ops or KERNELS
    nst, mst, sm = tab.node_sat_t, tab.member_sat_t, tab.sig_match
    mask, aff_ok = tab.mask, tab.aff_ok
    na_raw, ttc = tab.na_raw, tab.tt_count
    if node_perm is not None:
        nst = nst.index_select(1, node_perm)
        mask, aff_ok, na_raw, ttc = (t.index_select(1, node_perm)
                                     for t in (mask, aff_ok, na_raw, ttc))
    if pod_perm is not None:
        mask, aff_ok, na_raw, ttc = (t.index_select(0, pod_perm)
                                     for t in (mask, aff_ok, na_raw, ttc))
    if member_perm is not None:
        mst = mst.index_select(1, member_perm)
        sm = sm.index_select(1, member_perm)
    if dirty_nodes is not None:
        nv = permute_rows(snap.nodes, dirty_nodes)
        sat_rows = ops.atom_sat(snap.atoms, nv.label_pairs, nv.label_keys,
                                nv.label_nums)                   # [D, A]
        nst.index_copy_(1, dirty_nodes, sat_rows.T)
    if dirty_members is not None:
        lp = kpair.merge_members(snap.running.label_pairs,
                                 snap.pods.label_pairs)
        lk = kpair.merge_members(snap.running.label_keys,
                                 snap.pods.label_keys)
        sat_cols = ops.atom_sat(snap.atoms,
                                lp.index_select(0, dirty_members),
                                lk.index_select(0, dirty_members),
                                None).T.contiguous()             # [A, D]
        mst.index_copy_(1, dirty_members, sat_cols)
        if sm.shape[0] > 0:
            sm.index_copy_(1, dirty_members, ops.sig_match(
                sat_cols, snap.sigs,
                kpair.member_ns(snap).index_select(0, dirty_members)))
    if dirty_pods is not None:
        cells = ops.tableau_cells(snap, permute_rows(snap.pods, dirty_pods),
                                  snap.nodes, nst)
        for t, c in zip((mask, aff_ok, na_raw, ttc), cells):
            t.index_copy_(0, dirty_pods, c)
    if dirty_nodes is not None:
        cells = ops.tableau_cells(snap, snap.pods,
                                  permute_rows(snap.nodes, dirty_nodes),
                                  nst.index_select(1, dirty_nodes))
        for t, c in zip((mask, aff_ok, na_raw, ttc), cells):
            t.index_copy_(1, dirty_nodes, c)
    return WarmTableau(nst, mst, sm, mask, aff_ok, na_raw, ttc)


def finalize_static(cfg: EngineConfig, snap: ClusterSnapshot,
                    tab: WarmTableau, ops: "Ops | None" = None) -> StaticCtx:
    """StaticCtx from a (fresh or carried) tableau: per-pod QoS plugin
    weights from the current snapshot (plain torch over [P]) and the
    row-normalised static score (K3), every solve, warm or cold."""
    ops = ops or KERNELS
    pods = snap.pods
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    score = ops.finalize_score(tab.na_raw, tab.tt_count, snap.nodes.valid,
                               w["node_affinity"], w["taint_toleration"])
    sig_match = tab.sig_match
    if sig_match is None:
        sig_match = torch.zeros((0, snap.running.valid.shape[0]
                                 + pods.valid.shape[0]),
                                dtype=torch.bool, device=tab.mask.device)
    return StaticCtx(
        mask=tab.mask, aff_ok=tab.aff_ok, score=score, sig_match=sig_match,
        w_lr=w["least_requested"], w_ba=w["balanced_allocation"],
        w_ts=w["topology_spread"], w_ia=w["interpod_affinity"],
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=tab.mask.device),
    )


def precompute_static(cfg: EngineConfig, snap: ClusterSnapshot,
                      node_sat_t: torch.Tensor,
                      member_sat_t: torch.Tensor | None = None,
                      ops: "Ops | None" = None) -> StaticCtx:
    """StaticCtx (K2, K3, and K9 when the snapshot has signatures;
    member_sat_t, the [A, M+P] member label table, is then required)."""
    return finalize_static(
        cfg, snap, build_tableau(cfg, snap, node_sat_t, member_sat_t, ops),
        ops)


# -- row scatters and gathers of DeviceSnapshot's deltas -------------------
# Plain torch indexing (north star rule): index_copy / index_select over
# every leaf of a row group (NodeArrays, PodArrays, ... or a bare tensor).
# A scatter index may repeat (pow2 padding); the repeated rows carry the
# same content, so the order of the writes does not matter.


def scatter_rows(tree, idx: torch.Tensor, rows):
    """A copy of `tree` with leaf[idx[j]] = rows.leaf[j] for every leaf."""
    if isinstance(tree, torch.Tensor):
        return tree.index_copy(0, idx.long(), rows)
    return dataclasses.replace(tree, **{
        f.name: scatter_rows(getattr(tree, f.name), idx,
                             getattr(rows, f.name))
        for f in dataclasses.fields(tree)})


def permute_rows(tree, perm: torch.Tensor):
    """A copy of `tree` with every leaf's rows gathered: leaf[perm]."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, perm.long())
    return dataclasses.replace(tree, **{
        f.name: permute_rows(getattr(tree, f.name), perm)
        for f in dataclasses.fields(tree)})


# -- the per-pod cycle and the parity scan (K4) -----------------------------


def pod_cycle(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
              p: int, used: torch.Tensor,
              st: "kpair.PairState | None" = None,
              dom_s: torch.Tensor | None = None):
    """Single-pod [N] Filter + Score against `used` and the pair state
    `st` (the scan body). With no signature (st None), pairwise_row is
    the identity: zero spread penalty (inverse-normalised to 100) and
    zero inter-pod raw score (min-max-normalised to 0). Returns
    (feasible, score, allowed), allowed being the static and pairwise
    feasibility without the resource fit (what preemption may repair
    is the fit alone)."""
    nodes = snap.nodes
    nvalid = nodes.valid
    req = snap.pods.requests[p]
    allowed = static.mask[p]
    if st is None:
        pen = raw = torch.zeros(nvalid.shape[0], dtype=torch.float32,
                                device=nvalid.device)
    else:
        spread_ok, pen, ia_ok, raw = kpair.pairwise_row(
            snap, st, static.sig_match, dom_s, p, static.aff_ok[p])
        allowed = allowed & spread_ok & ia_ok
    feasible = allowed & kfilter.resource_fit(nodes.allocatable, used, req)
    score = (
        static.w_lr[p] * kscore.least_requested(nodes.allocatable, used, req,
                                                static.rw)
        + static.w_ba[p] * kscore.balanced_allocation(nodes.allocatable,
                                                      used, req, static.rw)
        + static.score[p]
        + static.w_ts[p] * kscore.inverse_normalize(pen, nvalid)
        + static.w_ia[p] * kscore.minmax_normalize(raw, nvalid)
    )
    return feasible, score, allowed


def pick_node(cfg: EngineConfig, masked: torch.Tensor,
              p: int) -> torch.Tensor:
    """Among the score maxima: the lowest index ("first") or the
    tie_hash(seed, p)-th one in node order ("seeded")."""
    if cfg.tie_break == "first":
        return torch.argmax(masked)
    mx = masked.max()
    ties = masked == mx
    cnt = ties.sum().clamp_min(1)
    h = tie_hash(cfg.tie_seed, p) % cnt
    rank = ties.cumsum(0) - 1
    return torch.argmax((ties & (rank == h)).to(torch.int32))


def pop_order(cfg: EngineConfig, snap: ClusterSnapshot) -> torch.Tensor:
    """Queue order: stable descending sort by dynamic QoS priority;
    invalid pods sink to the end. A library sort, as jnp.argsort is on
    the JAX side. A tenant batch sorts each tenant's row."""
    pods = snap.pods
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail)
    key = torch.where(pods.valid, prio,
                      torch.full((), NEG_INF, dtype=prio.dtype,
                                 device=prio.device))
    return torch.sort(-key, dim=-1, stable=True).indices


def _rank_of(order: torch.Tensor) -> torch.Tensor:
    """Each pod's position in the pop order (int32, per tenant)."""
    P = order.shape[-1]
    return torch.zeros(order.shape, dtype=torch.int32,
                       device=order.device).scatter_(
        -1, order, torch.arange(P, dtype=torch.int32,
                                device=order.device).expand(order.shape))


def parity_scan_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                      static: StaticCtx, order: torch.Tensor):
    """The sequential commit loop in plain torch: (assigned [P] int32,
    chosen [P] f32, used [N, R] f32); a tenant batch tenant by tenant."""
    if order.dim() == 2:
        return per_tenant(parity_scan_plain, order.shape[0], cfg, snap,
                          static, order)
    return _scan_loop(cfg, snap, static, order)[:3]


def parity_scan_pair_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                           static: StaticCtx, order: torch.Tensor,
                           st: "kpair.PairState", dom_s: torch.Tensor):
    """The sequential commit loop with pairwise constraints, in plain
    torch: (assigned, chosen, used, final PairState); a tenant batch
    tenant by tenant."""
    if order.dim() == 2:
        return per_tenant(parity_scan_pair_plain, order.shape[0], cfg, snap,
                          static, order, st, dom_s)
    return _scan_loop(cfg, snap, static, order, st, dom_s)[:4]


def parity_scan_preempt_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                              static: StaticCtx, order: torch.Tensor,
                              pctx: "kpre.PreemptCtx", explain: bool = False):
    """The sequential commit loop with preemption, in plain torch:
    (assigned, chosen, used, evicted [M] bool); with explain, then each
    victim's evicting pod and that pod's pop-order step (evictor,
    evict_pos [M] int32, -1 where not evicted); a tenant batch tenant by
    tenant."""
    if order.dim() == 2:
        return per_tenant(parity_scan_preempt_plain, order.shape[0], cfg,
                          snap, static, order, pctx, explain)
    a, c, u, _, ev, evictor, pos = _scan_loop(cfg, snap, static, order,
                                              pctx=pctx)
    return (a, c, u, ev) + ((evictor, pos) if explain else ())


def parity_scan_pair_preempt_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                                   static: StaticCtx, order: torch.Tensor,
                                   st: "kpair.PairState",
                                   dom_s: torch.Tensor,
                                   pctx: "kpre.PreemptCtx",
                                   explain: bool = False):
    """The sequential commit loop with pairwise constraints and
    preemption, in plain torch: (assigned, chosen, used, final
    PairState, evicted), with explain then (evictor, evict_pos); a
    tenant batch tenant by tenant."""
    if order.dim() == 2:
        return per_tenant(parity_scan_pair_preempt_plain, order.shape[0],
                          cfg, snap, static, order, st, dom_s, pctx, explain)
    out = _scan_loop(cfg, snap, static, order, st, dom_s, pctx)
    return out if explain else out[:5]


def _scan_loop(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
               order: torch.Tensor, st: "kpair.PairState | None" = None,
               dom_s: torch.Tensor | None = None,
               pctx: "kpre.PreemptCtx | None" = None):
    """JAX solve_sequential's scan body, pod by pod in `order`; with a
    pair state, pairwise_row before and pair_state_add_pod after each
    commit; with a victim table (pctx), the PostFilter branch
    (`_preempt_branch`) for every valid pod outside a gang that fits
    nowhere. Returns (assigned, chosen, used, st, evicted, evictor,
    evict_pos): each victim's evicting pod and that pod's step in pop
    order (-1 where not evicted)."""
    P = order.shape[0]
    M = snap.running.valid.shape[0]
    dev = order.device
    pods = snap.pods
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    used = snap.nodes.used.clone()
    assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    chosen = torch.full((P,), NEG_INF, dtype=torch.float32, device=dev)
    evicted = torch.zeros(M, dtype=torch.bool, device=dev)
    evictor = torch.full((M,), -1, dtype=torch.int32, device=dev)
    evict_pos = torch.full((M,), -1, dtype=torch.int32, device=dev)
    requests = pods.requests
    if pctx is not None:
        prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                                  pods.observed_avail)
        may_preempt = (pods.valid & (pods.group < 0)).tolist()
    for i, p in enumerate(order.tolist()):
        feasible, score, allowed = pod_cycle(cfg, snap, static, p, used, st,
                                             dom_s)
        masked = torch.where(feasible, score, neg)
        n = pick_node(cfg, masked, p)
        commit = feasible.any()
        # An unplaced pod adds 0 to used[argmax] = used[0], as in JAX.
        used[n] = used[n] + torch.where(commit, requests[p],
                                        torch.zeros_like(requests[p]))
        if st is not None:
            st = kpair.pair_state_add_pod(snap, st, static.sig_match, dom_s,
                                          p, n, commit)
        assigned[p] = torch.where(commit, n, -1)
        chosen[p] = torch.where(commit, masked[n], neg)
        if pctx is None or not may_preempt[p] or bool(commit):
            continue
        # Preempted placements keep chosen = -inf (no rescore). JAX's
        # branch with can = false changes nothing: it subtracts a zero
        # freed row and adds zero requests.
        best_n, can, evict_m, freed = kpre.preempt_step_plain(
            cfg, snap, pctx, prio[p], requests[p], allowed, used, evicted)
        if not bool(can):
            continue
        used[best_n] = used[best_n] - freed
        used[best_n] = used[best_n] + requests[p]
        if st is not None:
            st = kpair.pair_state_evict(snap, st, static.sig_match, dom_s,
                                        evict_m)
            st = kpair.pair_state_add_pod(snap, st, static.sig_match, dom_s,
                                          p, best_n, can)
        evicted = evicted | evict_m
        evictor[evict_m] = p
        evict_pos[evict_m] = i
        assigned[p] = best_n
    return assigned, chosen, used, st, evicted, evictor, evict_pos


def _scan_args(k: str, cfg: EngineConfig, snap: ClusterSnapshot,
               static: StaticCtx, order: torch.Tensor) -> tuple:
    """Check K4's arguments (all variants, with or without a tenant
    axis): (P, N, R, order, the [P, N] and per-pod tensors, seeded,
    seed)."""
    dev = static.mask.device
    lead = static.mask.shape[:-2]          # () or (B,): the tenant axis
    P, N = static.mask.shape[-2:]
    R = snap.nodes.allocatable.shape[-1]
    order32 = order.to(torch.int32).contiguous()
    check(k, dev, order32, torch.int32, (*lead, P))
    check(k, dev, static.mask, torch.bool, (*lead, P, N))
    check(k, dev, static.score, torch.float32, (*lead, P, N))
    check(k, dev, snap.nodes.allocatable, torch.float32, (*lead, N, R))
    check(k, dev, snap.nodes.used, torch.float32, (*lead, N, R))
    check(k, dev, snap.pods.requests, torch.float32, (*lead, P, R))
    for w in (static.w_lr, static.w_ba, static.w_ts, static.w_ia):
        check(k, dev, w, torch.float32, (*lead, P))
    check(k, dev, static.rw, torch.float32, (R,))
    if R > 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes <= 8")
    ins = (order32, static.mask, static.score, snap.nodes.allocatable,
           snap.pods.requests, static.w_lr, static.w_ba, static.w_ts,
           static.w_ia, static.rw)
    return (P, N, R, *ins, int(cfg.tie_break == "seeded"),
            cfg.tie_seed & 0xFFFFFFFF)


# K4 (without preemption) spreads each tenant's nodes over a cluster of
# Q CTAs (16 is the card's non-portable cluster size) of 256, 512 or
# 1 024 threads.
SCAN_CLUSTERS = (1, 2, 4, 8, 16)
SCAN_THREADS = (256, 512, 1024)
SCAN_READ_AHEAD = 2        # nodes a thread whose rows are read a pod ahead
SCAN_MIN_NODES = 32        # nodes a CTA at least (one warp's worth)


def scan_threads(N: int, Q: int) -> int:
    """K4's threads per CTA when a tenant's N nodes are split over Q CTAs
    (a CTA's range: ceil(N / Q) nodes): 256 for one node a thread, 512
    while every node of a thread has its rows read a pod ahead (at most
    SCAN_READ_AHEAD), else 1 024. On an H100, 512 threads beat 1 024 by
    14-17 % at 640 nodes a CTA (two nodes a thread against one, with
    spills), and lost by 27 % at 5 120 (ten nodes a thread against five;
    PERF.md, solve_walls.py's k4 cells)."""
    if Q not in SCAN_CLUSTERS:
        raise ValueError(f"K4: cluster size {Q}, want one of "
                         f"{SCAN_CLUSTERS}")
    if N < 1:
        raise ValueError(f"K4: {N} nodes")
    span = -(-N // Q)
    if span <= SCAN_THREADS[0]:
        return SCAN_THREADS[0]
    return 512 if span <= 512 * SCAN_READ_AHEAD else 1024


def scan_cluster_size(B: int, N: int, sms: int) -> tuple[int, int]:
    """(Q, threads per CTA) for K4 over B tenants of N nodes on a card of
    `sms` SMs: the largest Q in SCAN_CLUSTERS with B * Q <= sms (every
    CTA on an SM of its own) and at least SCAN_MIN_NODES nodes a CTA; Q =
    1 when even B alone passes sms (the clusters then queue)."""
    if B < 1 or N < 1 or sms < 1:
        raise ValueError(f"K4: B={B}, N={N}, sms={sms}: each must be >= 1")
    Q = SCAN_CLUSTERS[-1]
    while Q > 1 and (B * Q > sms or Q * SCAN_MIN_NODES > N):
        Q //= 2
    return Q, scan_threads(N, Q)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _scan_shape(dev: torch.device, B: int, N: int,
                cluster: int | None) -> tuple[int, int]:
    """(Q, threads) of one K4 launch: the policy's, or Q forced by the
    caller (the card tests and chip_smoke hold every Q against the plain
    version). No fallback: a Q the card cannot place raises at launch."""
    if cluster is None:
        return scan_cluster_size(B, N, _sm_count(dev))
    return cluster, scan_threads(N, cluster)


def parity_scan(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
                order: torch.Tensor, cluster: int | None = None):
    """Kernel K4 on CUDA tensors (B tenants as B clusters of Q CTAs; Q
    from `scan_cluster_size`, or `cluster`), the plain version on CPU
    tensors."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_plain(cfg, snap, static, order)
    args = _scan_args("parity_scan", cfg, snap, static, order)
    used = snap.nodes.used.clone()
    assigned = torch.empty(order.shape, dtype=torch.int32, device=dev)
    chosen = torch.empty(order.shape, dtype=torch.float32, device=dev)
    if assigned.numel() == 0:
        return assigned, chosen, used
    B = order.shape[0] if order.dim() == 2 else 1
    Q, threads = _scan_shape(dev, B, args[1], cluster)
    _build.launch("tpusched_parity_scan", B, Q, threads, *ptrs(args),
                  used.data_ptr(), assigned.data_ptr(), chosen.data_ptr(),
                  stream_of(dev))
    parity_scan.launches += 1
    return assigned, chosen, used


parity_scan.launches = 0


def parity_scan_pair(cfg: EngineConfig, snap: ClusterSnapshot,
                     static: StaticCtx, order: torch.Tensor,
                     st: "kpair.PairState", dom_s: torch.Tensor,
                     cluster: int | None = None):
    """Kernel K4's pairwise variant on CUDA tensors (clusters as K4's),
    the plain version on CPU tensors: (assigned, chosen, used, final
    PairState). `st` (the initial state) is left as it was."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_pair_plain(cfg, snap, static, order, st, dom_s)
    k = "parity_scan_pair"
    args = _scan_args(k, cfg, snap, static, order)
    terms = kpair._pair_term_args(k, snap, static.aff_ok, static.sig_match,
                                  dom_s, st)
    lead = order.shape[:-1]                # () or (B,): the tenant axis
    N = args[1]
    used = snap.nodes.used.clone()
    assigned = torch.empty(order.shape, dtype=torch.int32, device=dev)
    chosen = torch.empty(order.shape, dtype=torch.float32, device=dev)
    out = kpair.copy_state(st)
    if assigned.numel() == 0:
        return assigned, chosen, used, out
    pen = torch.empty((*lead, N), dtype=torch.float32, device=dev)
    raw = torch.empty((*lead, N), dtype=torch.float32, device=dev)
    allowed = torch.empty((*lead, N), dtype=torch.uint8, device=dev)
    # The pairwise block without the state pointers, then the state the
    # kernel updates in place (the copies in `out`).
    B = lead[0] if lead else 1
    Q, threads = _scan_shape(dev, B, N, cluster)
    _build.launch("tpusched_parity_scan_pair", B, Q, threads,
                  *ptrs((*args, *terms[:-3], out.counts, out.anti,
                         out.match_tot, pen, raw, allowed, used, assigned,
                         chosen)), stream_of(dev))
    parity_scan_pair.launches += 1
    return assigned, chosen, used, out


parity_scan_pair.launches = 0


def _preempt_args(k: str, cfg: EngineConfig, snap: ClusterSnapshot,
                  static: StaticCtx, pctx: "kpre.PreemptCtx") -> tuple:
    """K4's preemption block: the victim table (K15's), each pod's
    effective priority, validity and gang, node validity, the running
    pods' nodes and required anti terms, then the device state the scan
    updates (the budgets' remaining disruptions, evicted [M] bytes, and
    the same in the victims' sorted order, K15's); with a tenant axis
    every part per tenant."""
    dev = static.mask.device
    pods, run = snap.pods, snap.running
    lead = static.mask.shape[:-2]          # () or (B,): the tenant axis
    vic = kpre._victim_args(k, cfg, snap, pctx)
    M = pctx.req_s.shape[-2]
    P, N = static.mask.shape[-2:]
    J = run.anti_sig.shape[-1]
    GP = snap.pdb_allowed.shape[-1]
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail).contiguous()
    check(k, dev, prio, torch.float32, (*lead, P))
    check(k, dev, pods.valid, torch.bool, (*lead, P))
    check(k, dev, pods.group, torch.int32, (*lead, P))
    check(k, dev, snap.nodes.valid, torch.bool, (*lead, N))
    check(k, dev, run.node_idx, torch.int32, (*lead, M))
    check(k, dev, run.anti_sig, torch.int32, (*lead, M, J))
    check(k, dev, snap.pdb_allowed, torch.float32, (*lead, GP))
    remaining = snap.pdb_allowed.clone()
    evicted = torch.zeros((*lead, M), dtype=torch.uint8, device=dev)
    return (*vic[:3], J, *vic[3:], prio, pods.valid, pods.group,
            snap.nodes.valid, run.node_idx, run.anti_sig, remaining, evicted,
            torch.zeros_like(evicted))


def _explain_out(explain: bool, lead: tuple, M: int, dev) -> tuple:
    """K4's optional explain outputs (evictor, evict_pos), -1 filled, or
    (None, None). They are solo: a tenant batch has no provenance."""
    if not explain:
        return None, None
    if lead:
        raise ValueError("K4's explain outputs take one tenant, not a batch")
    return (torch.full((M,), -1, dtype=torch.int32, device=dev),
            torch.full((M,), -1, dtype=torch.int32, device=dev))


def parity_scan_preempt(cfg: EngineConfig, snap: ClusterSnapshot,
                        static: StaticCtx, order: torch.Tensor,
                        pctx: "kpre.PreemptCtx", explain: bool = False):
    """K4's preemption variant on CUDA tensors (K15's victim search
    inside the scan; one CTA a tenant for a batch), the plain version on
    CPU tensors: (assigned, chosen, used, evicted); with explain (solo
    only) then (evictor, evict_pos), K4's optional outputs."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_preempt_plain(cfg, snap, static, order, pctx,
                                         explain)
    k = "parity_scan_preempt"
    lead = order.shape[:-1]                # () or (B,): the tenant axis
    args = _scan_args(k, cfg, snap, static, order)
    pre = _preempt_args(k, cfg, snap, static, pctx)
    used = snap.nodes.used.clone()
    assigned = torch.empty(order.shape, dtype=torch.int32, device=dev)
    chosen = torch.empty(order.shape, dtype=torch.float32, device=dev)
    evicted = pre[-2]
    ex = _explain_out(explain, lead, evicted.shape[-1], dev)
    if assigned.numel():
        _build.launch("tpusched_parity_scan_preempt", lead[0] if lead else 1,
                      *ptrs((*args, *pre, used, assigned, chosen, *ex)),
                      stream_of(dev))
        parity_scan_preempt.launches += 1
        parity_scan_preempt.explain_launches += explain
    return (assigned, chosen, used, evicted.bool()) + (ex if explain else ())


parity_scan_preempt.launches = 0
parity_scan_preempt.explain_launches = 0   # of them, with the explain outputs


def parity_scan_pair_preempt(cfg: EngineConfig, snap: ClusterSnapshot,
                             static: StaticCtx, order: torch.Tensor,
                             st: "kpair.PairState", dom_s: torch.Tensor,
                             pctx: "kpre.PreemptCtx", explain: bool = False):
    """K4's pairwise and preemption variant on CUDA tensors (one CTA a
    tenant for a batch), the plain version on CPU tensors: (assigned,
    chosen, used, final PairState, evicted), with explain (solo only)
    then (evictor, evict_pos). `st` is left as it was."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_pair_preempt_plain(cfg, snap, static, order, st,
                                              dom_s, pctx, explain)
    k = "parity_scan_pair_preempt"
    lead = order.shape[:-1]                # () or (B,): the tenant axis
    args = _scan_args(k, cfg, snap, static, order)
    terms = kpair._pair_term_args(k, snap, static.aff_ok, static.sig_match,
                                  dom_s, st)
    pre = _preempt_args(k, cfg, snap, static, pctx)
    N = args[1]
    used = snap.nodes.used.clone()
    assigned = torch.empty(order.shape, dtype=torch.int32, device=dev)
    chosen = torch.empty(order.shape, dtype=torch.float32, device=dev)
    out = kpair.copy_state(st)
    evicted = pre[-2]
    ex = _explain_out(explain, lead, evicted.shape[-1], dev)
    if assigned.numel():
        pen = torch.empty((*lead, N), dtype=torch.float32, device=dev)
        raw = torch.empty((*lead, N), dtype=torch.float32, device=dev)
        allowed = torch.empty((*lead, N), dtype=torch.uint8, device=dev)
        _build.launch("tpusched_parity_scan_pair_preempt",
                      lead[0] if lead else 1,
                      *ptrs((*args, *terms[:-3], out.counts, out.anti,
                             out.match_tot, pen, raw, allowed, *pre, used,
                             assigned, chosen, *ex)), stream_of(dev))
        parity_scan_pair_preempt.launches += 1
        parity_scan_pair_preempt.explain_launches += explain
    return (assigned, chosen, used, out, evicted.bool()) + (
        ex if explain else ())


parity_scan_pair_preempt.launches = 0
parity_scan_pair_preempt.explain_launches = 0


def solve_sequential(cfg: EngineConfig, snap: ClusterSnapshot,
                     node_sat_t: torch.Tensor | None,
                     member_sat_t: torch.Tensor | None = None,
                     ops: "Ops | None" = None,
                     static: StaticCtx | None = None,
                     explain: bool = False):
    """Exact sequential commit (stock scheduleOne semantics). With
    signatures the scan carries the pair state (K10 counts the running
    members, K4's pairwise variant adds each commit). With preemption
    and running pods, the scan runs the PostFilter victim search (K15)
    for each pod that fits nowhere; then the gang gate. static: a
    StaticCtx already made (the warm path's, from its tableau). Returns
    (assigned, chosen, used, order, evicted); explain=True appends
    (rolled [P], evictor [M], evict_round [M], auction table), JAX's
    provenance: the gang gate's rollbacks, each victim's evicting pod
    and its pop-order step (K4's explain outputs; -1 where not evicted,
    and everywhere without preemption), and an all-zero
    [_PREEMPT_MAX_ROUNDS, EXPLAIN_AUCTION_STATS] table (parity mode has
    no auction). The placements are the same either way. A tenant batch
    (a leading [B] axis) scans every tenant in one K4 launch (its
    pairwise variant with signatures, its preemption variants with each
    tenant's own victim table) and gates every tenant's gangs at
    once."""
    ops = ops or KERNELS
    if static is None:
        static = precompute_static(cfg, snap, node_sat_t, member_sat_t, ops)
    M = snap.running.valid.shape[-1]
    order = pop_order(cfg, snap)
    dev = order.device
    pctx = kpre.precompute(cfg, snap) if cfg.preemption and M else None
    evicted = torch.zeros(snap.running.valid.shape, dtype=torch.bool,
                          device=dev)
    more = ()
    st = dom_s = None
    if snap.sigs.key.shape[-1] > 0:
        dom_s = kpair.sig_domains(snap)
        st0 = ops.pair_counts(static.sig_match, dom_s, snap.running,
                              snap.pods)
        if pctx is None:
            assigned, chosen, used, st = ops.parity_scan_pair(
                cfg, snap, static, order, st0, dom_s)
        else:
            assigned, chosen, used, st, evicted, *more = (
                ops.parity_scan_pair_preempt(cfg, snap, static, order, st0,
                                             dom_s, pctx, explain=explain))
    elif pctx is None:
        assigned, chosen, used = ops.parity_scan(cfg, snap, static, order)
    else:
        assigned, chosen, used, evicted, *more = ops.parity_scan_preempt(
            cfg, snap, static, order, pctx, explain=explain)
    used, assigned, chosen, _, rolled = gang_rollback(
        snap, used, assigned, chosen, st, static.sig_match, dom_s, ops)
    if not explain:
        return assigned, chosen, used, order, evicted
    if not more:
        more = [torch.full((M,), -1, dtype=torch.int32, device=dev)
                for _ in range(2)]
    astats = torch.zeros((_PREEMPT_MAX_ROUNDS, len(EXPLAIN_AUCTION_STATS)),
                         dtype=torch.float32, device=dev)
    return assigned, chosen, used, order, evicted, (rolled, *more, astats)


# -- K5: the batched Filter + Score pass ------------------------------------


def cycle_plain(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor,
                mask: torch.Tensor, sscore: torch.Tensor, w_lr: torch.Tensor,
                w_ba: torch.Tensor, w_ts: torch.Tensor, rw: torch.Tensor,
                rows: torch.Tensor | None = None,
                pending: torch.Tensor | None = None, masked: bool = False,
                pair: tuple | None = None, w_ia: torch.Tensor | None = None,
                ia_ok: torch.Tensor | None = None):
    """(feasible, score) [rows, N] of `_cycle_nosig`: mask & fit, and
    ((w_lr*LR + w_ba*BA) + static) + w_ts*100. With pair = K11's
    (pair_ok, ts, ia) [P, N] rows (signatures), batched_cycle's: mask &
    fit & pair_ok, and (((w_lr*LR + w_ba*BA) + static) + w_ts*ts) +
    w_ia*ia. rows selects pod rows of req, mask, sscore, the weights and
    the pair rows; pending cuts rows to pending pods; masked=True gives
    where(feasible, score, -inf). With ia_ok (K11's, [P, N]) a third
    output: the spread-relaxed feasibility mask & fit & ia_ok, cut to
    pending rows (batched_cycle's return_relaxed). A tenant batch (a
    leading [B] axis on all but rw) goes tenant by tenant."""
    if mask.dim() == 3:
        return per_tenant(cycle_plain, mask.shape[0], alloc, used, req, mask,
                          sscore, w_lr, w_ba, w_ts, rw, rows, pending,
                          masked, pair, w_ia, ia_ok, shared=(8,))
    if rows is not None:
        rows = rows.long()
        req, mask, sscore = req[rows], mask[rows], sscore[rows]
        w_lr, w_ba, w_ts = w_lr[rows], w_ba[rows], w_ts[rows]
        if pair is not None:
            pair = tuple(t[rows] for t in pair)
            w_ia = w_ia[rows]
        if ia_ok is not None:
            ia_ok = ia_ok[rows]
    feasible = mask & kfilter.resource_fit(alloc, used, req)
    if pending is not None:
        feasible = feasible & pending[:, None]
    relaxed = None if ia_ok is None else feasible & ia_ok
    score = (
        w_lr[:, None] * kscore.least_requested(alloc, used, req, rw)
        + w_ba[:, None] * kscore.balanced_allocation(alloc, used, req, rw)
        + sscore
    )
    if pair is None:
        score = score + w_ts[:, None] * 100.0
    else:
        pair_ok, ts, ia = pair
        feasible = feasible & pair_ok
        score = score + w_ts[:, None] * ts + w_ia[:, None] * ia
    if masked:
        score = torch.where(feasible, score,
                            torch.full((), NEG_INF, dtype=score.dtype,
                                       device=score.device))
    return (feasible, score) if relaxed is None else (feasible, score,
                                                      relaxed)


# K5's tiles: a CTA covers CYCLE_TR rows x CYCLE_THREADS * 4 nodes.
CYCLE_TR, CYCLE_THREADS = 16, 128


def cycle_tile(N: int) -> tuple[int, int]:
    """K5's tile (rows a CTA, threads a CTA; 4 nodes a thread) for rows
    of N nodes: CYCLE_TR rows, CYCLE_THREADS threads, fewer (a multiple
    of 32) where N is narrower than the tile."""
    return CYCLE_TR, min(CYCLE_THREADS, max(32, -(-N // 128) * 32))


def cycle(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor,
          mask: torch.Tensor, sscore: torch.Tensor, w_lr: torch.Tensor,
          w_ba: torch.Tensor, w_ts: torch.Tensor, rw: torch.Tensor,
          rows: torch.Tensor | None = None,
          pending: torch.Tensor | None = None, masked: bool = False,
          pair: tuple | None = None, w_ia: torch.Tensor | None = None,
          ia_ok: torch.Tensor | None = None):
    """Kernel K5 on CUDA tensors (its tile from cycle_tile), the plain
    version on CPU tensors."""
    dev = mask.device
    if dev.type == "cpu":
        return cycle_plain(alloc, used, req, mask, sscore, w_lr, w_ba, w_ts,
                           rw, rows, pending, masked, pair, w_ia, ia_ok)
    lead = mask.shape[:-2]                 # () or (B,): the tenant axis
    P, N = mask.shape[-2:]
    R = alloc.shape[-1]
    k = "cycle"
    check(k, dev, alloc, torch.float32, (*lead, N, R))
    check(k, dev, used, torch.float32, (*lead, N, R))
    check(k, dev, req, torch.float32, (*lead, P, R))
    check(k, dev, sscore, torch.float32, (*lead, P, N))
    for w in (w_lr, w_ba, w_ts):
        check(k, dev, w, torch.float32, (*lead, P))
    check(k, dev, rw, torch.float32, (R,))
    if not 1 <= R <= 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes 1..8")
    n_rows = P if rows is None else rows.shape[-1]
    if rows is not None:
        check(k, dev, rows, torch.int32, (*lead, n_rows))
    if pending is not None:
        check(k, dev, pending, torch.bool, (*lead, n_rows))
    pair_ptrs = (None,) * 4
    if pair is not None:
        check(k, dev, pair[0], torch.bool, (*lead, P, N))
        check(k, dev, pair[1], torch.float32, (*lead, P, N))
        check(k, dev, pair[2], torch.float32, (*lead, P, N))
        check(k, dev, w_ia, torch.float32, (*lead, P))
        pair_ptrs = tuple(t.data_ptr() for t in (*pair, w_ia))
    relaxed = None
    if ia_ok is not None:
        check(k, dev, ia_ok, torch.bool, (*lead, P, N))
        relaxed = torch.empty((*lead, n_rows, N), dtype=torch.bool,
                              device=dev)
    feasible = torch.empty((*lead, n_rows, N), dtype=torch.bool, device=dev)
    score = torch.empty((*lead, n_rows, N), dtype=torch.float32, device=dev)
    out = (feasible, score) if relaxed is None else (feasible, score,
                                                     relaxed)
    if feasible.numel() == 0:
        return out
    _build.launch(
        "tpusched_cycle", lead[0] if lead else 1, n_rows, P, N, R,
        rows.data_ptr() if rows is not None else None,
        pending.data_ptr() if pending is not None else None,
        *(t.data_ptr() for t in (mask, sscore, alloc, used, req, w_lr, w_ba,
                                 w_ts, rw)),
        *pair_ptrs, int(masked), feasible.data_ptr(), score.data_ptr(),
        *ptrs((ia_ok, relaxed)),
        *cycle_tile(N),
        stream_of(dev))
    cycle.launches += 1
    if relaxed is not None:
        cycle.relaxed_launches += 1
    return out


cycle.launches = 0
cycle.relaxed_launches = 0   # of them, with the relaxed output


# -- K6: per-row top-K and the seeded tie pick ------------------------------


def row_topk_plain(masked: torch.Tensor, K: int, seeded: bool = False,
                   seed: int = 0, row_ids: torch.Tensor | None = None):
    """(topv [rows, K] f32, topi [rows, K] int32, pick [rows] int32 or
    None): the K best entries of each row, larger first and ties to the
    lower index (a stable descending sort; `torch.topk` leaves the tie
    order unspecified), and with `seeded` pick_node_batch's pick, the
    (tie_hash(seed, id) % #maxima)-th maximum in node order. A tenant
    batch [B, V, N] is ranked as its B * V rows."""
    if masked.dim() == 3:
        return _tenant_rows(row_topk_plain, masked, K, seeded, seed, row_ids)
    # + 0.0 makes -0.0 rank with +0.0, by index (a CUDA radix sort orders
    # them), as `beats` does.
    vals, idx = torch.sort(masked + 0.0, dim=1, descending=True, stable=True)
    topv = vals[:, :K].contiguous()
    topi = idx[:, :K].to(torch.int32).contiguous()
    if not seeded:
        return topv, topi, None
    ids = (torch.arange(masked.shape[0], device=masked.device)
           if row_ids is None else row_ids)
    ties = masked == topv[:, :1]
    cnt = ties.sum(dim=1).clamp_min(1)
    h = tie_hash(seed, ids) % cnt
    rank = ties.cumsum(dim=1) - 1
    pick = torch.argmax((ties & (rank == h[:, None])).to(torch.int32), dim=1)
    return topv, topi, pick.to(torch.int32)


# K6's radix path (csrc/topk.cu row_topk_radix_kernel) takes the calls
# without the seeded pick from RADIX_MIN_K up; the K-pass kernel the rest
# and every seeded pick. The cut is measured: chip_smoke's K6 phase times
# both paths on (b)'s first fast round (H100: K = 4 0.228 against 0.326
# ms, K = 8 0.384 against 0.331, K = 16 0.732 against 0.327, K = 256
# 10.93 against 0.433). The radix path's pairs fit in shared memory up
# to RADIX_MAX_K.
RADIX_MIN_K = 8
RADIX_MAX_K = 16384


def row_topk(masked: torch.Tensor, K: int, seeded: bool = False,
             seed: int = 0, row_ids: torch.Tensor | None = None):
    """Kernel K6 on CUDA tensors, the plain version on CPU tensors."""
    radix = not seeded and RADIX_MIN_K <= K <= RADIX_MAX_K
    return row_topk_path(masked, K, seeded, seed, row_ids, radix)


def row_topk_path(masked: torch.Tensor, K: int, seeded: bool = False,
                  seed: int = 0, row_ids: torch.Tensor | None = None,
                  radix: bool = False):
    """`row_topk` on the path given: the K-pass kernel, or with radix
    (not seeded, K <= RADIX_MAX_K) the radix select; the plain version on
    CPU tensors."""
    dev = masked.device
    if dev.type == "cpu":
        return row_topk_plain(masked, K, seeded, seed, row_ids)
    if masked.dim() == 3:
        return _tenant_rows(lambda m, *a: row_topk_path(m, *a, radix=radix),
                            masked, K, seeded, seed, row_ids)
    rows, N = masked.shape
    k = "row_topk"
    check(k, dev, masked, torch.float32, (rows, N))
    if not 1 <= K <= N:
        raise ValueError(f"{k}: K={K} outside 1..{N}")
    if radix and (seeded or K > RADIX_MAX_K):
        raise ValueError(f"{k}: the radix path takes K <= {RADIX_MAX_K} "
                         "without the seeded pick")
    if row_ids is not None:
        check(k, dev, row_ids, torch.int32, (rows,))
    topv = torch.empty((rows, K), dtype=torch.float32, device=dev)
    topi = torch.empty((rows, K), dtype=torch.int32, device=dev)
    pick = (torch.empty((rows,), dtype=torch.int32, device=dev) if seeded
            else None)
    if rows == 0:
        return topv, topi, pick
    if radix:
        _build.launch("tpusched_row_topk_radix", rows, N, K,
                      *ptrs((masked, topv, topi)), stream_of(dev))
        row_topk.radix_launches += 1
    else:
        _build.launch(
            "tpusched_row_topk", rows, N, K, masked.data_ptr(), int(seeded),
            seed & 0xFFFFFFFF,
            row_ids.data_ptr() if row_ids is not None else None,
            topv.data_ptr(), topi.data_ptr(),
            pick.data_ptr() if pick is not None else None, stream_of(dev))
        row_topk.launches += 1
    return topv, topi, pick


row_topk.launches = 0         # the K-pass kernel's
row_topk.radix_launches = 0   # the radix select's


def _tenant_rows(fn, masked: torch.Tensor, K: int, seeded: bool, seed: int,
                 row_ids: torch.Tensor | None):
    """K6 (or its plain version) over a tenant batch [B, V, N]: its rows
    flatten to B * V rows, each keyed by its tenant's own pod id (the row
    index within the tenant when row_ids is None)."""
    B, V, N = masked.shape
    if row_ids is None:
        row_ids = torch.arange(V, dtype=torch.int32,
                               device=masked.device).expand(B, V)
    out = fn(masked.reshape(B * V, N), K, seeded, seed,
             row_ids.reshape(B * V).contiguous())
    return tuple(None if t is None else t.reshape(B, V, *t.shape[1:])
                 for t in out)


# -- K7: node desirability --------------------------------------------------


def desirability_plain(feasible: torch.Tensor, masked: torch.Tensor,
                       allowed: torch.Tensor,
                       fixed: bool = False) -> torch.Tensor:
    """[N]: the column mean over allowed rows of where(feasible, masked,
    0), -inf where no allowed row is feasible. The column sum adds the
    rows one at a time in ascending order, as the kernel does. fixed
    (the signature path): the sum is of int32 round(x * 16) clipped to
    +-32767, over 16 * #allowed, the same at any row order or view
    width. A tenant batch [B, rows, N] gives [B, N], tenant by tenant."""
    if masked.dim() == 3:
        return per_tenant(desirability_plain, masked.shape[0], feasible,
                          masked, allowed, fixed)
    ok = feasible & allowed[:, None]
    contrib = torch.where(ok, masked, torch.zeros((), dtype=masked.dtype,
                                                  device=masked.device))
    n_allowed = allowed.sum().clamp_min(1).to(masked.dtype)
    if fixed:
        # torch.round rounds half to even, as jnp.round and CUDA's rintf
        # (not roundf).
        iq = torch.round(contrib * 16.0).clamp(-32767.0, 32767.0).to(
            torch.int32)
        mean = iq.sum(dim=0).to(masked.dtype) / (16.0 * n_allowed)
    else:
        acc = torch.zeros(masked.shape[1], dtype=masked.dtype,
                          device=masked.device)
        for p in range(masked.shape[0]):
            acc = acc + contrib[p]
        mean = acc / n_allowed
    return torch.where(ok.any(dim=0), mean,
                       torch.full((), NEG_INF, dtype=masked.dtype,
                                  device=masked.device))


def desirability(feasible: torch.Tensor, masked: torch.Tensor,
                 allowed: torch.Tensor, fixed: bool = False) -> torch.Tensor:
    """Kernel K7 on CUDA tensors, the plain version on CPU tensors."""
    dev = masked.device
    if dev.type == "cpu":
        return desirability_plain(feasible, masked, allowed, fixed)
    lead = masked.shape[:-2]               # () or (B,): the tenant axis
    rows, N = masked.shape[-2:]
    k = "desirability"
    check(k, dev, feasible, torch.bool, (*lead, rows, N))
    check(k, dev, masked, torch.float32, (*lead, rows, N))
    check(k, dev, allowed, torch.bool, (*lead, rows))
    desir = torch.empty((*lead, N), dtype=torch.float32, device=dev)
    if desir.numel() == 0:
        return desir
    # The fixed-point path's int32 partial sums (zeroed); the f32 path
    # takes none.
    work = (torch.zeros((*lead, 2 * N + 1), dtype=torch.int32, device=dev)
            if fixed else None)
    _build.launch("tpusched_desirability", lead[0] if lead else 1, rows, N,
                  feasible.data_ptr(), masked.data_ptr(), allowed.data_ptr(),
                  int(fixed), work.data_ptr() if fixed else None,
                  desir.data_ptr(), stream_of(dev))
    desirability.launches += 1
    if fixed:
        desirability.fixed_launches += 1
    return desir


desirability.launches = 0
desirability.fixed_launches = 0   # of them, in fixed point


# -- K8: the capacity-prefix commit sub-steps -------------------------------


def _scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 in the kernel's Hillis-Steele
    order: at step d every row i >= d adds row i - d."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], x[d:] + x[:-d]])
        d <<= 1
    return x


def _segment_start(keys_s: torch.Tensor) -> torch.Tensor:
    """[P] int64: for each row of the sorted keys, the index of the first
    row of its run of equal keys (along the last axis: each tenant's rows
    of a [B, P] batch on their own)."""
    P = keys_s.shape[-1]
    idx = torch.arange(P, device=keys_s.device)
    boundary = torch.ones(keys_s.shape, dtype=torch.bool,
                          device=keys_s.device)
    boundary[..., 1:] = keys_s[..., 1:] != keys_s[..., :-1]
    return torch.cummax(torch.where(boundary, idx, 0), dim=-1).values


def _segment_count(flag_s: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """[P] int32: the inclusive count of flag_s within each row's run
    (seg from _segment_start; per tenant along the last axis); integer
    sums, exact in any order."""
    cum = torch.cumsum(flag_s.to(torch.int32), dim=-1)
    return cum - torch.where(seg > 0, cum.gather(-1, (seg - 1).clamp(min=0)),
                             0)


def prefix_commit_plain(perm: torch.Tensor, cand_s: torch.Tensor,
                        requests: torch.Tensor, alloc: torch.Tensor,
                        used: torch.Tensor, choice: torch.Tensor,
                        ptr: torch.Tensor, KC: int):
    """One `_deal_commit` sub-step over the (node, rank)-sorted
    candidates (perm: sorted row -> pod row; cand_s: sorted nodes, N for
    inactive rows). Returns the new (used, choice, ptr). `used` gains
    each node's commits one at a time in ascending rank. A tenant batch
    (a leading [B] axis, perm holding each tenant's own pod indices) goes
    tenant by tenant."""
    if perm.dim() == 2:
        return per_tenant(prefix_commit_plain, perm.shape[0], perm, cand_s,
                          requests, alloc, used, choice, ptr, KC)
    P = perm.shape[0]
    N = alloc.shape[0]
    dev = perm.device
    act = cand_s < N
    node = cand_s.clamp(max=N - 1).long()
    req_s = torch.where(act[:, None], requests[perm.long()],
                        torch.zeros((), dtype=requests.dtype, device=dev))
    cum = _scan_plain(req_s)
    idx = torch.arange(P, device=dev)
    seg = _segment_start(cand_s)
    offset = torch.where((seg > 0)[:, None], cum[(seg - 1).clamp(min=0)],
                         torch.zeros((), dtype=cum.dtype, device=dev))
    within = cum - offset
    fits = (used[node] + within <= alloc[node]).all(dim=-1) & act
    bad = act & ~fits
    last_bad = torch.cummax(torch.where(bad, idx, -1), dim=0).values
    commit = fits & (last_bad < seg)
    q = perm.long()
    choice = choice.clone()
    choice[q[commit]] = cand_s[commit]
    ptr = ptr.clone()
    ptr[q[bad]] += 1
    ptr[q[commit]] = KC
    used = used.clone()
    pos = idx - seg
    j = 0
    while True:
        sel = commit & (pos == j)
        if not bool(sel.any()):
            break
        used[node[sel]] = used[node[sel]] + req_s[sel]
        j += 1
    return used, choice, ptr


def prefix_commit_loop_plain(topi: torch.Tensor, topv: torch.Tensor,
                             allowed: torch.Tensor, rank: torch.Tensor,
                             requests: torch.Tensor, alloc: torch.Tensor,
                             used: torch.Tensor, step=prefix_commit_plain):
    """JAX `_deal_commit`'s commit while_loop (tpusched/kernels/assign.py
    :888-957): each row walks its candidate list topi / topv [.., P, KC]
    (the dealt node, then its top-K) while it is allowed, uncommitted and
    its candidate is finite; a sub-step sorts the active rows by (node,
    rank) (a stable sort of one int64 key, inactive rows last with node
    N) and commits through `step` (prefix_commit_plain, or a recording
    stand-in through the Ops table). Returns (used, choice, steps):
    choice [.., P] the committed node or -1, steps [..] the sub-steps each
    tenant ran. A tenant batch runs while any tenant has an active row; a
    tenant without one goes through the shared sub-steps unchanged. The
    loop reads its flag on the host but counts no host read: the kernel
    runs it on the card."""
    lead = rank.shape[:-1]                 # () or (B,): the tenant axis
    P = rank.shape[-1]
    KC = topi.shape[-1]
    N = alloc.shape[-2]
    dev = rank.device
    choice = torch.full((*lead, P), -1, dtype=torch.int32, device=dev)
    ptr = torch.zeros((*lead, P), dtype=torch.int32, device=dev)
    steps = torch.zeros(lead, dtype=torch.int32, device=dev)
    rank64 = rank.long()
    while True:
        ptr_c = ptr.clamp(0, KC - 1).long()[..., None]
        cand = topi.gather(-1, ptr_c)[..., 0]
        cand_ok = topv.gather(-1, ptr_c)[..., 0] > NEG_INF
        active = allowed & (choice < 0) & (ptr < KC) & cand_ok
        going = active.any(dim=-1)
        if not bool(going.any()):
            return used, choice, steps
        steps = steps + going.to(torch.int32)
        cand_m = torch.where(active, cand, N)
        perm = torch.sort((cand_m.long() << 32) + rank64, dim=-1,
                          stable=True).indices
        used, choice, ptr = step(perm.to(torch.int32),
                                 cand_m.gather(-1, perm).contiguous(),
                                 requests, alloc, used, choice, ptr, KC)


def prefix_commit_loop_smem_bytes(P: int, N: int) -> int:
    """Bytes of the loop kernel's state for one tenant: the (rank, row)
    keys, the scan's two f32 buffers, each node's bucket end and first
    non-fitting row, the list of long buckets, each row's pointer and fit
    flag (csrc/commit.cu). They live in shared memory up to
    NODE_ADD_SMEM_MAX, else in global scratch."""
    return P * 18 + (2 * N + P // 32 + 2) * 4


def prefix_commit_loop(topi: torch.Tensor, topv: torch.Tensor,
                       allowed: torch.Tensor, rank: torch.Tensor,
                       requests: torch.Tensor, alloc: torch.Tensor,
                       used: torch.Tensor, step=prefix_commit_plain):
    """Kernel K8 on CUDA tensors (one launch runs every sub-step of the
    round, one CTA a tenant; `step` is not used), the plain loop on CPU
    tensors (through `step`)."""
    dev = rank.device
    if dev.type == "cpu":
        return prefix_commit_loop_plain(topi, topv, allowed, rank, requests,
                                        alloc, used, step)
    lead = tuple(rank.shape[:-1])          # () or (B,): the tenant axis
    P = rank.shape[-1]
    KC = topi.shape[-1]
    N, R = alloc.shape[-2:]
    k = "prefix_commit_loop"
    if not 1 <= R <= 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes 1..8")
    if not 1 <= KC <= 255:
        raise ValueError(f"{k}: {KC} candidates a row, the kernel takes "
                         "1..255")
    check(k, dev, topi, torch.int32, (*lead, P, KC))
    check(k, dev, topv, torch.float32, (*lead, P, KC))
    check(k, dev, allowed, torch.bool, (*lead, P))
    check(k, dev, rank, torch.int32, (*lead, P))
    check(k, dev, requests, torch.float32, (*lead, P, R))
    check(k, dev, alloc, torch.float32, (*lead, N, R))
    check(k, dev, used, torch.float32, (*lead, N, R))
    out = torch.empty_like(used)
    choice = torch.empty((*lead, P), dtype=torch.int32, device=dev)
    steps = torch.empty(lead, dtype=torch.int32, device=dev)
    if P == 0 or N == 0:
        out.copy_(used)
        choice.fill_(-1)
        steps.zero_()
        return out, choice, steps
    B = lead[0] if lead else 1
    smem = prefix_commit_loop_smem_bytes(P, N) <= NODE_ADD_SMEM_MAX
    scratch = (None,) * 4
    if not smem:
        scratch = (torch.empty((B, P), dtype=torch.int64, device=dev),
                   torch.empty((B, 2 * N + P // 32 + 2), dtype=torch.int32,
                               device=dev),
                   torch.empty((B, 2 * P), dtype=torch.float32, device=dev),
                   torch.empty((B, 2 * P), dtype=torch.uint8, device=dev))
    _build.launch("tpusched_prefix_commit_loop", B, P, N, R, KC,
                  *ptrs((topi, topv, allowed, rank, requests, alloc, used,
                         out, choice, steps, int(smem), *scratch)),
                  stream_of(dev))
    prefix_commit_loop.launches += 1
    return out, choice, steps


prefix_commit_loop.launches = 0


def _by_node_rank(node: torch.Tensor, mask: torch.Tensor, rank: torch.Tensor,
                  N: int):
    """The masked rows sorted by (node, rank), masked-out rows last with
    node N (a library sort on one int64 key, as the sub-steps sort):
    (perm [P] int32 sorted row -> pod row, sorted nodes [P] int32). A
    tenant batch [B, P] sorts each tenant's rows on their own."""
    node_m = torch.where(mask, node.clamp(0, N - 1),
                         torch.full((), N, dtype=node.dtype,
                                    device=node.device))
    perm = torch.sort((node_m.long() << 32) + rank.long(), dim=-1,
                      stable=True).indices
    return (perm.to(torch.int32),
            node_m.gather(-1, perm).to(torch.int32).contiguous())


def node_add_plain(used: torch.Tensor, node: torch.Tensor,
                   mask: torch.Tensor, requests: torch.Tensor,
                   rank: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """JAX `_node_add`: used[node[p]] += sign * requests[p] for the masked
    rows, per node one row at a time in ascending rank, ties by row index
    (the sub-steps' order; JAX adds each node's segment total, a
    different association).
    The order depends on ranks alone, so a compacted view adds what the
    full width adds. A tenant batch goes tenant by tenant."""
    if used.dim() == 3:
        return per_tenant(node_add_plain, used.shape[0], used, node, mask,
                          requests, rank, sign)
    N = used.shape[0]
    perm, node_s = _by_node_rank(node, mask, rank, N)
    act = node_s < N
    node_s64 = node_s.clamp(max=N - 1).long()
    pos = torch.arange(perm.shape[0], device=perm.device) - _segment_start(
        node_s)
    req_s = requests[perm.long()] * sign
    used = used.clone()
    j = 0
    while True:
        sel = act & (pos == j)
        if not bool(sel.any()):
            break
        used[node_s64[sel]] = used[node_s64[sel]] + req_s[sel]
        j += 1
    return used


# A CTA's shared memory on the H100 (227 KB), less its static part.
NODE_ADD_SMEM_MAX = 232448 - 1024


def node_add_smem_bytes(P: int, N: int) -> int:
    """Bytes of node_add's buckets for one tenant: a 64-bit (rank, row) key
    per row, each node's bucket end and the list of long buckets
    (csrc/commit.cu). They live in shared memory up to NODE_ADD_SMEM_MAX,
    else in global scratch."""
    return P * 8 + (N + P // 32 + 2) * 4


def _rows_stride(k: str, dev: torch.device, t: torch.Tensor,
                 dtype: torch.dtype, lead: tuple, P: int) -> int:
    """Check a [.., P] row argument of node_add (on `dev`, of `dtype`,
    unit stride along P) and return its tenant stride: 0 for one row
    that every tenant shares, as the gang gate's expanded rank is."""
    if t.device != dev:
        raise ValueError(f"{k}: tensor on {t.device}, want {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{k}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != (*lead, P) or t.stride(-1) != 1:
        raise ValueError(f"{k}: shape {tuple(t.shape)} stride {t.stride()}"
                         f", want {(*lead, P)} with unit stride along P")
    return t.stride(0) if lead else 0


def node_add(used: torch.Tensor, node: torch.Tensor, mask: torch.Tensor,
             requests: torch.Tensor, rank: torch.Tensor,
             sign: float = 1.0) -> torch.Tensor:
    """K8's node_add entry point on CUDA tensors (one launch on the
    unsorted rows: the kernel orders each node's rows by (rank, row) and
    writes a new usage table), the plain version on CPU tensors."""
    dev = used.device
    if dev.type == "cpu":
        return node_add_plain(used, node, mask, requests, rank, sign)
    lead = tuple(used.shape[:-2])          # () or (B,): the tenant axis
    P = node.shape[-1]
    N, R = used.shape[-2:]
    k = "node_add"
    if sign not in (1.0, -1.0):
        raise ValueError(f"{k}: sign {sign}, want +1 or -1")
    if not 1 <= R <= 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes 1..8")
    check(k, dev, requests, torch.float32, (*lead, P, R))
    check(k, dev, used, torch.float32, (*lead, N, R))
    node_bs = _rows_stride(k, dev, node, torch.int32, lead, P)
    mask_bs = _rows_stride(k, dev, mask, torch.bool, lead, P)
    rank_bs = _rows_stride(k, dev, rank, torch.int32, lead, P)
    out = torch.empty_like(used)
    B = lead[0] if lead else 1
    if out.numel() == 0:
        return out
    smem = node_add_smem_bytes(P, N) <= NODE_ADD_SMEM_MAX
    keys = ints = None
    if not smem:
        keys = torch.empty((B, P), dtype=torch.int64, device=dev)
        ints = torch.empty((B, N + P // 32 + 2), dtype=torch.int32,
                           device=dev)
    _build.launch("tpusched_node_add", B, P, N, R,
                  *ptrs((node, node_bs, mask, mask_bs, rank, rank_bs,
                         requests, int(sign), used, out, int(smem), keys,
                         ints)), stream_of(dev))
    node_add.launches += 1
    return out


node_add.launches = 0


# -- ScoreBatch ---------------------------------------------------------------


def batched_cycle(cfg: EngineConfig, snap: ClusterSnapshot,
                  static: StaticCtx, used: torch.Tensor,
                  masked: bool = False, ops: "Ops | None" = None,
                  pair_st: "kpair.PairState | None" = None,
                  pending: torch.Tensor | None = None,
                  return_relaxed: bool = False):
    """Full [P, N] Filter + Score against `used` and the pair state (K5).
    With no pairwise signature the spread and inter-pod normalisers are
    the constants 100 and 0, so the score is the oracle's sum without
    [P, N] pairwise work; with signatures K11 evaluates every pod's
    pairwise row against `pair_st` first. masked=True returns
    where(feasible, score, -inf) as the score; pending cuts rows to
    pending pods. return_relaxed (signatures; the fast rounds) adds the
    SPREAD-RELAXED feasibility, every predicate but the DoNotSchedule
    skew filter (K11's ia_ok into K5), which the water-fill dealer
    targets. A tenant batch runs K11 and K5 once for all tenants."""
    ops = ops or KERNELS
    nodes, pods = snap.nodes, snap.pods
    pair = ia_ok = None
    if snap.sigs.key.shape[-1] > 0:
        pair = ops.pairwise_batch(snap, pair_st, static.aff_ok,
                                  static.sig_match, kpair.sig_domains(snap),
                                  with_ia_ok=return_relaxed)
        if return_relaxed:
            pair, ia_ok = pair[:3], pair[3]
    out = ops.cycle(nodes.allocatable, used, pods.requests, static.mask,
                    static.score, static.w_lr, static.w_ba, static.w_ts,
                    static.rw, pending=pending, masked=masked, pair=pair,
                    w_ia=static.w_ia, ia_ok=ia_ok)
    if return_relaxed and ia_ok is None:   # S = 0: nothing to relax
        return out[0], out[1], out[0]
    return out


def score_batch(cfg: EngineConfig, snap: ClusterSnapshot,
                node_sat_t: torch.Tensor,
                member_sat_t: torch.Tensor | None = None,
                masked: bool = False, ops: "Ops | None" = None):
    """One-shot [P, N] feasibility + scores against the snapshot's usage
    (no commits): the ScoreBatch surface, against the pair state of the
    running members (K10; none at S = 0)."""
    ops = ops or KERNELS
    static = precompute_static(cfg, snap, node_sat_t, member_sat_t, ops)
    st0 = None
    if snap.sigs.key.shape[-1] > 0:
        st0 = ops.pair_counts(static.sig_match, kpair.sig_domains(snap),
                              snap.running, snap.pods)
    return batched_cycle(cfg, snap, static, snap.nodes.used, masked, ops,
                         st0)


def pick_node_batch(cfg: EngineConfig, masked: torch.Tensor,
                    pod_idx: torch.Tensor, ops: "Ops | None" = None):
    """Row-wise seeded pick among each row's maxima, hashed by the
    ORIGINAL pod index (K6's pick); None for tie_break='first'. The fast
    rounds take it from the same K6 call as their top-K."""
    if cfg.tie_break == "first":
        return None
    ops = ops or KERNELS
    return ops.row_topk(masked, 1, True, cfg.tie_seed,
                        pod_idx.to(torch.int32))[2]


# -- fast mode: commit rounds without signatures ------------------------------


class RoundStats:
    """What the host did during one fast solve: the device flags the
    round loops read (`host_reads`: one per round, per tranche, per
    validation pass and per full-width/compacted hand-off; a round's
    commit sub-steps run inside one K8 launch and read nothing), and,
    with `timing` (CUDA only), CUDA-event spans by stage name, read back
    by `ms()`, and K8's sub-step counts, summed by `substeps()`."""

    def __init__(self, timing: bool = False):
        self.host_reads = 0
        # Of them, the preemption rounds' (fast mode with preemption),
        # and those rounds' count.
        self.preempt_reads = 0
        self.preempt_rounds = 0
        self._spans: dict[str, list] | None = {} if timing else None
        self._steps: list[torch.Tensor] | None = [] if timing else None

    def read(self, flag: torch.Tensor) -> bool:
        self.host_reads += 1
        return bool(flag)

    def read_each(self, flags: torch.Tensor) -> np.ndarray:
        """A tenant batch's [B] flags in one read."""
        self.host_reads += 1
        return flags.cpu().numpy()

    @contextlib.contextmanager
    def span(self, name: str):
        if self._spans is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._spans.setdefault(name, []).append((start, end))

    def ms(self) -> dict[str, float]:
        """Total device ms and count of each span (synchronises)."""
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in (self._spans or {}).items()}

    def counts(self) -> dict[str, int]:
        return {k: len(v) for k, v in (self._spans or {}).items()}

    def count_substeps(self, steps: torch.Tensor) -> None:
        """Keep a K8 call's [B] sub-step counts (device tensors; timing
        only)."""
        if self._steps is not None:
            self._steps.append(steps)

    def substeps(self) -> int:
        """K8's sub-steps over the solve, summed over tenants (one read
        after the solve, none during it)."""
        if not self._steps:
            return 0
        return int(torch.stack([t.sum() for t in self._steps]).sum())


def _fallback_depth(N: int) -> int:
    """Per-pod fallback-candidate depth K of the dealing commits: 16 (or
    N) on clusters of at most 256 nodes, 8 above."""
    return min(16, N) if N <= 256 else 8


# Residual compaction width: after the full-width round 1, tranches of
# the _RESIDUAL_CAP best-ranked pending pods run [C, N] views to
# fixpoint. As in the JAX package this is not bitwise equal to
# full-width rounds (the desirability mean reduces over a different row
# set), only valid and near-equal in placed count.
_RESIDUAL_CAP = 1024


def _top_by_rank(pend: torch.Tensor, order: torch.Tensor, C: int):
    """The C lowest-rank True pods of `pend`, ascending by rank, then the
    non-pending pods by rank (every slot a distinct pod), plus the
    number of True pods. Sortless: int prefix sums over the pop order."""
    assert C <= order.shape[0], (C, order.shape)
    pend_rm = pend[order]                                    # rank-major
    cpend = torch.cumsum(pend_rm.to(torch.int32), dim=0)
    cnon = torch.cumsum((~pend_rm).to(torch.int32), dim=0)
    n_pend = cpend[-1]
    slot = torch.where(pend_rm, cpend - 1, n_pend + cnon - 1)
    take = slot < C
    buf = torch.zeros(C, dtype=order.dtype, device=order.device)
    buf[slot[take].long()] = order[take]
    return buf, n_pend


def top_by_rank_plain(pend: torch.Tensor, order: torch.Tensor, C: int):
    """K24's plain version: `_top_by_rank`, tenant by tenant for a batch
    ([B, P] pend and order give [B, C] slots and [B] counts)."""
    if pend.dim() == 2:
        return per_tenant(_top_by_rank, pend.shape[0], pend, order, C)
    return _top_by_rank(pend, order, C)


def top_by_rank(pend: torch.Tensor, order: torch.Tensor, C: int):
    """Kernel K24 on CUDA tensors, the plain version on CPU tensors."""
    dev = pend.device
    if dev.type == "cpu":
        return top_by_rank_plain(pend, order, C)
    lead = pend.shape[:-1]                 # () or (B,): the tenant axis
    P = pend.shape[-1]
    k = "top_by_rank"
    if not 1 <= C <= P:
        raise ValueError(f"{k}: C={C} outside 1..{P}")
    check(k, dev, pend, torch.bool, (*lead, P))
    check(k, dev, order, torch.int64, (*lead, P))
    buf = torch.empty((*lead, C), dtype=torch.int64, device=dev)
    n_pend = torch.empty(lead, dtype=torch.int64, device=dev)
    _build.launch("tpusched_top_by_rank", lead[0] if lead else 1, P, C,
                  *ptrs((pend, order, buf, n_pend)), stream_of(dev))
    top_by_rank.launches += 1
    return buf, n_pend


top_by_rank.launches = 0


def _deal_prefixes(dem: torch.Tensor, rem: torch.Tensor):
    """Inclusive prefix sums along dim 0 of the dealing's demand [P, R]
    and remaining capacity [N, R], in _scan_plain's fixed Hillis-Steele
    order, which gives the same bits on every device (torch.cumsum
    accumulates f32 in double on the CPU and runs a parallel scan on
    CUDA). Both run as the columns of one scan: a row's sum only reads
    rows above it, so the zero rows that pad the shorter one change
    nothing, and the scan's launches are paid once."""
    P, R = dem.shape
    L = max(P, rem.shape[0])
    both = dem.new_zeros((L, 2 * R))
    both[:P, :R] = dem
    both[:rem.shape[0], R:] = rem
    both = _scan_plain(both)
    return both[:P, :R], both[:rem.shape[0], R:]


def deal_plain(dem: torch.Tensor, rem: torch.Tensor,
               gather: torch.Tensor | None = None) -> torch.Tensor:
    """K23's plain version: each pod's dealt position, [P] int64 (JAX
    `_deal_commit`'s dealing). The inclusive prefixes of the demand dem
    [L, R] and of the remaining capacity rem [N, R] (nodes by descending
    desirability) come from `_deal_prefixes`; with my_dem the demand
    prefix at row gather[p] (rows scattered by rank; gather None: row
    p), the position is the largest over r of the left searchsorted of
    my_dem[p, r] in the capacity prefix's column r. A tenant batch goes
    tenant by tenant."""
    if rem.dim() == 3:
        return per_tenant(deal_plain, rem.shape[0], dem, rem, gather)
    my_dem, cum_rem = _deal_prefixes(dem, rem)
    if gather is not None:
        my_dem = my_dem[gather]
    pos = torch.zeros(my_dem.shape[0], dtype=torch.int64, device=dem.device)
    for r in range(cum_rem.shape[1]):
        pos = torch.maximum(pos, torch.searchsorted(
            cum_rem[:, r].contiguous(), my_dem[:, r].contiguous()))
    return pos


# The scan's double buffer of 2 * max(L, N) floats must fit a block's
# shared memory (227 KB on Hopper).
_DEAL_SMEM = 232448


def deal(dem: torch.Tensor, rem: torch.Tensor,
         gather: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K23 on CUDA tensors, the plain version on CPU tensors."""
    dev = rem.device
    if dev.type == "cpu":
        return deal_plain(dem, rem, gather)
    lead = rem.shape[:-2]                  # () or (B,): the tenant axis
    L, R = dem.shape[-2:]
    N = rem.shape[-2]
    P = L if gather is None else gather.shape[-1]
    k = "deal"
    check(k, dev, dem, torch.float32, (*lead, L, R))
    check(k, dev, rem, torch.float32, (*lead, N, R))
    if gather is not None:
        check(k, dev, gather, torch.int64, (*lead, P))
    if 8 * max(L, N) > _DEAL_SMEM:
        raise ValueError(f"{k}: {max(L, N)} rows, the scan takes at most "
                         f"{_DEAL_SMEM // 8}")
    pos = torch.empty((*lead, P), dtype=torch.int64, device=dev)
    if pos.numel() == 0:
        return pos
    cum_dem = torch.empty((*lead, R, L), dtype=torch.float32, device=dev)
    cum_rem = torch.empty((*lead, R, N), dtype=torch.float32, device=dev)
    _build.launch("tpusched_deal", lead[0] if lead else 1, P, L, N, R,
                  *ptrs((dem, rem, gather, cum_dem, cum_rem, pos)),
                  stream_of(dev))
    deal.launches += 1
    return pos


deal.launches = 0


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Indices of x by descending value along its last axis, ties in
    index order (JAX's stable argsort of -x). Adding 0.0 turns -0.0 into
    +0.0 first: JAX's sort compares the two zeros equal, CUDA's radix sort
    of floats would put -0.0 first."""
    return torch.sort(-x + 0.0, dim=-1, stable=True).indices


def _deal_commit(alloc, requests, used, feasible, masked, allowed, rank,
                 topv, topi, tie_pick=None, rank_is_sorted: bool = False,
                 ops: "Ops | None" = None,
                 stats: RoundStats | None = None, override=None,
                 score_full=None, cum_width: int | None = None):
    """One round's dealing + capacity-prefix conflict resolution +
    rescue (JAX `_deal_commit`), over any pod-axis width. topv/topi:
    each row's top-K of `masked` (K6, ties to the lower index). Returns
    (used2, choice, chosen_val); choice[p] = committed node or -1.

    Dealing (K23): the q-th allowed pod by rank targets the node where
    the cumulative remaining capacity (nodes by descending desirability,
    K7) first covers the cumulative demand of pods 0..q, for every
    resource. The dealt node (when feasible) leads each pod's candidate
    list, then its own top-K; capacity sub-steps (K8, all of a round's in
    one launch) commit, per node, the longest rank-ordered prefix that
    fits. If nothing committed while an allowed pod is still feasible
    somewhere, the best-ranked such pod is committed at its own top
    choice (the rescue), so every round places a pod until nothing
    pending is placeable.

    The signature path passes override = K12's (cand, val, ok): a spread
    member's whole candidate list becomes its in-domain rotation; its
    relaxed placements are -inf in `masked`, so chosen_val comes from
    score_full. It also passes cum_width = P, the frontier-compaction
    contract: a compacted [F, N] call must give the full-width call's
    bits. So every f32 reduction over the pod axis is width-invariant:
    the desirability is K7's int32 fixed-point sum (K7's f32 sum adds
    rows in row order, and a view's rows are other rows than the full
    width's), and the demand prefix runs over a [cum_width, R] array
    with each pod's demand at its GLOBAL rank (zeros elsewhere), not
    over the view's rows (the S = 0 tranches' rank_is_sorted shortcut).
    K8 needs nothing: its Hillis-Steele prefix over the front-packed
    active rows gives row i a sum of rows <= i only, and its `used` adds
    go in rank order.

    A tenant batch (tenants.solve_many) carries a leading [B] axis on
    every tensor: each kernel launches once for all tenants, each
    tenant's sub-steps run until it has no active candidate (no host
    read), and the rescue is per tenant; a tenant with no allowed pod
    keeps its `used` bit for bit."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    lead = rank.shape[:-1]                 # () or (B,): the tenant axis
    P = rank.shape[-1]
    N, R = alloc.shape[-2:]
    dev = requests.device
    # Index of each tenant's row x[b, i[b]] (x[i] without a tenant axis).
    at = ((lambda i: (torch.arange(lead[0], device=dev), i)) if lead
          else (lambda i: (i,)))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    with stats.span("K7 desirability"):
        if cum_width is None:
            desir = ops.desirability(feasible, masked, allowed)
        else:
            desir = ops.desirability(feasible, masked, allowed, fixed=True)
    node_order = _desc_order(desir)
    remaining = (alloc - used).clamp_min(0.0)
    remaining = torch.where(torch.isfinite(desir)[..., None], remaining, zero)
    rem_s = remaining.gather(-2, node_order[..., None].expand(*lead, N, R))
    # Inclusive cumulative demand of allowed pods in rank order.
    dem = torch.where(allowed[..., None], requests, zero)
    with stats.span("K23 deal"):
        if rank_is_sorted and cum_width is None:
            pos = ops.deal(dem, rem_s)
        else:
            rank64 = rank.long()
            rm = dem.new_zeros((*lead, P if cum_width is None else cum_width,
                                R))
            rm.scatter_(-2, rank64[..., None].expand(*lead, P, R), dem)
            pos = ops.deal(rm, rem_s, rank64)
    dealt = node_order.gather(-1, pos.clamp(0, N - 1))
    dealt_ok = feasible.gather(-1, dealt[..., None])[..., 0]
    first_best = topi[..., 0]    # lowest-index maximum (jnp.argmax)
    if tie_pick is not None:
        # The seeded pick leads the pod's own list (same max score).
        tp_val = masked.gather(-1, tie_pick.long()[..., None])[..., 0]
        topi = torch.cat([tie_pick[..., None], topi[..., 1:]], dim=-1)
        topv = torch.cat([tp_val[..., None], topv[..., 1:]], dim=-1)
    dealt_score = masked.gather(-1, dealt[..., None])[..., 0]
    use_dealt = dealt_ok
    if tie_pick is not None:
        # A dealt node that merely ties the pod's max yields to the hash
        # pick; a strictly lower-scored one keeps its slot.
        use_dealt = dealt_ok & (dealt_score < topv[..., 0])
    topi = torch.cat([torch.where(use_dealt, dealt.to(torch.int32),
                                  topi[..., 0])[..., None], topi], dim=-1)
    topv = torch.cat([torch.where(use_dealt, dealt_score,
                                  topv[..., 0])[..., None], topv], dim=-1)
    if override is not None:
        cand, val, ok = override
        topi = torch.where(ok[..., None], cand, topi)
        topv = torch.where(ok[..., None], val, topv)

    with stats.span("K8 prefix_commit_loop"):
        used_j, choice, steps = ops.prefix_commit_loop(
            topi, topv, allowed, rank, requests, alloc, used,
            ops.prefix_commit)
    stats.count_substeps(steps)

    # Rescue: the best-ranked allowed pod that is still feasible
    # somewhere. Without signatures `allowed` is any(feasible, 1), the
    # JAX code's `allowed & want`; with them it also holds water-fill
    # members that only the relaxed rows admit.
    commit = choice >= 0
    want = allowed if cum_width is None else allowed & feasible.any(dim=-1)
    can_rescue = ~commit.any(dim=-1) & want.any(dim=-1)
    BIG = torch.iinfo(torch.int32).max
    p_star = torch.argmin(torch.where(want, rank, torch.full_like(rank, BIG)),
                          dim=-1)
    n_star = (tie_pick if tie_pick is not None else first_best)[
        at(p_star)].long()
    used_j = used_j.clone()
    used_j[at(n_star)] = torch.where(
        can_rescue[..., None], used_j[at(n_star)] + requests[at(p_star)],
        used_j[at(n_star)])
    choice[at(p_star)] = torch.where(can_rescue, n_star.to(torch.int32),
                                     choice[at(p_star)])
    chosen_val = (masked if score_full is None else score_full).gather(
        -1, choice.clamp(0, N - 1).long()[..., None])[..., 0]
    return used_j, choice, chosen_val


@dataclasses.dataclass
class _View:
    """The pod rows one commit loop runs over, per tenant [B, V]: all P
    pods (rows None) or a tranche (rows = the pod indices, ascending by
    rank)."""

    rows: torch.Tensor | None
    req: torch.Tensor          # [B, V, R] the rows' requests
    valid: torch.Tensor        # [B, V] bool
    rank: torch.Tensor         # [B, V] int32 global rank
    pod_ids: torch.Tensor      # [B, V] int32 original pod index
    rank_is_sorted: bool


def _round_nosig(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
                 view: _View, K: int, st, r: torch.Tensor,
                 live: torch.Tensor, ops: "Ops", stats: RoundStats):
    """One commit round over a view (`_make_round_nosig`'s body) for the
    live tenants (live [B] bool; r [B] int32 their round numbers):
    returns the new (used, assigned, chosen, round_of) and the [B] flag
    `any commit and not all done`. A tenant that is not live has no
    pending row, so nothing commits or rescues there and its state stays
    as it was, bit for bit."""
    used, asg, chosen, rnd = st
    nodes = snap.nodes
    pending = (asg == -1) & view.valid & live[:, None]
    with stats.span("K5 cycle"):
        feasible, masked = ops.cycle(
            nodes.allocatable, used, snap.pods.requests, static.mask,
            static.score, static.w_lr, static.w_ba, static.w_ts, static.rw,
            rows=view.rows, pending=pending, masked=True)
    with stats.span("K6 row_topk"):
        topv, topi, pick = ops.row_topk(masked, K, cfg.tie_break == "seeded",
                                        cfg.tie_seed, view.pod_ids)
    allowed = topv[..., 0] > NEG_INF   # any(feasible, 1): scores are finite
    used2, choice, chosen_val = _deal_commit(
        nodes.allocatable, view.req, used, feasible, masked, allowed,
        view.rank, topv, topi, tie_pick=pick,
        rank_is_sorted=view.rank_is_sorted, ops=ops, stats=stats)
    commit = choice >= 0
    asg2 = torch.where(commit, choice, asg)
    chosen2 = torch.where(commit, chosen_val, chosen)
    rnd2 = torch.where(commit, r[:, None], rnd)
    all_done = ((asg2 >= 0) | ~view.valid).all(dim=-1)
    return (used2, asg2, chosen2, rnd2), commit.any(dim=-1) & ~all_done


def _run_rounds(cfg, snap, static, view, K, st, r: torch.Tensor, steps: int,
                live: torch.Tensor, ops: "Ops", stats: RoundStats):
    """Rounds for each live tenant while its last round made progress, at
    most `steps` of them: the JAX while_loop, vmapped, so a step runs
    while any tenant's predicate holds (one host read a step; none
    before the first) and the others keep their state. r [B] gains the
    rounds each tenant ran. Returns (state, r, steps run)."""
    n = 0
    while n < steps and (n == 0 or stats.read(live.any())):
        st, progress = _round_nosig(cfg, snap, static, view, K, st, r, live,
                                    ops, stats)
        r = r + live.to(torch.int32)
        live = live & progress
        n += 1
    return st, r, n


def _solve_rounds_nosig(cfg: EngineConfig, snap: ClusterSnapshot,
                        static: StaticCtx, rank: torch.Tensor,
                        order: torch.Tensor, max_rounds: int, K: int,
                        cap: int | None = None, ops: "Ops | None" = None,
                        stats: RoundStats | None = None, init=None,
                        skip_full: bool = False):
    """Fast-mode rounds with NO pairwise signatures. Returns (used,
    assigned, chosen, round_of, rounds).

    P <= 2C (or <= cap): full-width rounds to fixpoint. Larger: one
    full-width round 1, then tranches: the C best-ranked still-unspent
    pending pods (K24) run [C, N] views for up to tranche_cap rounds (4;
    2 with preemption); a view pod left unplaced with no feasible node
    against the tranche-final state is spent (capacity only shrinks
    here, so for good). With cfg.preemption there is no round 1 (as in
    JAX: the cluster is near capacity, round 1 places little, and the
    preemption drain re-examines every straggler). cap: explicit
    tranche width C.

    init: a seeded ((used, assigned, chosen, round_of), r), the
    incremental path's carried placements already committed, rounds
    counted from r; skip_full skips the full-width round 1 (a small
    frontier places more cheaply through the tranches). Without init
    the rounds start from the snapshot at r = 0.

    A tenant batch (a batched snapshot and StaticCtx, [B, P] rank and
    order) runs every tenant's loops at once, as jax.vmap runs JAX's
    nested while_loops: a loop step runs while any tenant's predicate
    holds, with one host read a step for all of them, and a tenant whose
    predicate is false keeps its state, its spent pods and its own round
    counter; rounds is then that [B] int32 counter. The solo shapes run
    as a batch of one, rounds an int."""
    if rank.dim() == 1:
        if init is not None:
            init = (tuple(t.unsqueeze(0) for t in init[0]), init[1])
        out = _rounds_nosig(cfg, snap.as_batch(), static.as_batch(),
                            rank[None], order[None], max_rounds, K, cap,
                            ops, stats, init, skip_full)
        return (*(t[0] for t in out[:4]), out[5])
    return _rounds_nosig(cfg, snap, static, rank, order, max_rounds, K, cap,
                         ops, stats, init, skip_full)[:5]


def _rounds_nosig(cfg, snap, static, rank, order, max_rounds, K, cap, ops,
                  stats, init, skip_full):
    """_solve_rounds_nosig over a tenant batch: (used, assigned, chosen,
    round_of, rounds [B], the steps the host ran), the last equal to
    every tenant's rounds when B = 1."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    pods, nodes = snap.pods, snap.nodes
    B, P = rank.shape
    dev = rank.device
    C = _RESIDUAL_CAP if cap is None else max(1, min(cap, P))
    ids = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    full = _View(None, pods.requests, pods.valid, rank, ids, False)
    st = (nodes.used, torch.full((B, P), -1, dtype=torch.int32, device=dev),
          torch.full((B, P), NEG_INF, dtype=torch.float32, device=dev),
          torch.full((B, P), -1, dtype=torch.int32, device=dev))
    steps = 0
    if init is not None:
        st, steps = init
    r = torch.full((B,), steps, dtype=torch.int32, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    if P <= (2 * C if cap is None else C):
        with stats.span("direct rounds"):
            st, r, n = _run_rounds(cfg, snap, static, full, K, st, r,
                                   max_rounds - steps, live, ops, stats)
        return (*st, r, steps + n)

    progress = live      # the tranche loop's initial True
    if not (skip_full or cfg.preemption):
        with stats.span("round 1"):
            st, progress = _round_nosig(cfg, snap, static, full, K, st, r,
                                        live, ops, stats)
        r = r + 1
        steps += 1
    base_cap = 2 if cfg.preemption else 4
    tranche_cap = (min(base_cap, max_rounds) if cfg.max_rounds > 0
                   else base_cap)
    used, assigned, chosen, round_of = st
    spent = torch.zeros((B, P), dtype=torch.bool, device=dev)
    bi = torch.arange(B, device=dev)[:, None]
    t = 0
    with stats.span("tranches"):
        while t < P:
            pend = (assigned == -1) & pods.valid & ~spent
            # The tenants this tranche runs; the rest keep their state.
            tact = progress & pend.any(dim=-1)
            if not stats.read(tact.any()):
                break
            sel = ops.top_by_rank(pend, order, C)[0]
            real = pend[bi, sel]
            sel32 = sel.to(torch.int32)
            view = _View(sel32, pods.requests[bi, sel], real, rank[bi, sel],
                         sel32, True)
            st_c = (used,
                    torch.full((B, C), -1, dtype=torch.int32, device=dev),
                    torch.full((B, C), NEG_INF, dtype=torch.float32,
                               device=dev),
                    torch.full((B, C), -1, dtype=torch.int32, device=dev))
            (used, asg_c, chosen_c, rnd_c), r, n = _run_rounds(
                cfg, snap, static, view, K, st_c, r, tranche_cap, tact, ops,
                stats)
            steps += n
            hit = asg_c >= 0
            assigned[bi, sel] = torch.where(hit, asg_c, assigned[bi, sel])
            chosen[bi, sel] = torch.where(hit, chosen_c, chosen[bi, sel])
            round_of[bi, sel] = torch.where(hit, rnd_c, round_of[bi, sel])
            # Spent: unplaced with no feasible node left (permanent).
            with stats.span("K5 cycle"):
                feas_left, _ = ops.cycle(
                    nodes.allocatable, used, pods.requests, static.mask,
                    static.score, static.w_lr, static.w_ba, static.w_ts,
                    static.rw, rows=view.rows, masked=True)
            no_node = ~feas_left.any(dim=-1)
            spent[bi, sel] = spent[bi, sel] | (real & ~hit & no_node
                                               & tact[:, None])
            t += 1
            progress = tact & real.any(dim=-1)
    return used, assigned, chosen, round_of, r, steps


# -- fast mode with signatures: water-fill, validation, frontier ----------


def _waterfill_tables(snap: ClusterSnapshot, pair_st: "kpair.PairState",
                      dom_s: torch.Tensor, allowed: torch.Tensor,
                      rank: torch.Tensor):
    """The water-fill dealer's tables over [P] and [S, N] (JAX
    `_spread_waterfill_deal` up to its fill table), plain torch:
    (s_p [P] int32 each pod's first DoNotSchedule slot's signature, q
    [P] f32 its 0-based rank position among this round's members of
    s_p, member [P] bool, fill [S, N] f32, ord_dom [S, N] int32). A
    tenant batch gives each its leading [B] axis; every sort, count and
    prefix runs along the last axis, within a tenant."""
    pods = snap.pods
    lead = rank.shape[:-1]
    S, N = dom_s.shape[-2:]
    dev = dom_s.device
    dns = pods.ts_valid & (pods.ts_when == DO_NOT_SCHEDULE)
    first_c = torch.argmax(dns.to(torch.int32), dim=-1)     # first DNS slot
    s_p = pods.ts_sig.gather(-1, first_c[..., None])[..., 0].clamp(min=0)
    member = allowed & dns.any(dim=-1)
    gid = torch.where(member, s_p, S)
    perm = torch.sort((gid.long() << 32) + rank.long(), dim=-1).indices
    q = torch.zeros(rank.shape, dtype=torch.float32, device=dev)
    q.scatter_(-1, perm, (_segment_count(
        member.gather(-1, perm), _segment_start(gid.gather(-1, perm)))
        - 1).to(torch.float32))
    # Per-signature fill levels over the domain counts, domains by
    # ascending count; 1e9 stands in for a domain no node has.
    keyed = torch.zeros((*lead, S, N), dtype=torch.int32, device=dev)
    keyed.scatter_add_(-1, dom_s.clamp(min=0).long(),
                       (dom_s >= 0).to(torch.int32))
    cnt = torch.where(keyed > 0, pair_st.counts,
                      torch.full((), 1e9, dtype=torch.float32, device=dev))
    ord_dom = torch.sort(cnt, dim=-1, stable=True).indices
    csort = torch.gather(cnt, -1, ord_dom)
    # The exclusive prefix of csort, summed exactly in f64 (integers
    # below 2**53) and rounded once: its entries over real domains are
    # the exact small integers JAX's f32 cumsum gives too, and the ones
    # past a sentinel stay near 1e9, far above any q, so the count of
    # fill <= q does not depend on how a device would round an f32 sum.
    pre = torch.cumsum(csort.to(torch.float64), dim=-1)
    presum = torch.cat([torch.zeros((*lead, S, 1), dtype=torch.float64,
                                    device=dev), pre[..., :-1]],
                       dim=-1).to(torch.float32)
    js = torch.arange(N, dtype=torch.float32, device=dev)
    fill = js * csort - presum
    return (s_p.to(torch.int32), q, member, fill.contiguous(),
            ord_dom.to(torch.int32).contiguous())


def _cap_order(alloc: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """[N] int32 nodes by descending mean free fraction of allocatable
    (the water-fill rotation order; [B, N] per tenant). The mean adds the
    R axes in order and divides by a device tensor (CUDA divides by a
    Python scalar as a multiply by its reciprocal)."""
    one = torch.full((), 1e-9, dtype=torch.float32, device=alloc.device)
    frac = torch.where(alloc > 0, (alloc - used) / torch.maximum(alloc, one),
                       torch.zeros((), dtype=torch.float32,
                                   device=alloc.device))
    total = frac[..., 0]
    for r in range(1, frac.shape[-1]):
        total = total + frac[..., r]
    free = total / torch.full((), float(frac.shape[-1]), dtype=torch.float32,
                              device=alloc.device)
    return _desc_order(free).to(torch.int32)


def waterfill_plain(fill: torch.Tensor, ord_dom: torch.Tensor,
                    dom_s: torch.Tensor, s_p: torch.Tensor, q: torch.Tensor,
                    relaxed: torch.Tensor, cap_order: torch.Tensor,
                    score: torch.Tensor, member: torch.Tensor, K1: int):
    """The water-fill dealer's per-pod [P, N] part (JAX
    `_spread_waterfill_deal` from its fill table on): each member's
    domain by the fill level its q reaches, then its K1 rotation
    candidates among the domain's relaxed-feasible nodes in cap_order.
    Returns (cand [P, K1] int32, val [P, K1] f32, ok [P] bool). A tenant
    batch goes tenant by tenant."""
    if relaxed.dim() == 3:
        return per_tenant(waterfill_plain, relaxed.shape[0], fill, ord_dom,
                          dom_s, s_p, q, relaxed, cap_order, score, member,
                          K1)
    P, N = relaxed.shape
    dev = relaxed.device
    s64 = s_p.long()
    fill_p = fill[s64]                                       # [P, N]
    j_p = ((fill_p <= q[:, None]).sum(dim=1) - 1).clamp(0, N - 1)
    # .to(int32) truncates toward zero, as the JAX code's astype(int32).
    r_i = (q - fill_p.gather(1, j_p[:, None])[:, 0]).to(torch.int32)
    m = (j_p + 1).to(torch.int32)
    m_p = torch.div(r_i, m, rounding_mode="floor")           # jnp's //
    slot = r_i - m_p * m                                     # jnp.mod
    dchoice = ord_dom[s64, slot.long()]
    sel = relaxed & (dom_s[s64] == dchoice[:, None])
    csum = torch.cumsum(sel[:, cap_order.long()].to(torch.int32), dim=1)
    n_feas = csum[:, -1]
    x = (m_p.to(torch.float32)[:, None]
         + torch.arange(K1, dtype=torch.float32, device=dev)[None, :])
    y = n_feas.to(torch.float32).clamp_min(1.0)[:, None]
    rem = torch.fmod(x, y)                                   # jnp.mod (f32)
    rem = torch.where((rem != 0) & ((rem < 0) != (y < 0)), rem + y, rem)
    targets = (rem + 1.0).to(torch.int32)
    j_node = torch.stack([(csum < targets[:, k:k + 1]).sum(dim=1)
                          for k in range(K1)], dim=1)
    cand = cap_order[j_node.clamp(0, N - 1)]
    c64 = cand.long()
    val = torch.where(sel.gather(1, c64), score.gather(1, c64),
                      torch.full((), NEG_INF, dtype=torch.float32,
                                 device=dev))
    return cand.to(torch.int32), val, member & (n_feas > 0)


def waterfill(fill: torch.Tensor, ord_dom: torch.Tensor, dom_s: torch.Tensor,
              s_p: torch.Tensor, q: torch.Tensor, relaxed: torch.Tensor,
              cap_order: torch.Tensor, score: torch.Tensor,
              member: torch.Tensor, K1: int):
    """Kernel K12 on CUDA tensors, the plain version on CPU tensors."""
    dev = relaxed.device
    if dev.type == "cpu":
        return waterfill_plain(fill, ord_dom, dom_s, s_p, q, relaxed,
                               cap_order, score, member, K1)
    lead = relaxed.shape[:-2]              # () or (B,): the tenant axis
    P, N = relaxed.shape[-2:]
    S = fill.shape[-2]
    k = "waterfill"
    if not 1 <= K1 <= 32:
        raise ValueError(f"{k}: {K1} candidates a pod, the kernel takes "
                         "1..32")
    check(k, dev, fill, torch.float32, (*lead, S, N))
    check(k, dev, ord_dom, torch.int32, (*lead, S, N))
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, s_p, torch.int32, (*lead, P))
    check(k, dev, q, torch.float32, (*lead, P))
    check(k, dev, cap_order, torch.int32, (*lead, N))
    check(k, dev, score, torch.float32, (*lead, P, N))
    check(k, dev, member, torch.bool, (*lead, P))
    cand = torch.empty((*lead, P, K1), dtype=torch.int32, device=dev)
    val = torch.empty((*lead, P, K1), dtype=torch.float32, device=dev)
    ok = torch.empty((*lead, P), dtype=torch.bool, device=dev)
    if relaxed.numel() == 0:
        return cand, val, ok
    _build.launch("tpusched_waterfill", lead[0] if lead else 1, P, S, N, K1,
                  *ptrs((fill, ord_dom, dom_s, s_p, q, relaxed, cap_order,
                         score, member, cand, val, ok)), stream_of(dev))
    waterfill.launches += 1
    return cand, val, ok


waterfill.launches = 0


def _spread_waterfill_deal(snap: ClusterSnapshot, pair_st, used, relaxed,
                           score, allowed, rank, K: int,
                           dom_s: torch.Tensor, ops: "Ops"):
    """Domain-balanced dealing for DoNotSchedule spread members (JAX
    `_spread_waterfill_deal`): each signature's members, in rank order,
    are water-filled across its domains so the per-domain levels stay
    flattest, and each member gets K+1 candidate nodes INSIDE its domain
    (successive free-capacity rotation positions, so a capacity miss
    spills to the domain's next node, not to a wrong domain that the
    validator would revert). `relaxed` (every predicate but the skew
    filter) lets a member target a domain that is over the bound
    against round-start counts but legal against end-of-round counts,
    which the validator checks. Returns K12's (cand [P, K+1], val, ok);
    ok False leaves the pod to the capacity dealer. A tenant batch deals
    every tenant in one K12 launch."""
    pods = snap.pods
    S = dom_s.shape[-2]
    if pods.ts_valid.shape[-1] == 0 or S == 0:
        dev = rank.device
        return (torch.zeros((*rank.shape, K + 1), dtype=torch.int32,
                            device=dev),
                torch.full((*rank.shape, K + 1), NEG_INF,
                           dtype=torch.float32, device=dev),
                torch.zeros(rank.shape, dtype=torch.bool, device=dev))
    s_p, q, member, fill, ord_dom = _waterfill_tables(snap, pair_st, dom_s,
                                                      allowed, rank)
    cap_order = _cap_order(snap.nodes.allocatable, used)
    return ops.waterfill(fill, ord_dom, dom_s, s_p, q, relaxed, cap_order,
                         score, member, K + 1)


def excess_min_plain(dom_s: torch.Tensor, counts: torch.Tensor,
                     node_valid: torch.Tensor, aff_ok: torch.Tensor,
                     s_c: torch.Tensor) -> torch.Tensor:
    """[P] f32: min over valid nodes with aff_ok and the key of the
    end-state count at the node's domain under signature s_c[p]; 0
    where there is none. A tenant batch goes tenant by tenant."""
    if counts.dim() == 3:
        return per_tenant(excess_min_plain, counts.shape[0], dom_s, counts,
                          node_valid, aff_ok, s_c)
    s = s_c.long()
    node_cnt = torch.gather(counts, 1, dom_s.clamp(min=0).long())[s]
    eligible = node_valid[None, :] & aff_ok & (dom_s[s] >= 0)
    lo = torch.where(eligible, node_cnt,
                     torch.full((), torch.inf, dtype=torch.float32,
                                device=counts.device)).amin(dim=1)
    return torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))


def excess_min(dom_s: torch.Tensor, counts: torch.Tensor,
               node_valid: torch.Tensor, aff_ok: torch.Tensor,
               s_c: torch.Tensor) -> torch.Tensor:
    """Kernel K13's [P, N] pass on CUDA tensors, the plain version on CPU
    tensors."""
    dev = counts.device
    if dev.type == "cpu":
        return excess_min_plain(dom_s, counts, node_valid, aff_ok, s_c)
    lead = aff_ok.shape[:-2]               # () or (B,): the tenant axis
    P, N = aff_ok.shape[-2:]
    S = dom_s.shape[-2]
    k = "excess_min"
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, counts, torch.float32, (*lead, S, N))
    check(k, dev, node_valid, torch.bool, (*lead, N))
    check(k, dev, aff_ok, torch.bool, (*lead, P, N))
    check(k, dev, s_c, torch.int32, (*lead, P))
    out = torch.empty((*lead, P), dtype=torch.float32, device=dev)
    if aff_ok.numel() == 0:
        return out.fill_(0.0)
    _build.launch("tpusched_excess_min", lead[0] if lead else 1, P, S, N,
                  *ptrs((dom_s, counts, node_valid, aff_ok, s_c, out)),
                  stream_of(dev))
    excess_min.launches += 1
    return out


excess_min.launches = 0


def excess_survive_plain(gid_s: torch.Tensor, perm: torch.Tensor,
                         member: torch.Tensor, T: torch.Tensor,
                         b_fixed: torch.Tensor) -> torch.Tensor:
    """[P] bool (pod rows) from the rows sorted by (group, rank): per
    group the 1-based member count q and the running min of the
    members' allowances T (a segmented Hillis-Steele min scan: min is
    exact, so any order gives these bits); a member is bad unless
    b_fixed + q <= that min. A tenant batch goes tenant by tenant."""
    if perm.dim() == 2:
        return per_tenant(excess_survive_plain, perm.shape[0], gid_s, perm,
                          member, T, b_fixed)
    P = perm.shape[0]
    dev = perm.device
    p = perm.long()
    mem_s = member[p]
    idx = torch.arange(P, device=dev)
    seg = _segment_start(gid_s)
    q = _segment_count(mem_s, seg).to(torch.float32)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    pm = torch.where(mem_s, T[p], inf)
    d = 1
    while d < P:
        prev = torch.cat([inf.expand(d), pm[:-d]])
        pm = torch.where(idx - d >= seg, torch.minimum(pm, prev), pm)
        d <<= 1
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    bad[p] = mem_s & ~(b_fixed[p] + q <= pm)
    return bad


def excess_survive(gid_s: torch.Tensor, perm: torch.Tensor,
                   member: torch.Tensor, T: torch.Tensor,
                   b_fixed: torch.Tensor) -> torch.Tensor:
    """Kernel K13's group walk on CUDA tensors, the plain version on CPU
    tensors."""
    dev = perm.device
    if dev.type == "cpu":
        return excess_survive_plain(gid_s, perm, member, T, b_fixed)
    rows = perm.shape                      # (P,) or (B, P)
    k = "excess_survive"
    check(k, dev, gid_s, torch.int32, rows)
    check(k, dev, perm, torch.int32, rows)
    check(k, dev, member, torch.bool, rows)
    check(k, dev, T, torch.float32, rows)
    check(k, dev, b_fixed, torch.float32, rows)
    bad = torch.empty(rows, dtype=torch.bool, device=dev)
    if bad.numel() == 0:
        return bad
    _build.launch("tpusched_excess_survive",
                  rows[0] if len(rows) == 2 else 1, rows[-1],
                  *ptrs((gid_s, perm, member, T, b_fixed, bad)),
                  stream_of(dev))
    excess_survive.launches += 1
    return bad


excess_survive.launches = 0


def _spread_excess_mask(snap: ClusterSnapshot, aff_ok: torch.Tensor,
                        rank: torch.Tensor, choice: torch.Tensor,
                        kept: torch.Tensor, st: "kpair.PairState",
                        dom_s: torch.Tensor, ops: "Ops") -> torch.Tensor:
    """[P] bool: kept members to revert so every kept DoNotSchedule
    spread constraint holds against st's (end-of-round) counts (JAX
    `_spread_excess_mask`): per (signature, domain) group of kept
    members, the highest-priority prefix whose size respects every
    prefix member's allowance T = (min end-state count over its
    eligible domains) + maxSkew survives. Every cross-pod reduction is
    an integer count or a min, so a view's verdict is row for row the
    full width's. A tenant batch ([B, P] rows) groups, sorts and counts
    within each tenant; K13 launches once for all of them."""
    pods, nodes = snap.pods, snap.nodes
    lead = rank.shape[:-1]
    S, N = dom_s.shape[-2:]
    dev = dom_s.device
    dns = pods.ts_valid & (pods.ts_when == DO_NOT_SCHEDULE)
    ch = choice.clamp(0, N - 1).long()
    dom_f = dom_s.flatten(-2)                                # [.., S * N]
    cnt_f = st.counts.flatten(-2)
    bad = torch.zeros(rank.shape, dtype=torch.bool, device=dev)
    for c in range(pods.ts_key.shape[-1]):
        s_c = pods.ts_sig[..., c].clamp(min=0)
        d_c = dom_f.gather(-1, s_c.long() * N + ch)
        member = kept & dns[..., c] & (choice >= 0) & (d_c >= 0)
        min_end = ops.excess_min(dom_s, st.counts, nodes.valid, aff_ok,
                                 s_c.contiguous())
        T = min_end + pods.ts_max_skew[..., c]
        cell = s_c * N + d_c.clamp(min=0)
        cnt_total = cnt_f.gather(-1, cell.long())
        gid = torch.where(member, cell, S * N)
        g_tab = torch.zeros((*lead, S * N + 1), dtype=torch.float32,
                            device=dev)
        g_tab.scatter_add_(-1, gid.long(), member.to(torch.float32))
        # The members' non-revertable rest.
        b_fixed = cnt_total - g_tab.gather(-1, gid.long())
        perm = torch.sort((gid.long() << 32) + rank.long(), dim=-1).indices
        bad = bad | ops.excess_survive(
            gid.gather(-1, perm).to(torch.int32).contiguous(),
            perm.to(torch.int32), member, T.contiguous(), b_fixed)
    return bad


def _sig_involvement(snap: ClusterSnapshot, static: StaticCtx,
                     st0: "kpair.PairState"):
    """(invol [P, S] bool, has_pair [P] bool), plain torch (JAX
    `_sig_involvement`). has_pair: pods whose pairwise validation can
    fail, i.e. with spread or inter-pod terms of their own, or matched
    by a live required anti term (of a running holder in a keyed domain,
    or of any pending holder). invol: the signatures a pod's checks read
    or its commit writes; pods with disjoint involvement cannot affect
    each other's validation. A tenant batch gives [B, P, S] and [B, P],
    every count within a tenant."""
    pods = snap.pods
    M = snap.running.valid.shape[-1]
    S = static.sig_match.shape[-2]
    dev = pods.valid.device
    has_pair = pods.ts_valid.any(dim=-1) | pods.ia_valid.any(dim=-1)
    anti_possible = st0.anti.sum(dim=-1) > 0                 # [.., S]
    holds = kpair.pod_anti_holds(pods) & pods.valid[..., None]
    for t in range(pods.ia_key.shape[-1]):
        hit = torch.zeros(anti_possible.shape, dtype=torch.int32, device=dev)
        hit.scatter_add_(-1, pods.ia_sig[..., t].clamp(min=0).long(),
                         holds[..., t].to(torch.int32))
        anti_possible = anti_possible | (hit > 0)
    members = static.sig_match[..., M:]                      # [.., S, P]
    has_pair = has_pair | (members & anti_possible[..., None]).any(dim=-2)
    invol = (members.transpose(-2, -1) & pods.valid[..., None]).contiguous()
    for sig, valid in ((pods.ts_sig, pods.ts_valid),
                       (pods.ia_sig, pods.ia_valid)):
        for c in range(sig.shape[-1]):
            s_c = sig[..., c, None].clamp(min=0).long()
            invol.scatter_(-1, s_c, invol.gather(-1, s_c)
                           | valid[..., c, None])
    return invol, has_pair


def _compact_cap(cfg: EngineConfig, P: int) -> int:
    """The frontier-compaction width of the signature rounds: 0 = off
    (full-width rounds only, the reference the compacted rounds equal),
    cfg.compact_cap -1 = _RESIDUAL_CAP unless P is not larger than it,
    else the explicit cap (the tests use a small one to run compacted
    rounds on small clusters)."""
    cap = _RESIDUAL_CAP if cfg.compact_cap < 0 else cfg.compact_cap
    if cap <= 0 or (cfg.compact_cap < 0 and P <= cap):
        return 0
    return min(cap, P)


def _rows(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The pod-axis rows sel of t: t[sel], or per tenant t[b, sel[b]] for
    a [B, C] sel (t [B, P, ...])."""
    if sel.dim() == 1:
        return t.index_select(0, sel)
    return t[torch.arange(sel.shape[0], device=sel.device)[:, None], sel]


def _pods_view(snap: ClusterSnapshot, static: StaticCtx, sel: torch.Tensor):
    """The compacted pod-axis view (gathers): the selected pods' rows of
    every pod array and of StaticCtx, and sig_match's running columns
    then the selected pods' member columns. Nodes, running pods,
    signatures and all [S, N] / [N, R] state stay full width. A tenant
    batch gathers each tenant's own rows ([B, C] sel)."""
    M = snap.running.valid.shape[-1]
    sm = static.sig_match
    cols = sel.unsqueeze(-2).expand(*sm.shape[:-1], sel.shape[-1])
    sig_v = torch.cat([sm[..., :M], sm[..., M:].gather(-1, cols)], dim=-1)
    static_v = StaticCtx(
        mask=_rows(static.mask, sel), aff_ok=_rows(static.aff_ok, sel),
        score=_rows(static.score, sel), sig_match=sig_v,
        w_lr=_rows(static.w_lr, sel), w_ba=_rows(static.w_ba, sel),
        w_ts=_rows(static.w_ts, sel), w_ia=_rows(static.w_ia, sel),
        rw=static.rw)
    pods_v = snap.pods._map(lambda t: _rows(t, sel))
    return dataclasses.replace(snap, pods=pods_v), static_v


def _min_rank_first(mask: torch.Tensor, rank: torch.Tensor,
                    invol: torch.Tensor) -> torch.Tensor:
    """[P] bool: rank[p] is the least rank among the `mask` pods in every
    signature p is involved in (per tenant for [B, P] rows)."""
    BIG = torch.iinfo(torch.int32).max
    r = torch.where(mask, rank, BIG)
    lo = torch.where(invol, r[..., None], BIG).amin(dim=-2)  # [.., S]
    return torch.where(invol, rank[..., None] == lo[..., None, :],
                       True).all(dim=-1)


def _round_sig(cfg: EngineConfig, snap_v: ClusterSnapshot,
               static_v: StaticCtx, invol_v, hp_v, rank_v, pod_ids,
               pending_v, cons_v, used, pair_st, K: int, width: int,
               dom_s: torch.Tensor, ops: "Ops", stats: RoundStats):
    """One commit round over a (possibly compacted) pod-axis view (JAX
    `_solve_rounds_sig`'s round_math), for a tenant batch ([B, V] rows):
    score (K11, K5), gate the conservative pods, water-fill (K12) and
    deal (K6, K7, K8), add the commits to the pair state (K10), then
    validate against the end-of-round state until a pass reverts nothing
    (K14, K13, the reverts through K8's node_add and K10). Each tenant
    runs its own validation fixpoint, the vmapped while_loop: a pass runs
    while any tenant's last pass reverted (one host read a pass), and a
    tenant whose fixpoint has ended reverts nothing more. A tenant with
    no pending row commits nothing and keeps its state bit for bit.
    Returns (used, state, kept, choice, chosen_val, fb_mask)."""
    BIG = torch.iinfo(torch.int32).max
    req_v = snap_v.pods.requests
    sig_v = static_v.sig_match
    with stats.span("K11 + K5 cycle"):
        feasible, score, relaxed = batched_cycle(
            cfg, snap_v, static_v, used, ops=ops, pair_st=pair_st,
            pending=pending_v, return_relaxed=True)
    masked = torch.where(feasible, score,
                         torch.full((), NEG_INF, dtype=torch.float32,
                                    device=score.device))
    want = feasible.any(dim=-1)
    # Conservative pods commit only when first among the wanting pods in
    # every signature they touch.
    gate = ~cons_v | _min_rank_first(want & cons_v, rank_v, invol_v)
    allowed = want & gate
    with stats.span("K12 waterfill"):
        sp = _spread_waterfill_deal(snap_v, pair_st, used, relaxed, score,
                                    relaxed.any(dim=-1) & gate, rank_v, K,
                                    dom_s, ops)
    with stats.span("K6 row_topk"):
        topv, topi, pick = ops.row_topk(masked, K, cfg.tie_break == "seeded",
                                        cfg.tie_seed, pod_ids)
    used2, choice, chosen_val = _deal_commit(
        snap_v.nodes.allocatable, req_v, used, feasible, masked,
        allowed | sp[2], rank_v, topv, topi, tie_pick=pick, ops=ops,
        stats=stats, override=sp, score_full=score, cum_width=width)
    commit = choice >= 0
    st_v = ops.pair_commit(snap_v, pair_st, sig_v, dom_s, choice, commit, 1.0)

    # Validate the committed pairwise pods against end-of-round counts
    # and revert violators, to a fixpoint (a revert can take away the
    # match another pod's positive affinity needed; each pass reverts at
    # least one pod). Inter-pod violators revert in rank order: the
    # violator first in all its signatures is protected while others
    # remain (same-round commits usually caused its violation). Spread
    # violators revert only the excess per (signature, domain).
    used_v, kept = used2, commit
    flag = (commit & hp_v).any(dim=-1)       # [B]: the tenants still going
    while stats.read(flag.any()):
        with stats.span("validation passes"):
            going = flag[:, None]
            with stats.span("K14 ia_at_choice"):
                ia_ok_at = ops.ia_ok_at_choice(
                    snap_v, st_v, sig_v, dom_s, choice,
                    torch.where(kept, choice, -1))
            ia_bad_all = kept & hp_v & ~ia_ok_at & going
            protected = ia_bad_all & _min_rank_first(ia_bad_all, rank_v,
                                                     invol_v)
            ia_bad = ia_bad_all & ~protected
            with stats.span("K13 spread_excess"):
                sp_bad = _spread_excess_mask(
                    snap_v, static_v.aff_ok, rank_v, choice, kept, st_v,
                    dom_s, ops) & ~ia_bad_all & going
            stuck = (~(ia_bad | sp_bad).any(dim=-1, keepdim=True)
                     & ia_bad_all.any(dim=-1, keepdim=True))
            new_viol = ia_bad | sp_bad | (ia_bad_all & stuck)
            used_v = ops.node_add(used_v, choice, new_viol, req_v, rank_v,
                                  -1.0)
            st_v = ops.pair_commit(snap_v, st_v, sig_v, dom_s, choice,
                                   new_viol, -1.0)
            kept = kept & ~new_viol
            flag = new_viol.any(dim=-1)
    # Backstop: if every commit of a tenant's round reverted, its first
    # reverted pod by rank turns conservative, so the gated path makes
    # progress.
    viol = commit & ~kept
    first = rank_v == torch.where(viol, rank_v, BIG).amin(dim=-1,
                                                          keepdim=True)
    fb_mask = (viol & first & ~kept.any(dim=-1, keepdim=True)
               & viol.any(dim=-1, keepdim=True))
    return used_v, st_v, kept, choice, chosen_val, fb_mask


def _solve_rounds_sig(cfg: EngineConfig, snap: ClusterSnapshot,
                      static: StaticCtx, rank: torch.Tensor,
                      order: torch.Tensor, st0: "kpair.PairState",
                      invol: torch.Tensor, has_pair: torch.Tensor,
                      max_rounds: int, K: int, cap: int, ops: "Ops",
                      stats: RoundStats, init=None):
    """The fast rounds with signatures (S > 0; JAX `_solve_rounds_sig`):
    full-width [P, N] rounds while more than `cap` pods are pending,
    then rounds over the whole pending frontier gathered into a [cap, N]
    view (the top `cap` pods by rank, a superset of what is pending).
    cap == 0: full-width rounds only.

    Compacted rounds equal full-width ones (compact_cap = 0) bit for
    bit in assignment, chosen score and commit key: the view holds
    every pod that can commit, gate or validate; sorts key on global
    ranks; and every cross-pod reduction is an integer count, a min, or
    a width-invariant f32 order (`_deal_commit`'s cum_width, K8's
    prefix and rank-ordered adds, node_add). init: a seeded (used,
    assigned, pair state, conservative, chosen, round_of, r), the
    incremental path's carried placements committed into `used` and
    the pair state, rounds counted from r; without it the rounds start
    from the snapshot at r = 0. Returns (used, assigned, final pair
    state, chosen, round_of, rounds).

    A tenant batch (a batched snapshot, StaticCtx and pair state, [B, P]
    rank and order) runs every tenant's loops at once under jax.vmap's
    loop rule (`_rounds_sig`); rounds is then a [B] int32 tensor. The
    solo shapes run as a batch of one, rounds an int."""
    if rank.dim() == 2:
        return _rounds_sig(cfg, snap, static, rank, order, st0, invol,
                           has_pair, max_rounds, K, cap, ops, stats,
                           init)[:6]
    if init is not None:
        used, assigned, st, cons, chosen, round_of, r = init
        init = (used[None], assigned[None], st.as_batch(), cons[None],
                chosen[None], round_of[None], r)
    used, assigned, st, chosen, round_of, _, r = _rounds_sig(
        cfg, snap.as_batch(), static.as_batch(), rank[None], order[None],
        st0.as_batch(), invol[None], has_pair[None], max_rounds, K, cap, ops,
        stats, init)
    return (used[0], assigned[0], st.tenant(0), chosen[0], round_of[0],
            int(r[0]))


def _rounds_sig(cfg, snap, static, rank, order, st0, invol, has_pair,
                max_rounds, K, cap, ops, stats, init):
    """_solve_rounds_sig over a tenant batch, JAX's two vmapped
    while_loops: the full-width loop runs while any tenant's condition
    holds (its last round progressed, its round counter is below
    max_rounds and, with cap, more than cap of its pods are pending),
    then the compacted loop while any tenant's holds (progress, rounds
    left). Each step reads every tenant's condition in one host read
    (none when the host knows it: before the first round, or when the
    round counters alone decide), a tenant whose condition is false
    keeps its state and its round counter, and a tenant that hands off
    to the compacted rounds waits there until the full-width loop has
    ended for all. Returns (used, assigned, pair state, chosen, round_of,
    rounds [B] int32 on the device, rounds on the host)."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    pods = snap.pods
    B, P = rank.shape
    dev = rank.device
    dom_s = kpair.sig_domains(snap)
    ids = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    used, st = snap.nodes.used, st0
    assigned = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    chosen = torch.full((B, P), NEG_INF, dtype=torch.float32, device=dev)
    round_of = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    cons = torch.zeros((B, P), dtype=torch.bool, device=dev)
    r0 = 0
    if init is not None:
        used, assigned, st, cons, chosen, round_of, r0 = init
    # Each tenant's round counter, on the host and on the device, and its
    # progress flag (the loops' initial True); `known`: no round has run,
    # so every flag is still True and the host needs no read to know it.
    r_h = np.full(B, r0, dtype=np.int64)
    r_d = torch.full((B,), r0, dtype=torch.int32, device=dev)
    progress = torch.ones(B, dtype=torch.bool, device=dev)
    known = True

    def step(snap_v, static_v, sel, pending_v, live):
        nonlocal used, st, assigned, chosen, round_of, cons, progress
        rows = (lambda t: t) if sel is None else (lambda t: _rows(t, sel))
        used, st, kept, choice, cval, fb = _round_sig(
            cfg, snap_v, static_v, rows(invol), rows(has_pair), rows(rank),
            rows(ids), pending_v, rows(cons), used, st, K, P, dom_s, ops,
            stats)
        new_cons = fb & ~rows(cons)
        upd = ((assigned, torch.where(kept, choice, rows(assigned))),
               (chosen, torch.where(kept, cval, rows(chosen))),
               (round_of, torch.where(kept, r_d[:, None], rows(round_of))),
               (cons, rows(cons) | fb))
        assigned, chosen, round_of, cons = (
            v if sel is None else full.index_put(
                (torch.arange(B, device=dev)[:, None], sel), v)
            for full, v in upd)
        all_done = ((assigned >= 0) | ~pods.valid).all(dim=-1)
        moved = (kept.any(dim=-1) | new_cons.any(dim=-1)) & ~all_done
        progress = torch.where(live, moved, progress)

    def advance(live_h, live_d):
        nonlocal r_h, r_d, known
        known = False
        r_h = r_h + live_h
        r_d = r_d + live_d.to(torch.int32)
        return live_h & (r_h < max_rounds), live_d & (r_d < max_rounds)

    live_h, live_d = r_h < max_rounds, r_d < max_rounds
    while live_h.any():
        if cap or not known:
            flag = progress & live_d
            if cap:
                # Hand off to the compacted rounds once the whole pending
                # frontier fits one view (never before: the view must hold
                # every pending pod).
                flag = flag & (((assigned == -1) & pods.valid).sum(dim=-1)
                               > cap)
            live_h, live_d = stats.read_each(flag), flag
            if not live_h.any():
                break
        with stats.span("full-width rounds"):
            step(snap, static, None, (assigned == -1) & live_d[:, None],
                 live_d)
        live_h, live_d = advance(live_h, live_d)
    if cap:
        live_h, live_d = r_h < max_rounds, r_d < max_rounds
        while live_h.any():
            if not known:
                flag = progress & live_d
                live_h, live_d = stats.read_each(flag), flag
                if not live_h.any():
                    break
            with stats.span("compacted rounds"):
                pend = (assigned == -1) & pods.valid & live_d[:, None]
                sel = ops.top_by_rank(pend, order, cap)[0]
                step(*_pods_view(snap, static, sel), sel,
                     pend.gather(-1, sel), live_d)
            live_h, live_d = advance(live_h, live_d)
    return used, assigned, st, chosen, round_of, r_d, r_h


def gang_rollback(snap: ClusterSnapshot, used: torch.Tensor,
                  assigned: torch.Tensor, chosen: torch.Tensor,
                  pair_st: "kpair.PairState | None" = None,
                  sig_match: torch.Tensor | None = None,
                  dom_s: torch.Tensor | None = None,
                  ops: "Ops | None" = None):
    """The all-or-nothing gang gate (JAX `gang_rollback`): a pod group
    with fewer placed members than its min_member rolls back entirely
    (min_member is a floor: members above it stay). The rolled pods'
    requests leave `used` through K8's node_add with sign -1, per node in
    ascending pod index (the oracle's unwind order); with a pair state
    their contributions leave it through K10's pair_commit with sign -1.
    A tenant batch counts each tenant's quorums in its own [G] row (group
    ids are local to a tenant) and reverts every tenant in one node_add
    and one pair_commit launch. Returns (used, assigned, chosen,
    pair_st, rolled)."""
    ops = ops or KERNELS
    pods = snap.pods
    P = assigned.shape[-1]
    G = snap.group_min_member.shape[-1]
    dev = assigned.device
    if G == 0:
        return (used, assigned, chosen, pair_st,
                torch.zeros(assigned.shape, dtype=torch.bool, device=dev))
    g = pods.group
    placed = (assigned >= 0) & pods.valid & (g >= 0)
    gclip = g.clamp(min=0).long()
    cnt = torch.zeros((*assigned.shape[:-1], G), dtype=torch.int32,
                      device=dev)
    cnt.scatter_add_(-1, gclip, placed.to(torch.int32))
    roll = placed & (cnt < snap.group_min_member).gather(-1, gclip)
    rank = torch.arange(P, dtype=torch.int32, device=dev).expand(
        assigned.shape)
    used = ops.node_add(used, assigned, roll, pods.requests, rank, -1.0)
    if pair_st is not None and snap.sigs.key.shape[-1] > 0:
        pair_st = ops.pair_commit(snap, pair_st, sig_match, dom_s, assigned,
                                  roll, -1.0)
    assigned = torch.where(roll, -1, assigned)
    chosen = torch.where(roll, NEG_INF, chosen)
    return used, assigned, chosen, pair_st, roll


# The fast mode's preemption drain (JAX `_preempt_rounds`): each round the
# _PREEMPT_BATCH best-ranked unplaced pods bid at once, after (S = 0) a
# plain dealing round over the _PREEMPT_DRAIN best-ranked pending pods;
# at most _PREEMPT_MAX_ROUNDS rounds; a fast-mode preemptor evicts at most
# _PREEMPT_VICTIM_CAP victims on one node (the node-major table's V).
_PREEMPT_BATCH = 1024
_PREEMPT_DRAIN = 1024
_PREEMPT_MAX_ROUNDS = 128
_PREEMPT_VICTIM_CAP = 16

# The explained fast solve's per-round auction provenance: one row per
# preemption round in a [_PREEMPT_MAX_ROUNDS, len(...)] f32 table. The
# column order is the layout tpusched/explain.py reads.
EXPLAIN_AUCTION_STATS = (
    "considered",      # pods examined this round
    "plain_feasible",  # of those, feasible without any eviction
    "bids",            # entered the victim auction
    "claimed",         # auction claims surviving exact validation
    "kept_evict",      # eviction bids kept past the PDB budget gate
    "kept_plain",      # plain placements kept (claim scan + capacity)
    "drained",         # plain-drain placements (S == 0 pre-pass)
    "evictions",       # victims newly evicted this round
    "pdb_spent",       # PDB budget consumed by kept eviction bids
    "no_bid",          # pods retired spent (no placement or prefix)
)


def _evict_round(evicted: torch.Tensor, vidx_t: torch.Tensor,
                 keep_evict: torch.Tensor) -> torch.Tensor:
    """evicted | the kept eviction bids' victim prefixes (vidx_t holds M
    at the slots that are not victims; a sentinel slot M takes those and
    the bids not kept, so no mask is read back to the host). A tenant
    batch ([B, M] evicted, [B, C, V] vidx_t) marks each tenant's own
    row."""
    M = evicted.shape[-1]
    slot = torch.where(keep_evict[..., None], vidx_t, M).long()
    hit = torch.zeros((*evicted.shape[:-1], M + 1), dtype=torch.bool,
                      device=evicted.device)
    hit.scatter_(-1, slot.flatten(-2), True)
    return evicted | hit[..., :M]


def _bidder_rows(cfg: EngineConfig, snap: ClusterSnapshot,
                 static: StaticCtx, sel: torch.Tensor, used: torch.Tensor,
                 st: "kpair.PairState | None", dom_s: torch.Tensor | None,
                 ops: "Ops"):
    """The plain evaluation of the pods `sel` against `used` and the
    pair state (JAX's `vmap(pod_cycle)` and `pick_node` over them): K5
    on their rows, with signatures on the gathered pod view after K11's
    pairwise rows; K6's top-1 (or seeded pick) as the scored node.
    Returns (feasible [C, N], masked [C, N], n_plain [C] int32, its
    masked score [C], pair_ok [C, N] or None at S = 0, (snap_v,
    static_v) or None at S = 0); a tenant batch ([B, C] sel) each
    tenant's rows, [B, C, ...]."""
    nodes = snap.nodes
    s32 = sel.to(torch.int32)
    if snap.sigs.key.shape[-1] == 0:
        feas, score = ops.cycle(
            nodes.allocatable, used, snap.pods.requests, static.mask,
            static.score, static.w_lr, static.w_ba, static.w_ts, static.rw,
            rows=s32)
        pair_ok = view = None
    else:
        snap_v, static_v = _pods_view(snap, static, sel.long())
        pair = ops.pairwise_batch(snap_v, st, static_v.aff_ok,
                                  static_v.sig_match, dom_s)
        feas, score = ops.cycle(
            nodes.allocatable, used, snap_v.pods.requests, static_v.mask,
            static_v.score, static_v.w_lr, static_v.w_ba, static_v.w_ts,
            static_v.rw, pair=pair, w_ia=static_v.w_ia)
        pair_ok, view = pair[0], (snap_v, static_v)
    masked = torch.where(feas, score, torch.full((), NEG_INF,
                                                 dtype=torch.float32,
                                                 device=score.device))
    topv, topi, pick = ops.row_topk(masked, 1, cfg.tie_break == "seeded",
                                    cfg.tie_seed, s32)
    n_plain = pick if pick is not None else topi[..., 0]
    sc = masked.gather(-1, n_plain.long()[..., None])[..., 0]
    return feas, masked, n_plain, sc, pair_ok, view


def _budget_gate(snap: ClusterSnapshot, evicted: torch.Tensor,
                 claimed: torch.Tensor, usage: torch.Tensor) -> torch.Tensor:
    """The claims kept under the PodDisruptionBudgets, [C] bool ([B, C]
    for a tenant batch, each tenant against its own budgets): the claims
    as a rank-ordered prefix (the bidders are in rank order) while each
    touched budget's claimed-cumulative use (int counts) stays inside
    what it has left, + 1e-6; a bid whose own use overdraws (a declared
    violation) keeps regardless."""
    if snap.pdb_allowed.shape[-1] == 0:
        return claimed
    rem = kpre.pdb_remaining(snap, evicted)[..., None, :] + 1e-6
    use_cl = torch.where(claimed[..., None], usage, 0)
    cum = torch.cumsum(use_cl, dim=-2).to(torch.float32)
    fits_budget = torch.where(usage > 0, cum <= rem, True).all(dim=-1)
    alone = (usage.to(torch.float32) > rem).any(dim=-1)
    return claimed & (fits_budget | alone)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x ([B, P] or [B, P, R]) at each tenant's pod positions idx [B, C]
    (int64), by one gather."""
    if x.dim() > idx.dim():
        idx = idx[..., None].expand(*idx.shape, x.shape[-1])
    return x.gather(1, idx)


def _preempt_rounds(cfg: EngineConfig, snap: ClusterSnapshot,
                    static: StaticCtx, rank: torch.Tensor,
                    order: torch.Tensor, base_rounds,
                    used: torch.Tensor, assigned: torch.Tensor,
                    st: "kpair.PairState | None", round_of: torch.Tensor,
                    chosen: torch.Tensor, has_pair: torch.Tensor,
                    dom_s: torch.Tensor | None, ops: "Ops",
                    stats: RoundStats, explain: bool = False):
    """Fast-mode PostFilter as batched auction rounds (JAX
    `_preempt_rounds`), a host loop that reads one progress flag a round.
    A round:
      1. (S = 0) a plain dealing round (K5, K6, K7, K8) over the
         _PREEMPT_DRAIN best-ranked pending pods places what fits;
      2. the C best-ranked pending pods not yet tried are evaluated
         against round-start state (K5 on their rows; with signatures
         K11's pairwise rows first) and picked as `pick_node` would (K6);
         pods that fit nowhere and are not gang members bid in the
         auction (`kernels/preempt.preempt_auction`: K16-K18 and K6),
         with the pairwise-involved plain pods as single-candidate
         claimants;
      3. a rank-ordered budget gate over the claims (integer counts);
      4. the kept bids' victims are evicted; the plain pods without
         pairwise involvement commit by a dealing round (K7, K8) on the
         nodes no keep claimed;
      5. with signatures the round's keeps are validated against the
         end-of-round pair state until nothing more reverts (K10, K14,
         K13); a reverted preemptor's victims stay evicted;
      6. `used` gains the claim-exclusive eviction and placement deltas
         (one real term a node, so `index_add_` is exact) and the plain
         commits through K8's node_add, in rank order.
    Every keep of round r shares the commit key base_rounds + r. A pod
    gets one bid until some keep changes the state. Returns (used,
    assigned, st, evicted, round_of, chosen, rounds); explain=True
    appends (evictor [M], evict_round [M], the [_PREEMPT_MAX_ROUNDS,
    EXPLAIN_AUCTION_STATS] table), accumulated on the device with no
    host read: each round's kept eviction bids (before the pairwise
    validation, like the evictions) name their victims' evicting pod
    and commit key by a scatter-max over a -1 start (a victim is
    evicted once), and the round's counts fill its row.

    A tenant batch (a leading [B] axis on the snapshot, StaticCtx, state
    and rank; base_rounds [B] int32) runs every tenant's rounds at once
    (`_preempt_rounds_many`) and returns rounds as a [B] int32 tensor;
    the solo shapes run as a batch of one, rounds an int."""
    if rank.dim() == 2:
        out = _preempt_rounds_many(cfg, snap, static, rank, order,
                                   base_rounds, used, assigned, st,
                                   round_of, chosen, has_pair, dom_s, ops,
                                   stats, explain)
        return out[:7] + out[8:]
    dev = rank.device
    out = _preempt_rounds_many(
        cfg, snap.as_batch(), static.as_batch(), rank[None], order[None],
        torch.full((1,), base_rounds, dtype=torch.int32, device=dev),
        used[None], assigned[None], st and st.as_batch(), round_of[None],
        chosen[None], has_pair[None], None if dom_s is None else dom_s[None],
        ops, stats, explain)
    used, assigned, st, evicted, round_of, chosen, _, r_h = out[:8]
    res = (used[0], assigned[0], st and st.tenant(0), evicted[0],
           round_of[0], chosen[0], int(r_h[0]))
    return res + ((tuple(t[0] for t in out[8]),) if explain else ())


def _preempt_rounds_many(cfg, snap, static, rank, order, base_rounds, used,
                         assigned, st, round_of, chosen, has_pair, dom_s,
                         ops, stats, explain):
    """_preempt_rounds over a tenant batch, under jax.vmap's loop rule:
    a round runs while any tenant's progress flag holds and its round
    counter is below _PREEMPT_MAX_ROUNDS (one `RoundStats.read_each` of
    the [B] flags a round, none before the first), each tenant's keeps
    take its own key base_rounds[b] + r[b], and a tenant whose loop has
    ended keeps its state bit for bit: it has no pending row, so nothing
    drains, bids, claims, commits, reverts or is tried there (its rows
    add exact zeros to `used`, as the solo rounds' unclaimed rows do).
    Budgets, the budget gate's prefix, `tried` and the pairwise fixpoint
    (one read a pass for all tenants, a tenant that reverted nothing
    reverts nothing more) are per tenant; the claim-exclusive adds and
    the eviction marks scatter into each tenant's own row. Returns
    (used, assigned, st, evicted, round_of, chosen, rounds [B] int32 on
    the device, rounds on the host), then the explain tuple with a
    leading [B] axis."""
    pods, nodes = snap.pods, snap.nodes
    B, P = rank.shape
    N = nodes.valid.shape[-1]
    M = snap.running.valid.shape[-1]
    R = nodes.allocatable.shape[-1]
    dev = rank.device
    C = min(P, _PREEMPT_BATCH)
    S = snap.sigs.key.shape[-1]
    GP = snap.pdb_allowed.shape[-1]
    K = _fallback_depth(N)
    seeded = cfg.tie_break == "seeded"
    alloc = nodes.allocatable
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    # Per-tenant reads and writes at the selected pods go through one
    # gather (`_take`) or scatter along the pod axis: each tenant's
    # slots are distinct pods, so a scatter is exact.
    with stats.span("preempt victim table"):
        pctx = kpre.precompute_nv(cfg, snap, _PREEMPT_VICTIM_CAP)
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail)
    evicted = torch.zeros((B, M), dtype=torch.bool, device=dev)
    tried = torch.zeros((B, P), dtype=torch.bool, device=dev)
    compact_pv = S > 0 and _compact_cap(cfg, P) > 0
    ex = ()
    if explain:
        ex = (torch.full((B, M), -1, dtype=torch.int32, device=dev),
              torch.full((B, M), -1, dtype=torch.int32, device=dev),
              torch.zeros((B, _PREEMPT_MAX_ROUNDS,
                           len(EXPLAIN_AUCTION_STATS)),
                          dtype=torch.float32, device=dev))
    # Each tenant's round counter on the host and on the device, and its
    # loop flag; no read before the first round (every flag is True).
    r_h = np.zeros(B, dtype=np.int64)
    r_d = torch.zeros(B, dtype=torch.int32, device=dev)
    live_h = np.ones(B, dtype=bool)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    progress = live
    known = True
    while (live_h & (r_h < _PREEMPT_MAX_ROUNDS)).any():
        if not known:
            live = progress & (r_d < _PREEMPT_MAX_ROUNDS)
            live_h = stats.read_each(live)
            if not live_h.any():
                break
        known = False
        lv = live[:, None]
        key = (base_rounds + r_d)[:, None]
        drained = drained_n = None      # the drain's placements (S = 0)
        if S == 0:
            with stats.span("preempt drain"):
                pend0 = (assigned < 0) & pods.valid & lv
                dsel = ops.top_by_rank(pend0, order,
                                       min(_PREEMPT_DRAIN, P))[0]
                d32 = dsel.to(torch.int32)
                feas_d, masked_d = ops.cycle(
                    alloc, used, pods.requests, static.mask, static.score,
                    static.w_lr, static.w_ba, static.w_ts, static.rw,
                    rows=d32, pending=_take(pend0, dsel), masked=True)
                topv, topi, pick = ops.row_topk(masked_d, K, seeded,
                                                cfg.tie_seed, d32)
                used, choice_d, chosen_d = _deal_commit(
                    alloc, _take(pods.requests, dsel), used, feas_d,
                    masked_d, topv[..., 0] > NEG_INF, _take(rank, dsel),
                    topv, topi, tie_pick=pick, rank_is_sorted=True, ops=ops,
                    stats=stats)
                hit_d = choice_d >= 0
                assigned = assigned.scatter(1, dsel, torch.where(
                    hit_d, choice_d, _take(assigned, dsel)))
                chosen = chosen.scatter(1, dsel, torch.where(
                    hit_d, chosen_d, _take(chosen, dsel)))
                round_of = round_of.scatter(1, dsel, torch.where(
                    hit_d, key, _take(round_of, dsel)))
                drained = hit_d.any(dim=-1)
                if explain:
                    drained_n = hit_d.sum(dim=-1)
        pend = (assigned < 0) & pods.valid & ~tried & lv
        sel = ops.top_by_rank(pend, order, C)[0]
        s32 = sel.to(torch.int32)
        real = _take(pend, sel)
        req_sel = _take(pods.requests, sel)
        rank_sel = _take(rank, sel)
        with stats.span("preempt plain evaluation"):
            (feas_pl, masked_pl, n_plain, sc_plain, pair_ok,
             view) = _bidder_rows(cfg, snap, static, sel, used, st, dom_s,
                                  ops)
            can_plain = (sc_plain > NEG_INF) & real
            if S == 0:
                mask_rows, rows = static.mask, s32
            else:
                snap_v, static_v = view
                mask_rows, rows = static_v.mask, None
        hp_sel = _take(has_pair, sel)
        plain_excl = can_plain & hp_sel
        plain_cap = can_plain & ~hp_sel
        # Gang members never preempt.
        pre_active = real & ~can_plain & (_take(pods.group, sel) < 0)
        with stats.span("preempt auction"):
            (target, claimed, takes_evict, vidx_t, freed_req, usage,
             could_bid) = kpre.preempt_auction(
                cfg, snap, pctx, _take(prio, sel), req_sel, mask_rows,
                used, evicted, plain_excl, n_plain, rank=rank_sel, ops=ops,
                rows=rows, pair_ok=pair_ok, pre_active=pre_active)
        could_bid = could_bid | plain_cap
        with stats.span("preempt budget gate"):
            keep = _budget_gate(snap, evicted, claimed, usage)
            keep_evict = keep & takes_evict
            evicted2 = _evict_round(evicted, vidx_t, keep_evict)
        tgt_c = target.clamp(0, N - 1).long()
        with stats.span("preempt plain commit"):
            taken = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
            taken = taken.scatter_(1, torch.where(keep, tgt_c, N),
                                   True)[:, :N]
            feas_c = feas_pl & plain_cap[..., None] & ~taken[:, None, :]
            masked_c = torch.where(feas_c, masked_pl, neg)
            topv, topi, pick = ops.row_topk(masked_c, K, seeded,
                                            cfg.tie_seed, s32)
            _, choice_pl, chosen_pl = _deal_commit(
                alloc, req_sel, used, feas_c, masked_c,
                plain_cap & (topv[..., 0] > NEG_INF), rank_sel, topv, topi,
                tie_pick=pick, rank_is_sorted=True, ops=ops, stats=stats)
        keep_pl = choice_pl >= 0
        keep_all = keep | keep_pl
        target_all = torch.where(keep_pl, choice_pl, target)
        if S:
            with stats.span("preempt pairwise fixpoint"):
                # The pair state stays eviction-free through these rounds
                # (JAX's choice: every check then equals the audit's
                # no-eviction arm). Keeps revert to pending until the
                # end-of-round state validates them all; their victims
                # stay evicted. Each tenant runs its own fixpoint.
                if compact_pv:
                    snap_pv, static_pv = snap_v, static_v
                    choice_pv = torch.where(keep_all, target_all, -1)
                    keep_pv, hp_pv, rank_pv = keep_all, hp_sel, rank_sel
                else:
                    snap_pv, static_pv = snap, static
                    choice_pv = torch.full(
                        (B, P), -1, dtype=torch.int32, device=dev).scatter(
                        1, sel, torch.where(keep_all, target_all, -1))
                    keep_pv = torch.zeros(
                        (B, P), dtype=torch.bool, device=dev).scatter(
                        1, sel, keep_all)
                    hp_pv, rank_pv = has_pair, rank
                sig_pv = static_pv.sig_match
                st = ops.pair_commit(snap_pv, st, sig_pv, dom_s, choice_pv,
                                     keep_pv, 1.0)
                kept = keep_pv
                flag = (keep_pv & hp_pv).any(dim=-1)
                while stats.read(flag.any()):
                    ia_ok = ops.ia_ok_at_choice(
                        snap_pv, st, sig_pv, dom_s, choice_pv,
                        torch.where(kept, choice_pv, -1))
                    bad = kept & hp_pv & ~ia_ok
                    bad = bad | (kept & _spread_excess_mask(
                        snap_pv, static_pv.aff_ok, rank_pv, choice_pv, kept,
                        st, dom_s, ops))
                    bad = bad & flag[:, None]
                    st = ops.pair_commit(snap_pv, st, sig_pv, dom_s,
                                         choice_pv, bad, -1.0)
                    kept = kept & ~bad
                    flag = bad.any(dim=-1)
                valid = kept if compact_pv else _take(kept, sel)
                keep = keep & valid
                keep_pl = keep_pl & valid
                keep_all = keep | keep_pl
        with stats.span("preempt used"):
            # One claimant a node of a tenant: every row that does not
            # keep adds an exact 0.0, so the adds are exact in any order.
            at_n = tgt_c[..., None].expand(B, C, R)
            for add in (torch.where(keep_evict[..., None], -freed_req, zero),
                        torch.where(keep[..., None], req_sel, zero)):
                used = used.scatter_add(1, at_n, add)
            used = ops.node_add(used, choice_pl, keep_pl, req_sel, rank_sel)
        assigned = assigned.scatter(1, sel, torch.where(
            keep_all, target_all, _take(assigned, sel)))
        # Preempted placements carry no score (as in parity mode).
        chosen = chosen.scatter(1, sel, torch.where(
            keep_pl, chosen_pl, torch.where(
                keep & can_plain, sc_plain,
                torch.where(keep, neg, _take(chosen, sel)))))
        round_of = round_of.scatter(1, sel, torch.where(
            keep_all, key, _take(round_of, sel)))
        if explain:
            with stats.span("preempt explain"):
                ex = _explain_round(ex, live, r_d, key, s32, vidx_t,
                                    keep_evict, usage, GP, evicted, (
                                        real, real & can_plain, pre_active,
                                        claimed, keep_evict,
                                        keep_all & ~takes_evict),
                                    drained_n, real & ~could_bid)
        evicted = evicted2
        # A kept pod is placed, a pod with no placement and no prefix
        # anywhere is spent until the state changes, a deferred one bids
        # again; any keep or drain placement clears the tenant's spent
        # marks.
        newly = real & (keep_all | ~could_bid)
        reset = keep_all.any(dim=-1)
        if drained is not None:
            reset = reset | drained
        tried = torch.where(reset[:, None], False, tried.scatter(
            1, sel, _take(tried, sel) | newly))
        progress = reset | newly.any(dim=-1)
        r_h = r_h + live_h
        r_d = r_d + live.to(torch.int32)
    stats.preempt_rounds = int(r_h[0]) if B == 1 else r_h.tolist()
    out = (used, assigned, st, evicted, round_of, chosen, r_d, r_h)
    return out + ((ex,) if explain else ())


def _explain_round(ex, live, r_d, key, s32, vidx_t, keep_evict, usage,
                   GP, evicted, counted, drained_n, no_bid):
    """The explained solve's provenance after one round, tenant-batched
    and out of place: keep_evict is the evictions' own mask
    (pre-validation), a scatter-max over a -1 start names each victim's
    evicting pod and commit key (the sentinel slot M takes the rest),
    and the round's counts fill its row of each live tenant's auction
    table."""
    evictor, evict_rd, astats = ex
    B, M = evicted.shape
    dev = evicted.device
    vmask = keep_evict[..., None] & (vidx_t < M)
    vslot = torch.where(vmask, vidx_t, M).long().flatten(-2)
    acc = []
    for prev, val in ((evictor, s32[..., None]), (evict_rd, key[..., None])):
        src = torch.where(vmask, val, -1).to(torch.int32).flatten(-2)
        hit = torch.full((B, M + 1), -1, dtype=torch.int32,
                         device=dev).scatter_reduce(-1, vslot, src, "amax")
        acc.append(torch.maximum(prev, hit[:, :M]))
    ev_round = _evict_round(torch.zeros_like(evicted), vidx_t, keep_evict)
    spent = (torch.where(keep_evict[..., None], usage, 0).sum(dim=(-2, -1))
             if GP else torch.zeros(B, dtype=torch.int64, device=dev))
    if drained_n is None:
        drained_n = torch.zeros(B, dtype=torch.int64, device=dev)
    row = torch.stack([*(m.sum(-1) for m in counted), drained_n,
                       ev_round.sum(-1), spent, no_bid.sum(-1)],
                      dim=-1).to(torch.float32)
    at = (torch.arange(B, device=dev),
          r_d.long().clamp(max=astats.shape[1] - 1))
    astats = astats.index_put(at, torch.where(live[:, None], row,
                                              astats[at]))
    return acc[0], acc[1], astats


def solve_rounds(cfg: EngineConfig, snap: ClusterSnapshot,
                 node_sat_t: torch.Tensor | None,
                 member_sat_t: torch.Tensor | None = None,
                 static: StaticCtx | None = None, ops: "Ops | None" = None,
                 stats: RoundStats | None = None, explain: bool = False):
    """Fast mode: batched commit rounds. Returns (assigned, chosen, used,
    order, round_of, rounds, evicted); round_of is the commit key (pods
    of an earlier round committed strictly earlier; with signatures a
    round's kept commits were validated against its end-of-round
    state). member_sat_t: the [A, M+P] member label table, needed with
    signatures. explain=True appends JAX's provenance tuple (rolled [P],
    evictor [M], evict_round [M], the auction table; see
    _preempt_rounds), with the same placements and host reads.

    A tenant batch (a leading [B] axis; tenants.solve_many) runs the
    rounds of every tenant at once, with or without signatures and
    preemption, then gates every tenant's gangs; rounds is then [B]."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    if static is None:
        static = precompute_static(cfg, snap, node_sat_t, member_sat_t,
                                   ops=ops)
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[-1]
    N = nodes.valid.shape[-1]
    M = snap.running.valid.shape[-1]
    dev = pods.valid.device
    order = pop_order(cfg, snap)
    rank = _rank_of(order)
    # Worst case one pod commits per round; cfg.max_rounds > 0 caps it.
    max_rounds = cfg.max_rounds if cfg.max_rounds > 0 else 2 * P + 8
    K = _fallback_depth(N)
    st = dom_s = None
    has_pair = torch.zeros(pods.valid.shape, dtype=torch.bool, device=dev)
    if snap.sigs.key.shape[-1] == 0:
        used, assigned, chosen, round_of, rounds = _solve_rounds_nosig(
            cfg, snap, static, rank, order, max_rounds, K, ops=ops,
            stats=stats)
    else:
        dom_s = kpair.sig_domains(snap)
        st0 = ops.pair_counts(static.sig_match, dom_s, snap.running, pods)
        invol, has_pair = _sig_involvement(snap, static, st0)
        used, assigned, st, chosen, round_of, rounds = _solve_rounds_sig(
            cfg, snap, static, rank, order, st0, invol, has_pair,
            max_rounds, K, _compact_cap(cfg, P), ops, stats)
    evicted = torch.zeros(snap.running.valid.shape, dtype=torch.bool,
                          device=dev)
    ex = None
    if cfg.preemption and M > 0:
        reads0 = stats.host_reads
        with stats.span("preemption rounds"):
            used, assigned, st, evicted, round_of, chosen, pre_r, *more = (
                _preempt_rounds(cfg, snap, static, rank, order, rounds, used,
                                assigned, st, round_of, chosen, has_pair,
                                dom_s, ops, stats, explain))
        ex = more[0] if explain else None
        stats.preempt_reads = stats.host_reads - reads0
        rounds = rounds + pre_r
    used, assigned, chosen, _, rolled = gang_rollback(
        snap, used, assigned, chosen, st, static.sig_match, dom_s, ops)
    round_of = torch.where(rolled, -1, round_of)
    if not isinstance(rounds, torch.Tensor):
        rounds = torch.full((), rounds, dtype=torch.int32, device=dev)
    out = (assigned, chosen, used, order, round_of, rounds, evicted)
    if not explain:
        return out
    if ex is None:
        ex = (torch.full((M,), -1, dtype=torch.int32, device=dev),
              torch.full((M,), -1, dtype=torch.int32, device=dev),
              torch.zeros((_PREEMPT_MAX_ROUNDS, len(EXPLAIN_AUCTION_STATS)),
                          dtype=torch.float32, device=dev))
    return out + ((rolled, *ex),)


# -- the incremental warm path: K19, K20 and the frontier rounds -----------


def capacity_prefix_keep_plain(alloc: torch.Tensor, used: torch.Tensor,
                               requests: torch.Tensor, node: torch.Tensor,
                               rank: torch.Tensor,
                               active: torch.Tensor) -> torch.Tensor:
    """[P] bool (JAX `_capacity_prefix_keep`): per node, the longest
    rank-ordered prefix of the active rows whose summed requests fit
    alloc - used, for every resource. Each node's sum runs from 0.0
    over its own rows in rank order, one add a row, not JAX's global
    cumsum less the segment's offset (at config-5 magnitudes that
    difference cancels ~1e7 bytes a term, ROADMAP C5); the first misfit
    ends the node's prefix, as JAX's cummax of the last misfit does."""
    P = node.shape[0]
    N = alloc.shape[0]
    perm, node_s = _by_node_rank(node, active, rank, N)
    act = node_s < N
    seg = _segment_start(node_s)
    idx = torch.arange(P, device=node.device)
    pos = idx - seg
    req_s = torch.where(act[:, None], requests[perm.long()],
                        torch.zeros((), dtype=requests.dtype,
                                    device=requests.device))
    run = torch.zeros_like(req_s)
    j = 0
    while True:
        rows = torch.nonzero(act & (pos == j))[:, 0]
        if rows.numel() == 0:
            break
        prev = run[rows - 1] if j else torch.zeros_like(req_s[rows])
        run[rows] = prev + req_s[rows]
        j += 1
    cn = node_s.clamp(max=N - 1).long()
    fits = (used[cn] + run <= alloc[cn]).all(dim=-1) & act
    bad = act & ~fits
    last_bad = torch.cummax(torch.where(bad, idx, -1), dim=0).values
    keep = torch.zeros(P, dtype=torch.bool, device=node.device)
    keep[perm.long()] = fits & (last_bad < seg)
    return keep


def capacity_prefix_keep(alloc: torch.Tensor, used: torch.Tensor,
                         requests: torch.Tensor, node: torch.Tensor,
                         rank: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """Kernel K19 on CUDA tensors (after the library sort by (node,
    rank), one thread walks each node's rows), the plain version on CPU
    tensors."""
    dev = node.device
    if dev.type == "cpu":
        return capacity_prefix_keep_plain(alloc, used, requests, node, rank,
                                          active)
    P = node.shape[0]
    N, R = alloc.shape
    k = "capacity_prefix_keep"
    if R > 16:
        raise ValueError(f"{k}: {R} resources, the kernel holds at most 16")
    check(k, dev, alloc, torch.float32, (N, R))
    check(k, dev, used, torch.float32, (N, R))
    check(k, dev, requests, torch.float32, (P, R))
    keep = torch.zeros(P, dtype=torch.bool, device=dev)
    if P == 0:
        return keep
    perm, node_s = _by_node_rank(node, active, rank, N)
    _build.launch("tpusched_capacity_prefix_keep", P, N, R,
                  *ptrs((perm, node_s, requests, alloc, used, keep)),
                  stream_of(dev))
    capacity_prefix_keep.launches += 1
    return keep


capacity_prefix_keep.launches = 0


def frontier_closure_plain(invol: torch.Tensor | None, fr0: torch.Tensor,
                           valid: torch.Tensor, carry: torch.Tensor,
                           dirty_node: torch.Tensor | None,
                           mask: torch.Tensor):
    """JAX `solve_incremental`'s frontier closure and first revalidation
    pass: the signatures a dirty pod is involved in go hot, every pod
    involved in a hot one joins the frontier, and so does every carried
    pod on a dirty node; the rest of the carried pods stay carried if
    their static mask still holds at the carried node. carry is -1
    where a pod carries nothing (invalid rows included). Returns
    (frontier [P] bool, carried [P] bool, the frontier count: pods
    without a carry or in the closure, before the revalidation)."""
    P = fr0.shape[0]
    fr = fr0 & valid
    if invol is not None and invol.shape[1] > 0:
        hot = (invol & fr[:, None]).any(dim=0)                   # [S]
        fr = fr | (invol & hot[None, :]).any(dim=1)
    has = carry >= 0
    cc = carry.clamp(min=0).long()
    if dirty_node is not None:
        fr = fr | (has & dirty_node[cc])
    count = ((valid & ~has) | fr).sum().to(torch.int32)
    carried = valid & has & ~fr & mask[torch.arange(P, device=fr.device), cc]
    return fr, carried, count


def frontier_closure(invol: torch.Tensor | None, fr0: torch.Tensor,
                     valid: torch.Tensor, carry: torch.Tensor,
                     dirty_node: torch.Tensor | None, mask: torch.Tensor):
    """Kernel K20 on CUDA tensors (two launches: the hot signatures,
    then the per-pod pass), the plain version on CPU tensors."""
    dev = fr0.device
    if dev.type == "cpu":
        return frontier_closure_plain(invol, fr0, valid, carry, dirty_node,
                                      mask)
    P, N = mask.shape
    S = 0 if invol is None else invol.shape[1]
    k = "frontier_closure"
    for t in (fr0, valid):
        check(k, dev, t, torch.bool, (P,))
    check(k, dev, carry, torch.int32, (P,))
    check(k, dev, mask, torch.bool, (P, N))
    if invol is not None:
        check(k, dev, invol, torch.bool, (P, S))
    if dirty_node is not None:
        check(k, dev, dirty_node, torch.bool, (N,))
    fr = torch.empty(P, dtype=torch.bool, device=dev)
    carried = torch.empty(P, dtype=torch.bool, device=dev)
    hot = torch.zeros(max(S, 1), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if P == 0:
        return fr, carried, count
    _build.launch("tpusched_frontier_closure", P, N, S,
                  *ptrs((invol, fr0, valid, carry, dirty_node, mask, hot, fr,
                         carried, count)), stream_of(dev))
    frontier_closure.launches += 1
    return fr, carried, count


frontier_closure.launches = 0


# Layout of the incremental solve's audit tail (appended to the packed
# solve buffer): [capacity violations, carried static violations,
# carried pairwise violations, carried count, frontier count].
INC_AUDIT_LEN = 5


def solve_incremental(cfg: EngineConfig, snap: ClusterSnapshot,
                      tab: WarmTableau, carry: torch.Tensor,
                      carry_chosen: torch.Tensor, frontier0: torch.Tensor,
                      dirty_node: torch.Tensor | None, cap: int,
                      ops: "Ops | None" = None,
                      stats: RoundStats | None = None):
    """Fast rounds seeded with the previous cycle's placements (JAX
    `solve_incremental`): only the frontier is solved.

      1. The frontier (frontier0, the lineage's dirty pods) closes over
         the signatures its pods are involved in and over the carried
         pods on dirty nodes; a carried pod whose static mask fails at
         its node spills (K20).
      2. Per node, the longest rank-ordered prefix of carried pods that
         fits current capacity stays; the rest spill (K19).
      3. The survivors are committed (K8's node_add, K10's pair_commit)
         and, with signatures, revalidated to a fixpoint (K14 and K13;
         spills leave through node_add and pair_commit with sign -1).
      4. The frontier is placed by the fast rounds from that state at
         r = 1 (carried commit key 0), frontier-compacted at width `cap`
         (0: full width); then preemption rounds and the gang gate.

    Not bitwise equal to a cold solve: held to the validity contract,
    which the audit tail re-checks (capacity over alloc, carried pods
    off their static mask, carried pods in pairwise violation).
    carry [P] int32 carried node (-1 none), carry_chosen [P] f32 their
    scores, frontier0 [P] bool, dirty_node [N] bool or None. Returns
    (assigned, chosen, used, order, round_of, rounds, evicted,
    audit [INC_AUDIT_LEN] f32)."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    static = finalize_static(cfg, snap, tab, ops)
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    N = nodes.valid.shape[0]
    M = snap.running.valid.shape[0]
    S = snap.sigs.key.shape[0]
    dev = pods.valid.device
    order = pop_order(cfg, snap)
    rank = torch.zeros(P, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(P, dtype=torch.int32, device=dev)
    max_rounds = cfg.max_rounds if cfg.max_rounds > 0 else 2 * P + 8
    K = _fallback_depth(N)
    st = dom_s = invol = None
    has_pair = torch.zeros(P, dtype=torch.bool, device=dev)
    if S:
        dom_s = kpair.sig_domains(snap)
        st0 = ops.pair_counts(static.sig_match, dom_s, snap.running, pods)
        invol, has_pair = _sig_involvement(snap, static, st0)
    carry = torch.where(pods.valid, carry, -1).contiguous()
    with stats.span("K20 frontier_closure"):
        _, carried, frontier_n = ops.frontier_closure(
            invol, frontier0, pods.valid, carry, dirty_node, tab.mask)
    with stats.span("K19 capacity_prefix_keep"):
        carried = ops.capacity_prefix_keep(nodes.allocatable, nodes.used,
                                           pods.requests, carry, rank,
                                           carried)
    used = ops.node_add(nodes.used, carry, carried, pods.requests, rank)
    if S:
        st = ops.pair_commit(snap, st0, static.sig_match, dom_s, carry,
                             carried, 1.0)
        # A spill can take away the match another carried pod's
        # positive affinity needs: revalidate until nothing spills.
        flag = (carried & has_pair).any()
        while stats.read(flag):
            with stats.span("carried revalidation"):
                ia = ops.ia_ok_at_choice(snap, st, static.sig_match, dom_s,
                                         carry,
                                         torch.where(carried, carry, -1))
                bad = (carried & has_pair & ~ia) | (
                    carried & _spread_excess_mask(
                        snap, tab.aff_ok, rank, carry, carried, st, dom_s,
                        ops))
                st = ops.pair_commit(snap, st, static.sig_match, dom_s,
                                     carry, bad, -1.0)
                used = ops.node_add(used, carry, bad, pods.requests, rank,
                                    -1.0)
                carried = carried & ~bad
                flag = bad.any()
    assigned = torch.where(carried, carry, -1)
    chosen = torch.where(carried, carry_chosen,
                         torch.full((), NEG_INF, dtype=torch.float32,
                                    device=dev))
    round_of = torch.where(carried, 0, -1).to(torch.int32)
    carried_n = carried.sum().to(torch.float32)
    if S == 0:
        used, assigned, chosen, round_of, rounds = _solve_rounds_nosig(
            cfg, snap, static, rank, order, max_rounds, K,
            cap=cap if cap > 0 else None, ops=ops, stats=stats,
            init=((used, assigned, chosen, round_of), 1), skip_full=True)
    else:
        init = (used, assigned, st, torch.zeros(P, dtype=torch.bool,
                                                device=dev),
                chosen, round_of, 1)
        used, assigned, st, chosen, round_of, rounds = _solve_rounds_sig(
            cfg, snap, static, rank, order, st0, invol, has_pair,
            max_rounds, K, cap, ops, stats, init=init)
    evicted = torch.zeros(M, dtype=torch.bool, device=dev)
    if cfg.preemption and M > 0:
        with stats.span("preemption rounds"):
            used, assigned, st, evicted, round_of, chosen, pre_r = (
                _preempt_rounds(cfg, snap, static, rank, order, rounds, used,
                                assigned, st, round_of, chosen, has_pair,
                                dom_s, ops, stats))
        rounds += pre_r
    used, assigned, chosen, st, rolled = gang_rollback(
        snap, used, assigned, chosen, st, static.sig_match, dom_s, ops)
    round_of = torch.where(rolled, -1, round_of)

    # The audit. A relative tolerance: requests run from millicores to
    # bytes.
    alloc = nodes.allocatable
    tol = torch.clamp_min(alloc.abs() * 1e-5, 1e-4)
    cap_bad = (used > alloc + tol) & (used > nodes.used + tol)
    final = carried & (assigned == carry) & (assigned >= 0)
    ar = torch.arange(P, device=dev)
    s_viol = (final & ~tab.mask[ar, assigned.clamp(min=0).long()]).sum()
    p_viol = torch.zeros((), dtype=torch.int64, device=dev)
    if S:
        st_car = ops.pair_commit(
            snap, ops.pair_counts(static.sig_match, dom_s, snap.running,
                                  pods),
            static.sig_match, dom_s, carry, final, 1.0)
        ia_f = ops.ia_ok_at_choice(snap, st_car, static.sig_match, dom_s,
                                   carry, torch.where(final, carry, -1))
        sp_f = _spread_excess_mask(snap, tab.aff_ok, rank, carry, final,
                                   st_car, dom_s, ops)
        p_viol = (final & has_pair & ~ia_f).sum() + sp_f.sum()
    audit = torch.stack([cap_bad.sum(), s_viol, p_viol]).to(torch.float32)
    audit = torch.cat([audit, carried_n[None],
                       frontier_n.to(torch.float32)[None]])
    rounds = torch.full((), rounds, dtype=torch.int32, device=dev)
    return (assigned, chosen, used, order, round_of, rounds, evicted, audit)


# -- the kernel table -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ops:
    """The device programs a solve calls: the kernel wrappers (KERNELS,
    what every entry point uses) or their plain versions (PLAIN, for
    holding a whole solve on the card against the same solve without a
    kernel)."""

    atom_sat: Callable
    tableau_cells: Callable
    finalize_score: Callable
    parity_scan: Callable
    cycle: Callable
    row_topk: Callable
    desirability: Callable
    prefix_commit: Callable          # the plain loop's sub-step (a hook)
    prefix_commit_loop: Callable
    sig_match: Callable
    pair_counts: Callable
    pairwise_batch: Callable
    parity_scan_pair: Callable
    node_add: Callable
    pair_commit: Callable
    ia_ok_at_choice: Callable
    waterfill: Callable
    excess_min: Callable
    excess_survive: Callable
    parity_scan_preempt: Callable
    parity_scan_pair_preempt: Callable
    auction_ok: Callable
    auction_tables: Callable
    auction_rank: Callable
    auction_claim: Callable
    capacity_prefix_keep: Callable
    frontier_closure: Callable
    explain_cells: Callable
    explain_terms: Callable
    deal: Callable
    top_by_rank: Callable


KERNELS = Ops(atom_sat, _tableau_cells, finalize_score, parity_scan, cycle,
              row_topk, desirability, prefix_commit_plain,
              prefix_commit_loop, kpair.sig_match,
              kpair.pair_counts, kpair.pairwise_batch, parity_scan_pair,
              node_add, kpair.pair_commit, kpair.ia_ok_at_choice, waterfill,
              excess_min, excess_survive, parity_scan_preempt,
              parity_scan_pair_preempt, kpre.auction_ok, kpre.auction_tables,
              kpre.auction_rank, kpre.auction_claim, capacity_prefix_keep,
              frontier_closure, kexplain.explain_cells,
              kexplain.explain_terms, deal, top_by_rank)
PLAIN = Ops(atom_sat_plain, _tableau_cells_plain, finalize_score_plain,
            parity_scan_plain, cycle_plain, row_topk_plain,
            desirability_plain, prefix_commit_plain,
            prefix_commit_loop_plain, kpair.sig_match_plain,
            kpair.pair_counts_plain, kpair.pairwise_batch_plain,
            parity_scan_pair_plain, node_add_plain, kpair.pair_commit_plain,
            kpair.ia_ok_at_choice_plain, waterfill_plain, excess_min_plain,
            excess_survive_plain, parity_scan_preempt_plain,
            parity_scan_pair_preempt_plain, kpre.auction_ok_plain,
            kpre.auction_tables_plain, kpre.auction_rank_plain,
            kpre.auction_claim_plain, capacity_prefix_keep_plain,
            frontier_closure_plain, kexplain.explain_cells_plain,
            kexplain.explain_terms_plain, deal_plain, top_by_rank_plain)
