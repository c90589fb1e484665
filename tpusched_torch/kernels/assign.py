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
    `prefix_commit`). With signatures a round also water-fills spread
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

Every kernel wrapper runs its plain version (`*_plain`) on CPU tensors.
The solve functions take an `Ops` table (default: the kernel wrappers);
`PLAIN` holds the plain versions, with which a caller can run a whole
solve on CUDA tensors without a kernel, to compare.

The JAX fast rounds are `lax.while_loop`s on the device. Here they are
Python loops that read one device flag per round (preemption rounds
included), per commit sub-step, per tranche, per validation pass and
per hand-off from full-width to compacted rounds; `RoundStats` counts
those reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from tpusched_torch import _build
from tpusched_torch.config import DO_NOT_SCHEDULE, EngineConfig
from tpusched_torch.kernels import check, ptrs, stream_of
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


# -- K2: the cell-local tableau ---------------------------------------------


def _tableau_cells_plain(snap: ClusterSnapshot, pods_v: PodArrays,
                         nodes_v: NodeArrays, node_sat_v: torch.Tensor):
    """(mask, aff_ok, na_raw, tt_count), each [P, N], in the JAX op
    sequence."""
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
    A, N = node_sat_v.shape
    P, T, AT = pods_v.req_term_atoms.shape
    PT = pods_v.pref_term_atoms.shape[1]
    TN = nodes_v.taint_ids.shape[1]
    VT = snap.taint_effect.shape[0]
    k = "tableau_cells"
    check(k, dev, node_sat_v, torch.bool, (A, N))
    check(k, dev, pods_v.req_term_atoms, torch.int32, (P, T, AT))
    check(k, dev, pods_v.req_term_valid, torch.bool, (P, T))
    check(k, dev, pods_v.pref_term_atoms, torch.int32, (P, PT, AT))
    check(k, dev, pods_v.pref_term_valid, torch.bool, (P, PT))
    check(k, dev, pods_v.pref_weight, torch.float32, (P, PT))
    check(k, dev, nodes_v.taint_ids, torch.int32, (N, TN))
    check(k, dev, snap.taint_effect, torch.int8, (VT,))
    check(k, dev, pods_v.tolerated, torch.bool, (P, VT))
    check(k, dev, nodes_v.schedulable, torch.bool, (N,))
    check(k, dev, nodes_v.valid, torch.bool, (N,))
    check(k, dev, pods_v.tolerates_unsched, torch.bool, (P,))
    check(k, dev, pods_v.valid, torch.bool, (P,))
    mask = torch.empty((P, N), dtype=torch.bool, device=dev)
    aff_ok = torch.empty((P, N), dtype=torch.bool, device=dev)
    na_raw = torch.empty((P, N), dtype=torch.float32, device=dev)
    tt_count = torch.empty((P, N), dtype=torch.float32, device=dev)
    if P * N == 0:
        return mask, aff_ok, na_raw, tt_count
    args = (node_sat_v, pods_v.req_term_atoms, pods_v.req_term_valid,
            pods_v.pref_term_atoms, pods_v.pref_term_valid,
            pods_v.pref_weight, nodes_v.taint_ids, snap.taint_effect,
            pods_v.tolerated, nodes_v.schedulable, nodes_v.valid,
            pods_v.tolerates_unsched, pods_v.valid,
            mask, aff_ok, na_raw, tt_count)
    _build.launch("tpusched_tableau_cells", P, N, A, T, AT, PT, TN, VT,
                  *(t.data_ptr() for t in args), stream_of(dev))
    _tableau_cells.launches += 1
    return mask, aff_ok, na_raw, tt_count


_tableau_cells.launches = 0


# -- K3: row-coupled normalisation x QoS weights ----------------------------


def finalize_score_plain(na_raw: torch.Tensor, tt_count: torch.Tensor,
                         node_valid: torch.Tensor, w_na: torch.Tensor,
                         w_tt: torch.Tensor) -> torch.Tensor:
    """[P, N] f32 w_na*default_normalize(na_raw) + w_tt*tt_score."""
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
    P, N = na_raw.shape
    k = "finalize_static"
    check(k, dev, na_raw, torch.float32, (P, N))
    check(k, dev, tt_count, torch.float32, (P, N))
    check(k, dev, node_valid, torch.bool, (N,))
    check(k, dev, w_na, torch.float32, (P,))
    check(k, dev, w_tt, torch.float32, (P,))
    score = torch.empty((P, N), dtype=torch.float32, device=dev)
    if P * N == 0:
        return score
    _build.launch("tpusched_finalize_static", P, N,
                  *(t.data_ptr() for t in (na_raw, tt_count, node_valid,
                                           w_na, w_tt, score)),
                  stream_of(dev))
    finalize_score.launches += 1
    return score


finalize_score.launches = 0


def finalize_static(cfg: EngineConfig, snap: ClusterSnapshot, mask, aff_ok,
                    na_raw, tt_count, sig_match: torch.Tensor | None = None,
                    ops: "Ops | None" = None) -> StaticCtx:
    """StaticCtx from the tableau: per-pod QoS plugin weights (plain
    torch over [P]) and the row-normalised static score (K3). sig_match
    None: no signature (an empty [0, M+P] table)."""
    ops = ops or KERNELS
    pods = snap.pods
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    score = ops.finalize_score(na_raw, tt_count, snap.nodes.valid,
                               w["node_affinity"], w["taint_toleration"])
    if sig_match is None:
        sig_match = torch.zeros((0, snap.running.valid.shape[0]
                                 + pods.valid.shape[0]),
                                dtype=torch.bool, device=mask.device)
    return StaticCtx(
        mask=mask, aff_ok=aff_ok, score=score, sig_match=sig_match,
        w_lr=w["least_requested"], w_ba=w["balanced_allocation"],
        w_ts=w["topology_spread"], w_ia=w["interpod_affinity"],
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=mask.device),
    )


def precompute_static(cfg: EngineConfig, snap: ClusterSnapshot,
                      node_sat_t: torch.Tensor,
                      member_sat_t: torch.Tensor | None = None,
                      ops: "Ops | None" = None) -> StaticCtx:
    """StaticCtx (K2, K3, and K9 when the snapshot has signatures;
    member_sat_t, the [A, M+P] member label table, is then required)."""
    ops = ops or KERNELS
    cells = ops.tableau_cells(snap, snap.pods, snap.nodes, node_sat_t)
    sm = None
    if snap.sigs.key.shape[0] > 0:
        sm = ops.sig_match(member_sat_t, snap.sigs, kpair.merge_members(
            snap.running.namespace, snap.pods.namespace))
    return finalize_static(cfg, snap, *cells, sig_match=sm, ops=ops)


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
    the JAX side."""
    pods = snap.pods
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail)
    key = torch.where(pods.valid, prio,
                      torch.full((), NEG_INF, dtype=prio.dtype,
                                 device=prio.device))
    return torch.sort(-key, stable=True).indices


def parity_scan_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                      static: StaticCtx, order: torch.Tensor):
    """The sequential commit loop in plain torch: (assigned [P] int32,
    chosen [P] f32, used [N, R] f32)."""
    return _scan_loop(cfg, snap, static, order)[:3]


def parity_scan_pair_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                           static: StaticCtx, order: torch.Tensor,
                           st: "kpair.PairState", dom_s: torch.Tensor):
    """The sequential commit loop with pairwise constraints, in plain
    torch: (assigned, chosen, used, final PairState)."""
    return _scan_loop(cfg, snap, static, order, st, dom_s)[:4]


def parity_scan_preempt_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                              static: StaticCtx, order: torch.Tensor,
                              pctx: "kpre.PreemptCtx"):
    """The sequential commit loop with preemption, in plain torch:
    (assigned, chosen, used, evicted [M] bool)."""
    a, c, u, _, ev = _scan_loop(cfg, snap, static, order, pctx=pctx)
    return a, c, u, ev


def parity_scan_pair_preempt_plain(cfg: EngineConfig, snap: ClusterSnapshot,
                                   static: StaticCtx, order: torch.Tensor,
                                   st: "kpair.PairState",
                                   dom_s: torch.Tensor,
                                   pctx: "kpre.PreemptCtx"):
    """The sequential commit loop with pairwise constraints and
    preemption, in plain torch: (assigned, chosen, used, final
    PairState, evicted)."""
    return _scan_loop(cfg, snap, static, order, st, dom_s, pctx)


def _scan_loop(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
               order: torch.Tensor, st: "kpair.PairState | None" = None,
               dom_s: torch.Tensor | None = None,
               pctx: "kpre.PreemptCtx | None" = None):
    """JAX solve_sequential's scan body, pod by pod in `order`; with a
    pair state, pairwise_row before and pair_state_add_pod after each
    commit; with a victim table (pctx), the PostFilter branch
    (`_preempt_branch`) for every valid pod outside a gang that fits
    nowhere. Returns (assigned, chosen, used, st, evicted)."""
    P = order.shape[0]
    dev = order.device
    pods = snap.pods
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    used = snap.nodes.used.clone()
    assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    chosen = torch.full((P,), NEG_INF, dtype=torch.float32, device=dev)
    evicted = torch.zeros(snap.running.valid.shape[0], dtype=torch.bool,
                          device=dev)
    requests = pods.requests
    if pctx is not None:
        prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                                  pods.observed_avail)
        may_preempt = (pods.valid & (pods.group < 0)).tolist()
    for p in order.tolist():
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
        assigned[p] = best_n
    return assigned, chosen, used, st, evicted


def _scan_args(k: str, cfg: EngineConfig, snap: ClusterSnapshot,
               static: StaticCtx, order: torch.Tensor) -> tuple:
    """Check K4's arguments (both variants): (P, N, R, order, the [P, N]
    and per-pod tensors, seeded, seed)."""
    dev = static.mask.device
    P, N = static.mask.shape
    R = snap.nodes.allocatable.shape[1]
    order32 = order.to(torch.int32).contiguous()
    check(k, dev, order32, torch.int32, (P,))
    check(k, dev, static.mask, torch.bool, (P, N))
    check(k, dev, static.score, torch.float32, (P, N))
    check(k, dev, snap.nodes.allocatable, torch.float32, (N, R))
    check(k, dev, snap.nodes.used, torch.float32, (N, R))
    check(k, dev, snap.pods.requests, torch.float32, (P, R))
    for w in (static.w_lr, static.w_ba, static.w_ts, static.w_ia):
        check(k, dev, w, torch.float32, (P,))
    check(k, dev, static.rw, torch.float32, (R,))
    if R > 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes <= 8")
    ins = (order32, static.mask, static.score, snap.nodes.allocatable,
           snap.pods.requests, static.w_lr, static.w_ba, static.w_ts,
           static.w_ia, static.rw)
    return (P, N, R, *ins, int(cfg.tie_break == "seeded"),
            cfg.tie_seed & 0xFFFFFFFF)


def parity_scan(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
                order: torch.Tensor):
    """Kernel K4 on CUDA tensors, the plain version on CPU tensors."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_plain(cfg, snap, static, order)
    args = _scan_args("parity_scan", cfg, snap, static, order)
    P = args[0]
    used = snap.nodes.used.clone()
    assigned = torch.empty((P,), dtype=torch.int32, device=dev)
    chosen = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return assigned, chosen, used
    _build.launch("tpusched_parity_scan", *ptrs(args), used.data_ptr(),
                  assigned.data_ptr(), chosen.data_ptr(), stream_of(dev))
    parity_scan.launches += 1
    return assigned, chosen, used


parity_scan.launches = 0


def parity_scan_pair(cfg: EngineConfig, snap: ClusterSnapshot,
                     static: StaticCtx, order: torch.Tensor,
                     st: "kpair.PairState", dom_s: torch.Tensor):
    """Kernel K4's pairwise variant on CUDA tensors, the plain version
    on CPU tensors: (assigned, chosen, used, final PairState). `st` (the
    initial state) is left as it was."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_pair_plain(cfg, snap, static, order, st, dom_s)
    k = "parity_scan_pair"
    args = _scan_args(k, cfg, snap, static, order)
    terms = kpair._pair_term_args(k, snap, static.aff_ok, static.sig_match,
                                  dom_s, st)
    P, N = args[0], args[1]
    used = snap.nodes.used.clone()
    assigned = torch.empty((P,), dtype=torch.int32, device=dev)
    chosen = torch.empty((P,), dtype=torch.float32, device=dev)
    out = kpair.PairState(counts=st.counts.clone(), anti=st.anti.clone(),
                          match_tot=st.match_tot.clone())
    if P == 0:
        return assigned, chosen, used, out
    pen = torch.empty((N,), dtype=torch.float32, device=dev)
    raw = torch.empty((N,), dtype=torch.float32, device=dev)
    allowed = torch.empty((N,), dtype=torch.uint8, device=dev)
    # The pairwise block without the state pointers, then the state the
    # kernel updates in place (the copies in `out`).
    _build.launch("tpusched_parity_scan_pair",
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
    updates (the budgets' remaining disruptions, evicted [M] bytes) and
    K15's scratch."""
    dev = static.mask.device
    pods, run = snap.pods, snap.running
    vic = kpre._victim_args(k, cfg, snap, pctx)
    M, R = pctx.req_s.shape
    P, N = static.mask.shape
    J = run.anti_sig.shape[1]
    GP = snap.pdb_allowed.shape[0]
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail).contiguous()
    check(k, dev, prio, torch.float32, (P,))
    check(k, dev, pods.valid, torch.bool, (P,))
    check(k, dev, pods.group, torch.int32, (P,))
    check(k, dev, snap.nodes.valid, torch.bool, (N,))
    check(k, dev, run.node_idx, torch.int32, (M,))
    check(k, dev, run.anti_sig, torch.int32, (M, J))
    check(k, dev, snap.pdb_allowed, torch.float32, (GP,))
    remaining = snap.pdb_allowed.clone()
    evicted = torch.zeros(M, dtype=torch.uint8, device=dev)
    return (*vic[:2], J, *vic[2:], prio, pods.valid, pods.group,
            snap.nodes.valid,
            run.node_idx, run.anti_sig, remaining, evicted,
            *kpre.victim_scratch(M, R, dev))


def parity_scan_preempt(cfg: EngineConfig, snap: ClusterSnapshot,
                        static: StaticCtx, order: torch.Tensor,
                        pctx: "kpre.PreemptCtx"):
    """K4's preemption variant on CUDA tensors (K15's victim search
    inside the scan), the plain version on CPU tensors: (assigned,
    chosen, used, evicted)."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_preempt_plain(cfg, snap, static, order, pctx)
    k = "parity_scan_preempt"
    args = _scan_args(k, cfg, snap, static, order)
    pre = _preempt_args(k, cfg, snap, static, pctx)
    P = args[0]
    used = snap.nodes.used.clone()
    assigned = torch.empty((P,), dtype=torch.int32, device=dev)
    chosen = torch.empty((P,), dtype=torch.float32, device=dev)
    evicted = pre[-4]
    if P:
        _build.launch("tpusched_parity_scan_preempt",
                      *ptrs((*args, *pre, used, assigned, chosen)),
                      stream_of(dev))
        parity_scan_preempt.launches += 1
    return assigned, chosen, used, evicted.bool()


parity_scan_preempt.launches = 0


def parity_scan_pair_preempt(cfg: EngineConfig, snap: ClusterSnapshot,
                             static: StaticCtx, order: torch.Tensor,
                             st: "kpair.PairState", dom_s: torch.Tensor,
                             pctx: "kpre.PreemptCtx"):
    """K4's pairwise and preemption variant on CUDA tensors, the plain
    version on CPU tensors: (assigned, chosen, used, final PairState,
    evicted). `st` is left as it was."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_pair_preempt_plain(cfg, snap, static, order, st,
                                              dom_s, pctx)
    k = "parity_scan_pair_preempt"
    args = _scan_args(k, cfg, snap, static, order)
    terms = kpair._pair_term_args(k, snap, static.aff_ok, static.sig_match,
                                  dom_s, st)
    pre = _preempt_args(k, cfg, snap, static, pctx)
    P, N = args[0], args[1]
    used = snap.nodes.used.clone()
    assigned = torch.empty((P,), dtype=torch.int32, device=dev)
    chosen = torch.empty((P,), dtype=torch.float32, device=dev)
    out = kpair.PairState(counts=st.counts.clone(), anti=st.anti.clone(),
                          match_tot=st.match_tot.clone())
    evicted = pre[-4]
    if P:
        pen = torch.empty((N,), dtype=torch.float32, device=dev)
        raw = torch.empty((N,), dtype=torch.float32, device=dev)
        allowed = torch.empty((N,), dtype=torch.uint8, device=dev)
        _build.launch("tpusched_parity_scan_pair_preempt",
                      *ptrs((*args, *terms[:-3], out.counts, out.anti,
                             out.match_tot, pen, raw, allowed, *pre, used,
                             assigned, chosen)), stream_of(dev))
        parity_scan_pair_preempt.launches += 1
    return assigned, chosen, used, out, evicted.bool()


parity_scan_pair_preempt.launches = 0


def solve_sequential(cfg: EngineConfig, snap: ClusterSnapshot,
                     node_sat_t: torch.Tensor,
                     member_sat_t: torch.Tensor | None = None,
                     ops: "Ops | None" = None):
    """Exact sequential commit (stock scheduleOne semantics). With
    signatures the scan carries the pair state (K10 counts the running
    members, K4's pairwise variant adds each commit). With preemption
    and running pods, the scan runs the PostFilter victim search (K15)
    for each pod that fits nowhere; then the gang gate. Returns
    (assigned, chosen, used, order, evicted)."""
    ops = ops or KERNELS
    static = precompute_static(cfg, snap, node_sat_t, member_sat_t, ops)
    M = snap.running.valid.shape[0]
    order = pop_order(cfg, snap)
    pctx = kpre.precompute(cfg, snap) if cfg.preemption and M else None
    evicted = torch.zeros(M, dtype=torch.bool, device=order.device)
    st = dom_s = None
    if snap.sigs.key.shape[0] > 0:
        dom_s = kpair.sig_domains(snap)
        st0 = ops.pair_counts(static.sig_match, dom_s, snap.running,
                              snap.pods)
        if pctx is None:
            assigned, chosen, used, st = ops.parity_scan_pair(
                cfg, snap, static, order, st0, dom_s)
        else:
            assigned, chosen, used, st, evicted = (
                ops.parity_scan_pair_preempt(cfg, snap, static, order, st0,
                                             dom_s, pctx))
    elif pctx is None:
        assigned, chosen, used = ops.parity_scan(cfg, snap, static, order)
    else:
        assigned, chosen, used, evicted = ops.parity_scan_preempt(
            cfg, snap, static, order, pctx)
    used, assigned, chosen, _, _ = gang_rollback(
        snap, used, assigned, chosen, st, static.sig_match, dom_s, ops)
    return assigned, chosen, used, order, evicted


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
    pending rows (batched_cycle's return_relaxed)."""
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


def cycle(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor,
          mask: torch.Tensor, sscore: torch.Tensor, w_lr: torch.Tensor,
          w_ba: torch.Tensor, w_ts: torch.Tensor, rw: torch.Tensor,
          rows: torch.Tensor | None = None,
          pending: torch.Tensor | None = None, masked: bool = False,
          pair: tuple | None = None, w_ia: torch.Tensor | None = None,
          ia_ok: torch.Tensor | None = None):
    """Kernel K5 on CUDA tensors, the plain version on CPU tensors."""
    dev = mask.device
    if dev.type == "cpu":
        return cycle_plain(alloc, used, req, mask, sscore, w_lr, w_ba, w_ts,
                           rw, rows, pending, masked, pair, w_ia, ia_ok)
    P, N = mask.shape
    R = alloc.shape[1]
    k = "cycle"
    check(k, dev, alloc, torch.float32, (N, R))
    check(k, dev, used, torch.float32, (N, R))
    check(k, dev, req, torch.float32, (P, R))
    check(k, dev, sscore, torch.float32, (P, N))
    for w in (w_lr, w_ba, w_ts):
        check(k, dev, w, torch.float32, (P,))
    check(k, dev, rw, torch.float32, (R,))
    if R > 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes <= 8")
    n_rows = P if rows is None else rows.shape[0]
    if rows is not None:
        check(k, dev, rows, torch.int32, (n_rows,))
    if pending is not None:
        check(k, dev, pending, torch.bool, (n_rows,))
    pair_ptrs = (None,) * 4
    if pair is not None:
        check(k, dev, pair[0], torch.bool, (P, N))
        check(k, dev, pair[1], torch.float32, (P, N))
        check(k, dev, pair[2], torch.float32, (P, N))
        check(k, dev, w_ia, torch.float32, (P,))
        pair_ptrs = tuple(t.data_ptr() for t in (*pair, w_ia))
    relaxed = None
    if ia_ok is not None:
        check(k, dev, ia_ok, torch.bool, (P, N))
        relaxed = torch.empty((n_rows, N), dtype=torch.bool, device=dev)
    feasible = torch.empty((n_rows, N), dtype=torch.bool, device=dev)
    score = torch.empty((n_rows, N), dtype=torch.float32, device=dev)
    out = (feasible, score) if relaxed is None else (feasible, score,
                                                     relaxed)
    if n_rows * N == 0:
        return out
    _build.launch(
        "tpusched_cycle", n_rows, N, R,
        rows.data_ptr() if rows is not None else None,
        pending.data_ptr() if pending is not None else None,
        *(t.data_ptr() for t in (mask, sscore, alloc, used, req, w_lr, w_ba,
                                 w_ts, rw)),
        *pair_ptrs, int(masked), feasible.data_ptr(), score.data_ptr(),
        *ptrs((ia_ok, relaxed)), stream_of(dev))
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
    (tie_hash(seed, id) % #maxima)-th maximum in node order."""
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
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


def row_topk(masked: torch.Tensor, K: int, seeded: bool = False,
             seed: int = 0, row_ids: torch.Tensor | None = None):
    """Kernel K6 on CUDA tensors, the plain version on CPU tensors."""
    dev = masked.device
    if dev.type == "cpu":
        return row_topk_plain(masked, K, seeded, seed, row_ids)
    rows, N = masked.shape
    k = "row_topk"
    check(k, dev, masked, torch.float32, (rows, N))
    if not 1 <= K <= N:
        raise ValueError(f"{k}: K={K} outside 1..{N}")
    if row_ids is not None:
        check(k, dev, row_ids, torch.int32, (rows,))
    topv = torch.empty((rows, K), dtype=torch.float32, device=dev)
    topi = torch.empty((rows, K), dtype=torch.int32, device=dev)
    pick = (torch.empty((rows,), dtype=torch.int32, device=dev) if seeded
            else None)
    if rows == 0:
        return topv, topi, pick
    _build.launch(
        "tpusched_row_topk", rows, N, K, masked.data_ptr(), int(seeded),
        seed & 0xFFFFFFFF,
        row_ids.data_ptr() if row_ids is not None else None,
        topv.data_ptr(), topi.data_ptr(),
        pick.data_ptr() if pick is not None else None, stream_of(dev))
    row_topk.launches += 1
    if K > 16:
        row_topk.wide_launches += 1
    return topv, topi, pick


row_topk.launches = 0
row_topk.wide_launches = 0   # of them, with K > 16 (the auction's 256)


# -- K7: node desirability --------------------------------------------------


def desirability_plain(feasible: torch.Tensor, masked: torch.Tensor,
                       allowed: torch.Tensor,
                       fixed: bool = False) -> torch.Tensor:
    """[N]: the column mean over allowed rows of where(feasible, masked,
    0), -inf where no allowed row is feasible. The column sum adds the
    rows one at a time in ascending order, as the kernel does. fixed
    (the signature path): the sum is of int32 round(x * 16) clipped to
    +-32767, over 16 * #allowed, the same at any row order or view
    width."""
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
    rows, N = masked.shape
    k = "desirability"
    check(k, dev, feasible, torch.bool, (rows, N))
    check(k, dev, masked, torch.float32, (rows, N))
    check(k, dev, allowed, torch.bool, (rows,))
    desir = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return desir
    # The fixed-point path's int32 partial sums (zeroed; unused in f32).
    work = torch.zeros((2 * N + 1,) if fixed else (1,), dtype=torch.int32,
                       device=dev)
    _build.launch("tpusched_desirability", rows, N, feasible.data_ptr(),
                  masked.data_ptr(), allowed.data_ptr(), int(fixed),
                  work.data_ptr(), desir.data_ptr(), stream_of(dev))
    desirability.launches += 1
    if fixed:
        desirability.fixed_launches += 1
    return desir


desirability.launches = 0
desirability.fixed_launches = 0   # of them, in fixed point


# -- K8: one capacity-prefix commit sub-step --------------------------------


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
    row of its run of equal keys."""
    P = keys_s.shape[0]
    idx = torch.arange(P, device=keys_s.device)
    boundary = torch.ones(P, dtype=torch.bool, device=keys_s.device)
    boundary[1:] = keys_s[1:] != keys_s[:-1]
    return torch.cummax(torch.where(boundary, idx, 0), dim=0).values


def _segment_count(flag_s: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """[P] int32: the inclusive count of flag_s within each row's run
    (seg from _segment_start); integer sums, exact in any order."""
    cum = torch.cumsum(flag_s.to(torch.int32), dim=0)
    return cum - torch.where(seg > 0, cum[(seg - 1).clamp(min=0)], 0)


def prefix_commit_plain(perm: torch.Tensor, cand_s: torch.Tensor,
                        requests: torch.Tensor, alloc: torch.Tensor,
                        used: torch.Tensor, choice: torch.Tensor,
                        ptr: torch.Tensor, KC: int):
    """One `_deal_commit` sub-step over the (node, rank)-sorted
    candidates (perm: sorted row -> pod row; cand_s: sorted nodes, N for
    inactive rows). Returns the new (used, choice, ptr). `used` gains
    each node's commits one at a time in ascending rank."""
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


def prefix_commit(perm: torch.Tensor, cand_s: torch.Tensor,
                  requests: torch.Tensor, alloc: torch.Tensor,
                  used: torch.Tensor, choice: torch.Tensor,
                  ptr: torch.Tensor, KC: int):
    """Kernel K8 on CUDA tensors, the plain version on CPU tensors."""
    dev = perm.device
    if dev.type == "cpu":
        return prefix_commit_plain(perm, cand_s, requests, alloc, used,
                                   choice, ptr, KC)
    P = perm.shape[0]
    N, R = alloc.shape
    k = "prefix_commit"
    check(k, dev, perm, torch.int32, (P,))
    check(k, dev, cand_s, torch.int32, (P,))
    check(k, dev, requests, torch.float32, (P, R))
    check(k, dev, alloc, torch.float32, (N, R))
    check(k, dev, used, torch.float32, (N, R))
    check(k, dev, choice, torch.int32, (P,))
    check(k, dev, ptr, torch.int32, (P,))
    used, choice, ptr = used.clone(), choice.clone(), ptr.clone()
    if P == 0:
        return used, choice, ptr
    buf_f = torch.empty((2 * P,), dtype=torch.float32, device=dev)
    buf_i = torch.empty((2 * P,), dtype=torch.int32, device=dev)
    fit = torch.empty((P,), dtype=torch.uint8, device=dev)
    _build.launch(
        "tpusched_prefix_commit", P, N, R, KC,
        *(t.data_ptr() for t in (perm, cand_s, requests, alloc, used, choice,
                                 ptr, buf_f, buf_i, fit)),
        stream_of(dev))
    prefix_commit.launches += 1
    return used, choice, ptr


prefix_commit.launches = 0


def _by_node_rank(node: torch.Tensor, mask: torch.Tensor, rank: torch.Tensor,
                  N: int):
    """The masked rows sorted by (node, rank), masked-out rows last with
    node N (a library sort on one int64 key, as the sub-steps sort):
    (perm [P] int32 sorted row -> pod row, sorted nodes [P] int32)."""
    node_m = torch.where(mask, node.clamp(0, N - 1),
                         torch.full((), N, dtype=node.dtype,
                                    device=node.device))
    perm = torch.sort((node_m.long() << 32) + rank.long(), stable=True).indices
    return perm.to(torch.int32), node_m[perm].to(torch.int32).contiguous()


def node_add_plain(used: torch.Tensor, node: torch.Tensor,
                   mask: torch.Tensor, requests: torch.Tensor,
                   rank: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """JAX `_node_add`: used[node[p]] += sign * requests[p] for the masked
    rows, per node one row at a time in ascending rank (the sub-steps'
    order; JAX adds each node's segment total, a different association).
    The order depends on ranks alone, so a compacted view adds what the
    full width adds."""
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


def node_add(used: torch.Tensor, node: torch.Tensor, mask: torch.Tensor,
             requests: torch.Tensor, rank: torch.Tensor,
             sign: float = 1.0) -> torch.Tensor:
    """K8's node_add entry point on CUDA tensors (the adds, after the
    library sort), the plain version on CPU tensors."""
    dev = used.device
    if dev.type == "cpu":
        return node_add_plain(used, node, mask, requests, rank, sign)
    P = node.shape[0]
    N, R = used.shape
    k = "node_add"
    if sign not in (1.0, -1.0):
        raise ValueError(f"{k}: sign {sign}, want +1 or -1")
    check(k, dev, requests, torch.float32, (P, R))
    check(k, dev, used, torch.float32, (N, R))
    used = used.clone()
    if P == 0:
        return used
    perm, node_s = _by_node_rank(node, mask, rank, N)
    _build.launch("tpusched_node_add", P, N, R,
                  *ptrs((perm, node_s, requests)), int(sign),
                  used.data_ptr(), stream_of(dev))
    node_add.launches += 1
    return used


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
    targets."""
    ops = ops or KERNELS
    nodes, pods = snap.nodes, snap.pods
    pair = ia_ok = None
    if snap.sigs.key.shape[0] > 0:
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
    if snap.sigs.key.shape[0] > 0:
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
    round loops read (`host_reads`: one per round, per commit sub-step,
    per tranche, per validation pass and per full-width/compacted
    hand-off), and, with `timing` (CUDA only), CUDA-event spans by stage
    name, read back by `ms()`."""

    def __init__(self, timing: bool = False):
        self.host_reads = 0
        # Of them, the preemption rounds' (fast mode with preemption),
        # and those rounds' count.
        self.preempt_reads = 0
        self.preempt_rounds = 0
        self._spans: dict[str, list] | None = {} if timing else None

    def read(self, flag: torch.Tensor) -> bool:
        self.host_reads += 1
        return bool(flag)

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


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Indices of x by descending value, ties in index order (JAX's
    stable argsort of -x). Adding 0.0 turns -0.0 into +0.0 first: JAX's
    sort compares the two zeros equal, CUDA's radix sort of floats would
    put -0.0 first."""
    return torch.sort(-x + 0.0, stable=True).indices


def _deal_commit(alloc, requests, used, feasible, masked, allowed, rank,
                 topv, topi, tie_pick=None, rank_is_sorted: bool = False,
                 ops: "Ops | None" = None,
                 stats: RoundStats | None = None, override=None,
                 score_full=None, cum_width: int | None = None):
    """One round's dealing + capacity-prefix conflict resolution +
    rescue (JAX `_deal_commit`), over any pod-axis width. topv/topi:
    each row's top-K of `masked` (K6, ties to the lower index). Returns
    (used2, choice, chosen_val); choice[p] = committed node or -1.

    Dealing: the q-th allowed pod by rank targets the node where the
    cumulative remaining capacity (nodes by descending desirability, K7)
    first covers the cumulative demand of pods 0..q, for every resource.
    The dealt node (when feasible) leads each pod's candidate list, then
    its own top-K; K + 1 capacity sub-steps (K8) commit, per node, the
    longest rank-ordered prefix that fits. If nothing committed while an
    allowed pod is still feasible somewhere, the best-ranked such pod is
    committed at its own top choice (the rescue), so every round places
    a pod until nothing pending is placeable.

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
    go in rank order."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    P = requests.shape[0]
    N = alloc.shape[0]
    dev = requests.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    with stats.span("K7 desirability"):
        if cum_width is None:
            desir = ops.desirability(feasible, masked, allowed)
        else:
            desir = ops.desirability(feasible, masked, allowed, fixed=True)
    node_order = _desc_order(desir)
    remaining = (alloc - used).clamp_min(0.0)
    remaining = torch.where(torch.isfinite(desir)[:, None], remaining, zero)
    # Inclusive cumulative demand of allowed pods in rank order.
    dem = torch.where(allowed[:, None], requests, zero)
    if rank_is_sorted and cum_width is None:
        my_dem, cum_rem = _deal_prefixes(dem, remaining[node_order])
    else:
        rm = dem.new_zeros((P if cum_width is None else cum_width,
                            dem.shape[1]))
        rm[rank.long()] = dem
        my_dem, cum_rem = _deal_prefixes(rm, remaining[node_order])
        my_dem = my_dem[rank.long()]
    pos = torch.zeros(P, dtype=torch.int64, device=dev)
    for r in range(cum_rem.shape[1]):
        pos = torch.maximum(pos, torch.searchsorted(
            cum_rem[:, r].contiguous(), my_dem[:, r].contiguous()))
    dealt = node_order[pos.clamp(0, N - 1)]
    dealt_ok = feasible.gather(1, dealt[:, None])[:, 0]
    first_best = topi[:, 0]      # lowest-index maximum (jnp.argmax)
    if tie_pick is not None:
        # The seeded pick leads the pod's own list (same max score).
        tp_val = masked.gather(1, tie_pick.long()[:, None])[:, 0]
        topi = torch.cat([tie_pick[:, None], topi[:, 1:]], dim=1)
        topv = torch.cat([tp_val[:, None], topv[:, 1:]], dim=1)
    dealt_score = masked.gather(1, dealt[:, None])[:, 0]
    use_dealt = dealt_ok
    if tie_pick is not None:
        # A dealt node that merely ties the pod's max yields to the hash
        # pick; a strictly lower-scored one keeps its slot.
        use_dealt = dealt_ok & (dealt_score < topv[:, 0])
    topi = torch.cat([torch.where(use_dealt, dealt.to(torch.int32),
                                  topi[:, 0])[:, None], topi], dim=1)
    topv = torch.cat([torch.where(use_dealt, dealt_score,
                                  topv[:, 0])[:, None], topv], dim=1)
    if override is not None:
        cand, val, ok = override
        topi = torch.where(ok[:, None], cand, topi)
        topv = torch.where(ok[:, None], val, topv)
    KC = topi.shape[1]  # dealt candidate + K fallbacks

    used_j = used
    choice = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ptr = torch.zeros(P, dtype=torch.int32, device=dev)
    rank64 = rank.long()
    while True:
        with stats.span("sub-steps"):
            ptr_c = ptr.clamp(0, KC - 1).long()[:, None]
            cand = topi.gather(1, ptr_c)[:, 0]
            cand_ok = topv.gather(1, ptr_c)[:, 0] > NEG_INF
            active = allowed & (choice < 0) & (ptr < KC) & cand_ok
            if not stats.read(active.any()):
                break
            # Sort by (candidate node, rank); inactive rows go last.
            cand_m = torch.where(active, cand, N)
            perm = torch.sort((cand_m.long() << 32) + rank64,
                              stable=True).indices
            with stats.span("K8 prefix_commit"):
                used_j, choice, ptr = ops.prefix_commit(
                    perm.to(torch.int32), cand_m[perm].contiguous(),
                    requests, alloc, used_j, choice, ptr, KC)

    # Rescue: the best-ranked allowed pod that is still feasible
    # somewhere. Without signatures `allowed` is any(feasible, 1), the
    # JAX code's `allowed & want`; with them it also holds water-fill
    # members that only the relaxed rows admit.
    commit = choice >= 0
    want = allowed if cum_width is None else allowed & feasible.any(dim=1)
    can_rescue = ~commit.any() & want.any()
    BIG = torch.iinfo(torch.int32).max
    p_star = torch.argmin(torch.where(want, rank, torch.full_like(rank, BIG)))
    n_star = (tie_pick if tie_pick is not None else first_best)[p_star].long()
    used_j = used_j.clone()
    used_j[n_star] = used_j[n_star] + torch.where(can_rescue,
                                                  requests[p_star], zero)
    choice[p_star] = torch.where(can_rescue, n_star.to(torch.int32),
                                 choice[p_star])
    chosen_val = (masked if score_full is None else score_full).gather(
        1, choice.clamp(0, N - 1).long()[:, None])[:, 0]
    return used_j, choice, chosen_val


@dataclasses.dataclass
class _View:
    """The pod rows one commit loop runs over: all P pods (rows None) or
    a tranche (rows = the pod indices, ascending by rank)."""

    rows: torch.Tensor | None
    req: torch.Tensor          # [V, R] the rows' requests
    valid: torch.Tensor        # [V] bool
    rank: torch.Tensor         # [V] int32 global rank
    pod_ids: torch.Tensor      # [V] int32 original pod index
    rank_is_sorted: bool


def _round_nosig(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
                 view: _View, K: int, st, r: int, ops: "Ops",
                 stats: RoundStats):
    """One commit round over a view (`_make_round_nosig`'s body):
    returns the new (used, assigned, chosen, round_of) and the device
    flag `any commit and not all done`."""
    used, asg, chosen, rnd = st
    nodes = snap.nodes
    pending = (asg == -1) & view.valid
    with stats.span("K5 cycle"):
        feasible, masked = ops.cycle(
            nodes.allocatable, used, snap.pods.requests, static.mask,
            static.score, static.w_lr, static.w_ba, static.w_ts, static.rw,
            rows=view.rows, pending=pending, masked=True)
    with stats.span("K6 row_topk"):
        topv, topi, pick = ops.row_topk(masked, K, cfg.tie_break == "seeded",
                                        cfg.tie_seed, view.pod_ids)
    allowed = topv[:, 0] > NEG_INF     # any(feasible, 1): scores are finite
    used2, choice, chosen_val = _deal_commit(
        nodes.allocatable, view.req, used, feasible, masked, allowed,
        view.rank, topv, topi, tie_pick=pick,
        rank_is_sorted=view.rank_is_sorted, ops=ops, stats=stats)
    commit = choice >= 0
    asg2 = torch.where(commit, choice, asg)
    chosen2 = torch.where(commit, chosen_val, chosen)
    rnd2 = torch.where(commit, r, rnd)
    all_done = ((asg2 >= 0) | ~view.valid).all()
    return (used2, asg2, chosen2, rnd2), commit.any() & ~all_done


def _run_rounds(cfg, snap, static, view, K, st, r: int, limit: int,
                ops: "Ops", stats: RoundStats, progress=None):
    """Rounds while the last one made progress and r < limit (the JAX
    while_loop; progress None stands for the initial True). Returns
    (state, r)."""
    while r < limit and (progress is None or stats.read(progress)):
        st, progress = _round_nosig(cfg, snap, static, view, K, st, r, ops,
                                    stats)
        r += 1
    return st, r


def _solve_rounds_nosig(cfg: EngineConfig, snap: ClusterSnapshot,
                        static: StaticCtx, rank: torch.Tensor,
                        order: torch.Tensor, max_rounds: int, K: int,
                        cap: int | None = None, ops: "Ops | None" = None,
                        stats: RoundStats | None = None):
    """Fast-mode rounds with NO pairwise signatures. Returns (used,
    assigned, chosen, round_of, rounds).

    P <= 2C (or <= cap): full-width rounds to fixpoint. Larger: one
    full-width round 1, then tranches: the C best-ranked still-unspent
    pending pods run [C, N] views for up to tranche_cap rounds; a view
    pod left unplaced with no feasible node against the tranche-final
    state is spent (capacity only shrinks here, so for good). cap:
    explicit tranche width C."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    dev = pods.valid.device
    C = _RESIDUAL_CAP if cap is None else max(1, min(cap, P))
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    full = _View(None, pods.requests, pods.valid, rank, ids, False)
    st = (nodes.used, torch.full((P,), -1, dtype=torch.int32, device=dev),
          torch.full((P,), NEG_INF, dtype=torch.float32, device=dev),
          torch.full((P,), -1, dtype=torch.int32, device=dev))
    if P <= (2 * C if cap is None else C):
        with stats.span("direct rounds"):
            (used, asg, chosen, rnd), r = _run_rounds(
                cfg, snap, static, full, K, st, 0, max_rounds, ops, stats)
        return used, asg, chosen, rnd, r

    with stats.span("round 1"):
        st, progress = _round_nosig(cfg, snap, static, full, K, st, 0, ops,
                                    stats)
    r = 1
    tranche_cap = min(4, max_rounds) if cfg.max_rounds > 0 else 4
    used, assigned, chosen, round_of = st
    spent = torch.zeros(P, dtype=torch.bool, device=dev)
    t = 0
    with stats.span("tranches"):
        while t < P:
            pend = (assigned == -1) & pods.valid & ~spent
            if not stats.read(progress & pend.any()):
                break
            sel, _ = _top_by_rank(pend, order, C)
            sel64 = sel.long()
            real = pend[sel64]
            view = _View(sel.to(torch.int32), pods.requests[sel64], real,
                         rank[sel64], sel.to(torch.int32), True)
            st_c = (used, torch.full((C,), -1, dtype=torch.int32, device=dev),
                    torch.full((C,), NEG_INF, dtype=torch.float32,
                               device=dev),
                    torch.full((C,), -1, dtype=torch.int32, device=dev))
            (used, asg_c, chosen_c, rnd_c), r = _run_rounds(
                cfg, snap, static, view, K, st_c, r,
                min(2**30, r + tranche_cap), ops, stats)
            hit = asg_c >= 0
            assigned[sel64] = torch.where(hit, asg_c, assigned[sel64])
            chosen[sel64] = torch.where(hit, chosen_c, chosen[sel64])
            round_of[sel64] = torch.where(hit, rnd_c, round_of[sel64])
            # Spent: unplaced with no feasible node left (permanent).
            with stats.span("K5 cycle"):
                feas_left, _ = ops.cycle(
                    nodes.allocatable, used, pods.requests, static.mask,
                    static.score, static.w_lr, static.w_ba, static.w_ts,
                    static.rw, rows=view.rows, masked=True)
            no_node = ~feas_left.any(dim=1)
            spent[sel64] = spent[sel64] | (real & ~hit & no_node)
            t += 1
            progress = real.any()
    return used, assigned, chosen, round_of, r


# -- fast mode with signatures: water-fill, validation, frontier ----------


def _waterfill_tables(snap: ClusterSnapshot, pair_st: "kpair.PairState",
                      dom_s: torch.Tensor, allowed: torch.Tensor,
                      rank: torch.Tensor):
    """The water-fill dealer's tables over [P] and [S, N] (JAX
    `_spread_waterfill_deal` up to its fill table), plain torch:
    (s_p [P] int32 each pod's first DoNotSchedule slot's signature, q
    [P] f32 its 0-based rank position among this round's members of
    s_p, member [P] bool, fill [S, N] f32, ord_dom [S, N] int32)."""
    pods = snap.pods
    S, N = dom_s.shape
    P = rank.shape[0]
    dev = dom_s.device
    dns = pods.ts_valid & (pods.ts_when == DO_NOT_SCHEDULE)
    first_c = torch.argmax(dns.to(torch.int32), dim=1)      # first DNS slot
    s_p = pods.ts_sig.gather(1, first_c[:, None])[:, 0].clamp(min=0)
    member = allowed & dns.any(dim=1)
    gid = torch.where(member, s_p, S)
    perm = torch.sort((gid.long() << 32) + rank.long()).indices
    q = torch.zeros(P, dtype=torch.float32, device=dev)
    q[perm] = (_segment_count(member[perm], _segment_start(gid[perm]))
               - 1).to(torch.float32)
    # Per-signature fill levels over the domain counts, domains by
    # ascending count; 1e9 stands in for a domain no node has.
    exist = torch.zeros((S, N), dtype=torch.bool, device=dev)
    rows = torch.arange(S, device=dev)[:, None].expand(S, N)
    keyed = dom_s >= 0
    exist[rows[keyed], dom_s[keyed].long()] = True
    cnt = torch.where(exist, pair_st.counts,
                      torch.full((), 1e9, dtype=torch.float32, device=dev))
    ord_dom = torch.sort(cnt, dim=1, stable=True).indices
    csort = torch.gather(cnt, 1, ord_dom)
    # The exclusive prefix of csort, summed exactly in f64 (integers
    # below 2**53) and rounded once: its entries over real domains are
    # the exact small integers JAX's f32 cumsum gives too, and the ones
    # past a sentinel stay near 1e9, far above any q, so the count of
    # fill <= q does not depend on how a device would round an f32 sum.
    pre = torch.cumsum(csort.to(torch.float64), dim=1)
    presum = torch.cat([torch.zeros((S, 1), dtype=torch.float64, device=dev),
                        pre[:, :-1]], dim=1).to(torch.float32)
    js = torch.arange(N, dtype=torch.float32, device=dev)[None, :]
    fill = js * csort - presum
    return (s_p.to(torch.int32), q, member, fill.contiguous(),
            ord_dom.to(torch.int32).contiguous())


def _cap_order(alloc: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """[N] int32 nodes by descending mean free fraction of allocatable
    (the water-fill rotation order). The mean adds the R axes in order
    and divides by a device tensor (CUDA divides by a Python scalar as a
    multiply by its reciprocal)."""
    one = torch.full((), 1e-9, dtype=torch.float32, device=alloc.device)
    frac = torch.where(alloc > 0, (alloc - used) / torch.maximum(alloc, one),
                       torch.zeros((), dtype=torch.float32,
                                   device=alloc.device))
    total = frac[:, 0]
    for r in range(1, frac.shape[1]):
        total = total + frac[:, r]
    free = total / torch.full((), float(frac.shape[1]), dtype=torch.float32,
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
    Returns (cand [P, K1] int32, val [P, K1] f32, ok [P] bool)."""
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
    P, N = relaxed.shape
    S = fill.shape[0]
    k = "waterfill"
    if not 1 <= K1 <= 32:
        raise ValueError(f"{k}: {K1} candidates a pod, the kernel takes "
                         "1..32")
    check(k, dev, fill, torch.float32, (S, N))
    check(k, dev, ord_dom, torch.int32, (S, N))
    check(k, dev, dom_s, torch.int32, (S, N))
    check(k, dev, s_p, torch.int32, (P,))
    check(k, dev, q, torch.float32, (P,))
    check(k, dev, cap_order, torch.int32, (N,))
    check(k, dev, score, torch.float32, (P, N))
    check(k, dev, member, torch.bool, (P,))
    cand = torch.empty((P, K1), dtype=torch.int32, device=dev)
    val = torch.empty((P, K1), dtype=torch.float32, device=dev)
    ok = torch.empty((P,), dtype=torch.bool, device=dev)
    if P * N == 0:
        return cand, val, ok
    _build.launch("tpusched_waterfill", P, N, K1,
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
    ok False leaves the pod to the capacity dealer."""
    pods = snap.pods
    S = dom_s.shape[0]
    P = rank.shape[0]
    if pods.ts_valid.shape[1] == 0 or S == 0:
        dev = rank.device
        return (torch.zeros((P, K + 1), dtype=torch.int32, device=dev),
                torch.full((P, K + 1), NEG_INF, dtype=torch.float32,
                           device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev))
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
    where there is none."""
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
    P, N = aff_ok.shape
    S = dom_s.shape[0]
    k = "excess_min"
    check(k, dev, dom_s, torch.int32, (S, N))
    check(k, dev, counts, torch.float32, (S, N))
    check(k, dev, node_valid, torch.bool, (N,))
    check(k, dev, aff_ok, torch.bool, (P, N))
    check(k, dev, s_c, torch.int32, (P,))
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P * N == 0:
        return out.fill_(0.0)
    _build.launch("tpusched_excess_min", P, N,
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
    b_fixed + q <= that min."""
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
    P = perm.shape[0]
    k = "excess_survive"
    check(k, dev, gid_s, torch.int32, (P,))
    check(k, dev, perm, torch.int32, (P,))
    check(k, dev, member, torch.bool, (P,))
    check(k, dev, T, torch.float32, (P,))
    check(k, dev, b_fixed, torch.float32, (P,))
    bad = torch.empty((P,), dtype=torch.bool, device=dev)
    if P == 0:
        return bad
    _build.launch("tpusched_excess_survive", P,
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
    full width's."""
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    S, N = dom_s.shape
    dev = dom_s.device
    dns = pods.ts_valid & (pods.ts_when == DO_NOT_SCHEDULE)
    ch = choice.clamp(0, N - 1).long()
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    for c in range(pods.ts_key.shape[1]):
        s_c = pods.ts_sig[:, c].clamp(min=0)
        d_c = dom_s[s_c.long(), ch]
        member = kept & dns[:, c] & (choice >= 0) & (d_c >= 0)
        min_end = ops.excess_min(dom_s, st.counts, nodes.valid, aff_ok,
                                 s_c.contiguous())
        T = min_end + pods.ts_max_skew[:, c]
        d0 = d_c.clamp(min=0)
        cnt_total = st.counts[s_c.long(), d0.long()]
        gid = torch.where(member, s_c * N + d0, S * N)
        g_tab = torch.zeros(S * N + 1, dtype=torch.float32, device=dev)
        g_tab.index_add_(0, gid.long(), member.to(torch.float32))
        b_fixed = cnt_total - g_tab[gid.long()]  # members' non-revertable rest
        perm = torch.sort((gid.long() << 32) + rank.long()).indices
        bad = bad | ops.excess_survive(gid[perm].to(torch.int32).contiguous(),
                                       perm.to(torch.int32), member,
                                       T.contiguous(), b_fixed)
    return bad


def _sig_involvement(snap: ClusterSnapshot, static: StaticCtx,
                     st0: "kpair.PairState"):
    """(invol [P, S] bool, has_pair [P] bool), plain torch (JAX
    `_sig_involvement`). has_pair: pods whose pairwise validation can
    fail, i.e. with spread or inter-pod terms of their own, or matched
    by a live required anti term (of a running holder in a keyed domain,
    or of any pending holder). invol: the signatures a pod's checks read
    or its commit writes; pods with disjoint involvement cannot affect
    each other's validation."""
    pods = snap.pods
    P = pods.valid.shape[0]
    M = snap.running.valid.shape[0]
    S = static.sig_match.shape[0]
    dev = pods.valid.device
    has_pair = pods.ts_valid.any(dim=1) | pods.ia_valid.any(dim=1)
    anti_possible = st0.anti.sum(dim=1) > 0
    holds = kpair.pod_anti_holds(pods) & pods.valid[:, None]
    for t in range(pods.ia_key.shape[1]):
        s_t = pods.ia_sig[:, t].clamp(min=0).long()
        hit = torch.zeros(S, dtype=torch.int32, device=dev)
        hit.index_add_(0, s_t, holds[:, t].to(torch.int32))
        anti_possible = anti_possible | (hit > 0)
    members = static.sig_match[:, M:]                        # [S, P]
    has_pair = has_pair | (members & anti_possible[:, None]).any(dim=0)
    invol = (members.T & pods.valid[:, None]).contiguous()
    ar = torch.arange(P, device=dev)
    for sig, valid in ((pods.ts_sig, pods.ts_valid),
                       (pods.ia_sig, pods.ia_valid)):
        for c in range(sig.shape[1]):
            s_c = sig[:, c].clamp(min=0).long()
            invol[ar, s_c] = invol[ar, s_c] | valid[:, c]
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


def _pods_view(snap: ClusterSnapshot, static: StaticCtx, sel: torch.Tensor):
    """The compacted pod-axis view (gathers): the selected pods' rows of
    every pod array and of StaticCtx, and sig_match's running columns
    then the selected pods' member columns. Nodes, running pods,
    signatures and all [S, N] / [N, R] state stay full width."""
    M = snap.running.valid.shape[0]
    pods = snap.pods
    pods_v = dataclasses.replace(pods, **{
        f.name: getattr(pods, f.name)[sel] for f in dataclasses.fields(pods)})
    sig_v = torch.cat([static.sig_match[:, :M],
                       static.sig_match[:, M + sel]], dim=1)
    static_v = StaticCtx(
        mask=static.mask[sel], aff_ok=static.aff_ok[sel],
        score=static.score[sel], sig_match=sig_v, w_lr=static.w_lr[sel],
        w_ba=static.w_ba[sel], w_ts=static.w_ts[sel], w_ia=static.w_ia[sel],
        rw=static.rw)
    return dataclasses.replace(snap, pods=pods_v), static_v


def _min_rank_first(mask: torch.Tensor, rank: torch.Tensor,
                    invol: torch.Tensor) -> torch.Tensor:
    """[P] bool: rank[p] is the least rank among the `mask` pods in every
    signature p is involved in."""
    BIG = torch.iinfo(torch.int32).max
    r = torch.where(mask, rank, BIG)
    lo = torch.where(invol, r[:, None], BIG).amin(dim=0)     # [S]
    return torch.where(invol, rank[:, None] == lo[None, :], True).all(dim=1)


def _round_sig(cfg: EngineConfig, snap_v: ClusterSnapshot,
               static_v: StaticCtx, invol_v, hp_v, rank_v, pod_ids,
               pending_v, cons_v, used, pair_st, K: int, width: int,
               dom_s: torch.Tensor, ops: "Ops", stats: RoundStats):
    """One commit round over a (possibly compacted) pod-axis view (JAX
    `_solve_rounds_sig`'s round_math): score (K11, K5), gate the
    conservative pods, water-fill (K12) and deal (K6, K7, K8), add the
    commits to the pair state (K10), then validate against the
    end-of-round state until a pass reverts nothing (K14, K13, the
    reverts through K8's node_add and K10). Returns (used, state, kept,
    choice, chosen_val, fb_mask)."""
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
    want = feasible.any(dim=1)
    # Conservative pods commit only when first among the wanting pods in
    # every signature they touch.
    gate = ~cons_v | _min_rank_first(want & cons_v, rank_v, invol_v)
    allowed = want & gate
    with stats.span("K12 waterfill"):
        sp = _spread_waterfill_deal(snap_v, pair_st, used, relaxed, score,
                                    relaxed.any(dim=1) & gate, rank_v, K,
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
    flag = (commit & hp_v).any()
    while stats.read(flag):
        with stats.span("validation passes"):
            with stats.span("K14 ia_at_choice"):
                ia_ok_at = ops.ia_ok_at_choice(
                    snap_v, st_v, sig_v, dom_s, choice,
                    torch.where(kept, choice, -1))
            ia_bad_all = kept & hp_v & ~ia_ok_at
            protected = ia_bad_all & _min_rank_first(ia_bad_all, rank_v,
                                                     invol_v)
            ia_bad = ia_bad_all & ~protected
            with stats.span("K13 spread_excess"):
                sp_bad = _spread_excess_mask(
                    snap_v, static_v.aff_ok, rank_v, choice, kept, st_v,
                    dom_s, ops) & ~ia_bad_all
            stuck = ~(ia_bad | sp_bad).any() & ia_bad_all.any()
            new_viol = ia_bad | sp_bad | (ia_bad_all & stuck)
            used_v = ops.node_add(used_v, choice, new_viol, req_v, rank_v,
                                  -1.0)
            st_v = ops.pair_commit(snap_v, st_v, sig_v, dom_s, choice,
                                   new_viol, -1.0)
            kept = kept & ~new_viol
            flag = new_viol.any()
    # Backstop: if every commit of the round reverted, the first reverted
    # pod by rank turns conservative, so the gated path makes progress.
    viol = commit & ~kept
    first = rank_v == torch.where(viol, rank_v, BIG).amin()
    fb_mask = viol & first & ~kept.any() & viol.any()
    return used_v, st_v, kept, choice, chosen_val, fb_mask


def _solve_rounds_sig(cfg: EngineConfig, snap: ClusterSnapshot,
                      static: StaticCtx, rank: torch.Tensor,
                      order: torch.Tensor, st0: "kpair.PairState",
                      invol: torch.Tensor, has_pair: torch.Tensor,
                      max_rounds: int, K: int, cap: int, ops: "Ops",
                      stats: RoundStats):
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
    prefix and rank-ordered adds, node_add). Returns (used, assigned,
    final pair state, chosen, round_of, rounds)."""
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    dev = pods.valid.device
    dom_s = kpair.sig_domains(snap)
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    used, st = nodes.used, st0
    assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    chosen = torch.full((P,), NEG_INF, dtype=torch.float32, device=dev)
    round_of = torch.full((P,), -1, dtype=torch.int32, device=dev)
    cons = torch.zeros(P, dtype=torch.bool, device=dev)
    progress = None      # the loops' initial True
    r = 0

    def step(snap_v, static_v, sel, pending_v):
        nonlocal used, st, assigned, chosen, round_of, cons, progress
        rows = slice(None) if sel is None else sel
        used, st, kept, choice, cval, fb = _round_sig(
            cfg, snap_v, static_v, invol[rows], has_pair[rows], rank[rows],
            ids[rows], pending_v, cons[rows], used, st, K, P, dom_s, ops,
            stats)
        new_cons = fb & ~cons[rows]
        upd = ((assigned, torch.where(kept, choice, assigned[rows])),
               (chosen, torch.where(kept, cval, chosen[rows])),
               (round_of, torch.where(kept, r, round_of[rows])),
               (cons, cons[rows] | fb))
        assigned, chosen, round_of, cons = (
            v if sel is None else full.index_put((sel,), v)
            for full, v in upd)
        all_done = ((assigned >= 0) | ~pods.valid).all()
        progress = (kept.any() | new_cons.any()) & ~all_done

    while r < max_rounds:
        flag = progress
        if cap:
            # Hand off to the compacted rounds once the whole pending
            # frontier fits one view (never before: the view must hold
            # every pending pod).
            over = ((assigned == -1) & pods.valid).sum() > cap
            flag = over if flag is None else flag & over
        if flag is not None and not stats.read(flag):
            break
        with stats.span("full-width rounds"):
            step(snap, static, None, assigned == -1)
        r += 1
    if cap:
        while r < max_rounds and (progress is None or stats.read(progress)):
            with stats.span("compacted rounds"):
                pend = (assigned == -1) & pods.valid
                sel = _top_by_rank(pend, order, cap)[0].long()
                step(*_pods_view(snap, static, sel), sel, pend[sel])
            r += 1
    return used, assigned, st, chosen, round_of, r


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
    Returns (used, assigned, chosen, pair_st, rolled)."""
    ops = ops or KERNELS
    pods = snap.pods
    P = assigned.shape[0]
    G = snap.group_min_member.shape[0]
    dev = assigned.device
    if G == 0:
        return (used, assigned, chosen, pair_st,
                torch.zeros(P, dtype=torch.bool, device=dev))
    g = pods.group
    placed = (assigned >= 0) & pods.valid & (g >= 0)
    gclip = g.clamp(min=0).long()
    cnt = torch.zeros(G, dtype=torch.int32, device=dev)
    cnt.index_add_(0, gclip, placed.to(torch.int32))
    roll = placed & (cnt < snap.group_min_member)[gclip]
    rank = torch.arange(P, dtype=torch.int32, device=dev)
    used = ops.node_add(used, assigned, roll, pods.requests, rank, -1.0)
    if pair_st is not None and snap.sigs.key.shape[0] > 0:
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


def _evict_round(evicted: torch.Tensor, vidx_t: torch.Tensor,
                 keep_evict: torch.Tensor) -> torch.Tensor:
    """evicted | the kept eviction bids' victim prefixes (vidx_t holds M
    at the slots that are not victims; a sentinel slot M takes those and
    the bids not kept, so no mask is read back to the host)."""
    M = evicted.shape[0]
    hit = torch.zeros(M + 1, dtype=torch.bool, device=evicted.device)
    hit[torch.where(keep_evict[:, None], vidx_t, M).long()] = True
    return evicted | hit[:M]


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
    static_v) or None at S = 0)."""
    nodes = snap.nodes
    s32 = sel.to(torch.int32)
    if snap.sigs.key.shape[0] == 0:
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
    n_plain = pick if pick is not None else topi[:, 0]
    sc = masked.gather(1, n_plain.long()[:, None])[:, 0]
    return feas, masked, n_plain, sc, pair_ok, view


def _preempt_rounds(cfg: EngineConfig, snap: ClusterSnapshot,
                    static: StaticCtx, rank: torch.Tensor,
                    order: torch.Tensor, base_rounds: int,
                    used: torch.Tensor, assigned: torch.Tensor,
                    st: "kpair.PairState | None", round_of: torch.Tensor,
                    chosen: torch.Tensor, has_pair: torch.Tensor,
                    dom_s: torch.Tensor | None, ops: "Ops",
                    stats: RoundStats):
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
    assigned, st, evicted, round_of, chosen, rounds)."""
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    N = nodes.valid.shape[0]
    M = snap.running.valid.shape[0]
    dev = pods.valid.device
    C = min(P, _PREEMPT_BATCH)
    S = snap.sigs.key.shape[0]
    GP = snap.pdb_allowed.shape[0]
    K = _fallback_depth(N)
    seeded = cfg.tie_break == "seeded"
    alloc = nodes.allocatable
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    with stats.span("preempt victim table"):
        pctx = kpre.precompute_nv(cfg, snap, _PREEMPT_VICTIM_CAP)
    prio = effective_priority(cfg, pods.base_priority, pods.slo_target,
                              pods.observed_avail)
    evicted = torch.zeros(M, dtype=torch.bool, device=dev)
    tried = torch.zeros(P, dtype=torch.bool, device=dev)
    compact_pv = S > 0 and _compact_cap(cfg, P) > 0
    r = 0
    progress = None
    while r < _PREEMPT_MAX_ROUNDS and (progress is None
                                       or stats.read(progress)):
        key = base_rounds + r
        drained = torch.zeros((), dtype=torch.bool, device=dev)
        if S == 0:
            with stats.span("preempt drain"):
                pend0 = (assigned < 0) & pods.valid
                dsel = _top_by_rank(pend0, order, min(_PREEMPT_DRAIN, P))[0]
                d64, d32 = dsel.long(), dsel.to(torch.int32)
                feas_d, masked_d = ops.cycle(
                    alloc, used, pods.requests, static.mask, static.score,
                    static.w_lr, static.w_ba, static.w_ts, static.rw,
                    rows=d32, pending=pend0[d64], masked=True)
                topv, topi, pick = ops.row_topk(masked_d, K, seeded,
                                                cfg.tie_seed, d32)
                used, choice_d, chosen_d = _deal_commit(
                    alloc, pods.requests[d64], used, feas_d, masked_d,
                    topv[:, 0] > NEG_INF, rank[d64], topv, topi,
                    tie_pick=pick, rank_is_sorted=True, ops=ops,
                    stats=stats)
                hit_d = choice_d >= 0
                assigned = assigned.index_put((d64,), torch.where(
                    hit_d, choice_d, assigned[d64]))
                chosen = chosen.index_put((d64,), torch.where(
                    hit_d, chosen_d, chosen[d64]))
                round_of = round_of.index_put((d64,), torch.where(
                    hit_d, key, round_of[d64]))
                drained = hit_d.any()
        pend = (assigned < 0) & pods.valid & ~tried
        sel = _top_by_rank(pend, order, C)[0]
        s64, s32 = sel.long(), sel.to(torch.int32)
        real = pend[s64]
        req_sel = pods.requests[s64]
        rank_sel = rank[s64]
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
        hp_sel = has_pair[s64]
        plain_excl = can_plain & hp_sel
        plain_cap = can_plain & ~hp_sel
        # Gang members never preempt.
        pre_active = real & ~can_plain & (pods.group[s64] < 0)
        with stats.span("preempt auction"):
            (target, claimed, takes_evict, vidx_t, freed_req, usage,
             could_bid) = kpre.preempt_auction(
                cfg, snap, pctx, prio[s64], req_sel, mask_rows, used,
                evicted, plain_excl, n_plain, rank=rank_sel, ops=ops,
                rows=rows, pair_ok=pair_ok, pre_active=pre_active)
        could_bid = could_bid | plain_cap
        with stats.span("preempt budget gate"):
            keep = claimed
            if GP:
                # The claims as a rank-ordered prefix (sel is in rank
                # order) while each touched budget's claimed-cumulative
                # use stays inside what it has left; a bid whose own use
                # overdraws (a declared violation) keeps regardless.
                rem = kpre.pdb_remaining(snap, evicted)[None, :] + 1e-6
                use_cl = torch.where(claimed[:, None], usage, 0)
                cum = torch.cumsum(use_cl, dim=0).to(torch.float32)
                use_f = usage.to(torch.float32)
                fits_budget = torch.where(usage > 0, cum <= rem,
                                          True).all(dim=1)
                alone = (use_f > rem).any(dim=1)
                keep = claimed & (fits_budget | alone)
            keep_evict = keep & takes_evict
            evicted2 = _evict_round(evicted, vidx_t, keep_evict)
        tgt_c = target.clamp(0, N - 1).long()
        with stats.span("preempt plain commit"):
            taken = torch.zeros(N + 1, dtype=torch.bool, device=dev)
            taken[torch.where(keep, tgt_c, N)] = True
            taken = taken[:N]
            feas_c = feas_pl & plain_cap[:, None] & ~taken[None, :]
            masked_c = torch.where(feas_c, masked_pl, neg)
            topv, topi, pick = ops.row_topk(masked_c, K, seeded,
                                            cfg.tie_seed, s32)
            _, choice_pl, chosen_pl = _deal_commit(
                alloc, req_sel, used, feas_c, masked_c,
                plain_cap & (topv[:, 0] > NEG_INF), rank_sel, topv, topi,
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
                # stay evicted.
                if compact_pv:
                    snap_pv, static_pv = snap_v, static_v
                    choice_pv = torch.where(keep_all, target_all, -1)
                    keep_pv, hp_pv, rank_pv = keep_all, hp_sel, rank_sel
                else:
                    snap_pv, static_pv = snap, static
                    choice_pv = torch.full(
                        (P,), -1, dtype=torch.int32, device=dev).index_put(
                        (s64,), torch.where(keep_all, target_all, -1))
                    keep_pv = torch.zeros(
                        P, dtype=torch.bool, device=dev).index_put(
                        (s64,), keep_all)
                    hp_pv, rank_pv = has_pair, rank
                sig_pv = static_pv.sig_match
                st = ops.pair_commit(snap_pv, st, sig_pv, dom_s, choice_pv,
                                     keep_pv, 1.0)
                kept = keep_pv
                flag = (keep_pv & hp_pv).any()
                while stats.read(flag):
                    ia_ok = ops.ia_ok_at_choice(
                        snap_pv, st, sig_pv, dom_s, choice_pv,
                        torch.where(kept, choice_pv, -1))
                    bad = kept & hp_pv & ~ia_ok
                    bad = bad | (kept & _spread_excess_mask(
                        snap_pv, static_pv.aff_ok, rank_pv, choice_pv, kept,
                        st, dom_s, ops))
                    st = ops.pair_commit(snap_pv, st, sig_pv, dom_s,
                                         choice_pv, bad, -1.0)
                    kept = kept & ~bad
                    flag = bad.any()
                valid = kept if compact_pv else kept[s64]
                keep = keep & valid
                keep_pl = keep_pl & valid
                keep_all = keep | keep_pl
        with stats.span("preempt used"):
            # One claimant a node: every row that does not keep adds an
            # exact 0.0, so the adds are exact in any order.
            used = used.index_add(0, tgt_c, torch.where(
                keep_evict[:, None], -freed_req, zero))
            used = used.index_add(0, tgt_c, torch.where(keep[:, None],
                                                        req_sel, zero))
            used = ops.node_add(used, choice_pl, keep_pl, req_sel, rank_sel)
        assigned = assigned.index_put((s64,), torch.where(
            keep_all, target_all, assigned[s64]))
        # Preempted placements carry no score (as in parity mode).
        chosen = chosen.index_put((s64,), torch.where(
            keep_pl, chosen_pl, torch.where(
                keep & can_plain, sc_plain,
                torch.where(keep, neg, chosen[s64]))))
        round_of = round_of.index_put((s64,), torch.where(
            keep_all, key, round_of[s64]))
        evicted = evicted2
        # A kept pod is placed, a pod with no placement and no prefix
        # anywhere is spent until the state changes, a deferred one bids
        # again; any keep or drain placement clears the spent marks.
        newly = real & (keep_all | ~could_bid)
        reset = keep_all.any() | drained
        tried = torch.where(reset, False,
                            tried.index_put((s64,), tried[s64] | newly))
        progress = reset | newly.any()
        r += 1
    return used, assigned, st, evicted, round_of, chosen, r


def solve_rounds(cfg: EngineConfig, snap: ClusterSnapshot,
                 node_sat_t: torch.Tensor | None,
                 member_sat_t: torch.Tensor | None = None,
                 static: StaticCtx | None = None, ops: "Ops | None" = None,
                 stats: RoundStats | None = None):
    """Fast mode: batched commit rounds. Returns (assigned, chosen, used,
    order, round_of, rounds, evicted); round_of is the commit key (pods
    of an earlier round committed strictly earlier; with signatures a
    round's kept commits were validated against its end-of-round
    state). member_sat_t: the [A, M+P] member label table, needed with
    signatures."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    if static is None:
        static = precompute_static(cfg, snap, node_sat_t, member_sat_t,
                                   ops=ops)
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    N = nodes.valid.shape[0]
    M = snap.running.valid.shape[0]
    dev = pods.valid.device
    order = pop_order(cfg, snap)
    rank = torch.zeros(P, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(P, dtype=torch.int32, device=dev)
    # Worst case one pod commits per round; cfg.max_rounds > 0 caps it.
    max_rounds = cfg.max_rounds if cfg.max_rounds > 0 else 2 * P + 8
    K = _fallback_depth(N)
    st = dom_s = None
    has_pair = torch.zeros(P, dtype=torch.bool, device=dev)
    if snap.sigs.key.shape[0] == 0:
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
    evicted = torch.zeros(M, dtype=torch.bool, device=dev)
    if cfg.preemption and M > 0:
        reads0 = stats.host_reads
        with stats.span("preemption rounds"):
            used, assigned, st, evicted, round_of, chosen, pre_r = (
                _preempt_rounds(cfg, snap, static, rank, order, rounds, used,
                                assigned, st, round_of, chosen, has_pair,
                                dom_s, ops, stats))
        stats.preempt_reads = stats.host_reads - reads0
        stats.preempt_rounds = pre_r
        rounds += pre_r
    used, assigned, chosen, _, rolled = gang_rollback(
        snap, used, assigned, chosen, st, static.sig_match, dom_s, ops)
    round_of = torch.where(rolled, -1, round_of)
    rounds = torch.full((), rounds, dtype=torch.int32, device=dev)
    return assigned, chosen, used, order, round_of, rounds, evicted


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
    prefix_commit: Callable
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


KERNELS = Ops(atom_sat, _tableau_cells, finalize_score, parity_scan, cycle,
              row_topk, desirability, prefix_commit, kpair.sig_match,
              kpair.pair_counts, kpair.pairwise_batch, parity_scan_pair,
              node_add, kpair.pair_commit, kpair.ia_ok_at_choice, waterfill,
              excess_min, excess_survive, parity_scan_preempt,
              parity_scan_pair_preempt, kpre.auction_ok, kpre.auction_tables,
              kpre.auction_rank, kpre.auction_claim)
PLAIN = Ops(atom_sat_plain, _tableau_cells_plain, finalize_score_plain,
            parity_scan_plain, cycle_plain, row_topk_plain,
            desirability_plain, prefix_commit_plain, kpair.sig_match_plain,
            kpair.pair_counts_plain, kpair.pairwise_batch_plain,
            parity_scan_pair_plain, node_add_plain, kpair.pair_commit_plain,
            kpair.ia_ok_at_choice_plain, waterfill_plain, excess_min_plain,
            excess_survive_plain, parity_scan_preempt_plain,
            parity_scan_pair_preempt_plain, kpre.auction_ok_plain,
            kpre.auction_tables_plain, kpre.auction_rank_plain,
            kpre.auction_claim_plain)
