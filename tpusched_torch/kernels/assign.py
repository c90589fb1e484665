"""The parity solve: the port of `tpusched/kernels/assign.py`'s parity
path, for snapshots without pairwise signatures, gangs or preemption.

The scheduling cycle splits, as in the JAX package, into
  * a STATIC part computed once per snapshot (StaticCtx): the cell-local
    tableau (kernel K2, `_tableau_cells`), then its row-coupled
    normalisation times the per-pod QoS weights (kernel K3, inside
    `finalize_static`);
  * a DYNAMIC part that depends on node `used`: resource fit,
    LeastRequested and BalancedAllocation, evaluated pod by pod in
    dynamic-priority order by the parity scan (kernel K4,
    `parity_scan`), which commits each pod before the next one scores.

Every kernel wrapper runs its plain version (`*_plain`) on CPU tensors.
ScoreBatch (`batched_cycle`, `score_batch`) and fast mode come in the
next slice (ROADMAP A2 rest, A4).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import check, stream_of
from tpusched_torch.kernels import filter as kfilter
from tpusched_torch.kernels import score as kscore
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
                    na_raw, tt_count) -> StaticCtx:
    """StaticCtx from the tableau: per-pod QoS plugin weights (plain
    torch over [P]) and the row-normalised static score (K3)."""
    pods = snap.pods
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    score = finalize_score(na_raw, tt_count, snap.nodes.valid,
                           w["node_affinity"], w["taint_toleration"])
    return StaticCtx(
        mask=mask, aff_ok=aff_ok, score=score,
        w_lr=w["least_requested"], w_ba=w["balanced_allocation"],
        w_ts=w["topology_spread"], w_ia=w["interpod_affinity"],
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=mask.device),
    )


def precompute_static(cfg: EngineConfig, snap: ClusterSnapshot,
                      node_sat_t: torch.Tensor) -> StaticCtx:
    cells = _tableau_cells(snap, snap.pods, snap.nodes, node_sat_t)
    return finalize_static(cfg, snap, *cells)


# -- the per-pod cycle and the parity scan (K4) -----------------------------


def pod_cycle(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
              p: int, used: torch.Tensor):
    """Single-pod [N] Filter + Score against `used` (the scan body).
    With no signature, pairwise_row is the identity: zero spread
    penalty (inverse-normalised to 100) and zero inter-pod raw score
    (min-max-normalised to 0). Returns (feasible, score)."""
    nodes = snap.nodes
    nvalid = nodes.valid
    req = snap.pods.requests[p]
    zeros = torch.zeros(nvalid.shape[0], dtype=torch.float32,
                        device=nvalid.device)
    feasible = static.mask[p] & kfilter.resource_fit(nodes.allocatable,
                                                     used, req)
    score = (
        static.w_lr[p] * kscore.least_requested(nodes.allocatable, used, req,
                                                static.rw)
        + static.w_ba[p] * kscore.balanced_allocation(nodes.allocatable,
                                                      used, req, static.rw)
        + static.score[p]
        + static.w_ts[p] * kscore.inverse_normalize(zeros, nvalid)
        + static.w_ia[p] * kscore.minmax_normalize(zeros, nvalid)
    )
    return feasible, score


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
    P = order.shape[0]
    dev = order.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    used = snap.nodes.used.clone()
    assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    chosen = torch.full((P,), NEG_INF, dtype=torch.float32, device=dev)
    requests = snap.pods.requests
    for p in order.tolist():
        feasible, score = pod_cycle(cfg, snap, static, p, used)
        masked = torch.where(feasible, score, neg)
        n = pick_node(cfg, masked, p)
        commit = feasible.any()
        # An unplaced pod adds 0 to used[argmax] = used[0], as in JAX.
        used[n] = used[n] + torch.where(commit, requests[p],
                                        torch.zeros_like(requests[p]))
        assigned[p] = torch.where(commit, n, -1)
        chosen[p] = torch.where(commit, masked[n], neg)
    return assigned, chosen, used


def parity_scan(cfg: EngineConfig, snap: ClusterSnapshot, static: StaticCtx,
                order: torch.Tensor):
    """Kernel K4 on CUDA tensors, the plain version on CPU tensors."""
    dev = static.mask.device
    if dev.type == "cpu":
        return parity_scan_plain(cfg, snap, static, order)
    P, N = static.mask.shape
    R = snap.nodes.allocatable.shape[1]
    k = "parity_scan"
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
    used = snap.nodes.used.clone()
    assigned = torch.empty((P,), dtype=torch.int32, device=dev)
    chosen = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return assigned, chosen, used
    ins = (order32, static.mask, static.score, snap.nodes.allocatable,
           snap.pods.requests, static.w_lr, static.w_ba, static.w_ts,
           static.w_ia, static.rw)
    _build.launch("tpusched_parity_scan", P, N, R,
                  *(t.data_ptr() for t in ins),
                  int(cfg.tie_break == "seeded"), cfg.tie_seed & 0xFFFFFFFF,
                  used.data_ptr(), assigned.data_ptr(), chosen.data_ptr(),
                  stream_of(dev))
    parity_scan.launches += 1
    return assigned, chosen, used


parity_scan.launches = 0


def solve_sequential(cfg: EngineConfig, snap: ClusterSnapshot,
                     node_sat_t: torch.Tensor):
    """Exact sequential commit (stock scheduleOne semantics). Returns
    (assigned, chosen, used, order, evicted). Refuses what the scan does
    not implement yet rather than skipping it: the JAX scan's pairwise
    and gang steps are identities only when those axes are empty."""
    if snap.sigs.key.shape[0] > 0:
        raise NotImplementedError(
            "snapshot has pairwise signatures (topology spread / "
            "inter-pod affinity): not ported yet; ROADMAP A6 ports it")
    if snap.group_min_member.shape[0] > 0:
        raise NotImplementedError(
            "snapshot has pod groups (gangs): not ported yet; ROADMAP A7 "
            "ports it")
    if cfg.preemption:
        raise NotImplementedError(
            "preemption is not ported yet; ROADMAP A8 ports it")
    static = precompute_static(cfg, snap, node_sat_t)
    M = snap.running.valid.shape[0]
    order = pop_order(cfg, snap)
    assigned, chosen, used = parity_scan(cfg, snap, static, order)
    evicted = torch.zeros(M, dtype=torch.bool, device=order.device)
    return assigned, chosen, used, order, evicted
