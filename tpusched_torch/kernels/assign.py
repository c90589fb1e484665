"""The solve paths: the port of `tpusched/kernels/assign.py` for
snapshots without pairwise signatures, gangs or preemption.

The scheduling cycle splits, as in the JAX package, into
  * a STATIC part computed once per snapshot (StaticCtx): the cell-local
    tableau (kernel K2, `_tableau_cells`), then its row-coupled
    normalisation times the per-pod QoS weights (kernel K3, inside
    `finalize_static`);
  * a DYNAMIC part that depends on node `used`: resource fit,
    LeastRequested and BalancedAllocation. Parity mode evaluates it pod
    by pod in dynamic-priority order in the parity scan (kernel K4,
    `parity_scan`), which commits each pod before the next one scores.
    ScoreBatch and fast mode evaluate it for a whole [rows, N] block at
    once (kernel K5, `cycle`); a fast round then ranks each row (K6,
    `row_topk`), deals pods onto nodes by a node desirability (K7,
    `desirability`) and commits capacity prefixes per node in sub-steps
    (K8, `prefix_commit`).

Every kernel wrapper runs its plain version (`*_plain`) on CPU tensors.
The solve functions take an `Ops` table (default: the kernel wrappers);
`PLAIN` holds the plain versions, with which a caller can run a whole
solve on CUDA tensors without a kernel, to compare.

The JAX fast rounds are `lax.while_loop`s on the device. Here they are
Python loops that read one device flag per round, per commit sub-step
and per tranche; `RoundStats` counts those reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import check, stream_of
from tpusched_torch.kernels import filter as kfilter
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
                    na_raw, tt_count, ops: "Ops | None" = None) -> StaticCtx:
    """StaticCtx from the tableau: per-pod QoS plugin weights (plain
    torch over [P]) and the row-normalised static score (K3)."""
    ops = ops or KERNELS
    pods = snap.pods
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    score = ops.finalize_score(na_raw, tt_count, snap.nodes.valid,
                               w["node_affinity"], w["taint_toleration"])
    return StaticCtx(
        mask=mask, aff_ok=aff_ok, score=score,
        w_lr=w["least_requested"], w_ba=w["balanced_allocation"],
        w_ts=w["topology_spread"], w_ia=w["interpod_affinity"],
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=mask.device),
    )


def precompute_static(cfg: EngineConfig, snap: ClusterSnapshot,
                      node_sat_t: torch.Tensor,
                      ops: "Ops | None" = None) -> StaticCtx:
    ops = ops or KERNELS
    cells = ops.tableau_cells(snap, snap.pods, snap.nodes, node_sat_t)
    return finalize_static(cfg, snap, *cells, ops=ops)


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


def refuse_unported(cfg: EngineConfig, snap: ClusterSnapshot) -> None:
    """Raise for what the solve paths do not implement yet rather than
    skip it: the JAX paths' pairwise, gang and preemption steps are
    identities only when those axes are empty."""
    _refuse_signatures(snap)
    if snap.group_min_member.shape[0] > 0:
        raise NotImplementedError(
            "snapshot has pod groups (gangs): not ported yet; ROADMAP A7 "
            "ports it")
    if cfg.preemption:
        raise NotImplementedError(
            "preemption is not ported yet; ROADMAP A8 ports it")


def _refuse_signatures(snap: ClusterSnapshot) -> None:
    if snap.sigs.key.shape[0] > 0:
        raise NotImplementedError(
            "snapshot has pairwise signatures (topology spread / "
            "inter-pod affinity): not ported yet; ROADMAP A6 ports it")


def solve_sequential(cfg: EngineConfig, snap: ClusterSnapshot,
                     node_sat_t: torch.Tensor, ops: "Ops | None" = None):
    """Exact sequential commit (stock scheduleOne semantics). Returns
    (assigned, chosen, used, order, evicted)."""
    ops = ops or KERNELS
    refuse_unported(cfg, snap)
    static = precompute_static(cfg, snap, node_sat_t, ops)
    M = snap.running.valid.shape[0]
    order = pop_order(cfg, snap)
    assigned, chosen, used = ops.parity_scan(cfg, snap, static, order)
    evicted = torch.zeros(M, dtype=torch.bool, device=order.device)
    return assigned, chosen, used, order, evicted


# -- K5: the batched Filter + Score pass ------------------------------------


def cycle_plain(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor,
                mask: torch.Tensor, sscore: torch.Tensor, w_lr: torch.Tensor,
                w_ba: torch.Tensor, w_ts: torch.Tensor, rw: torch.Tensor,
                rows: torch.Tensor | None = None,
                pending: torch.Tensor | None = None, masked: bool = False):
    """(feasible, score) [rows, N] of `_cycle_nosig`: mask & fit, and
    ((w_lr*LR + w_ba*BA) + static) + w_ts*100. rows selects pod rows of
    req, mask, sscore and the weights; pending cuts rows to pending
    pods; masked=True gives where(feasible, score, -inf)."""
    if rows is not None:
        rows = rows.long()
        req, mask, sscore = req[rows], mask[rows], sscore[rows]
        w_lr, w_ba, w_ts = w_lr[rows], w_ba[rows], w_ts[rows]
    feasible = mask & kfilter.resource_fit(alloc, used, req)
    if pending is not None:
        feasible = feasible & pending[:, None]
    score = (
        w_lr[:, None] * kscore.least_requested(alloc, used, req, rw)
        + w_ba[:, None] * kscore.balanced_allocation(alloc, used, req, rw)
        + sscore
        + w_ts[:, None] * 100.0
    )
    if masked:
        score = torch.where(feasible, score,
                            torch.full((), NEG_INF, dtype=score.dtype,
                                       device=score.device))
    return feasible, score


def cycle(alloc: torch.Tensor, used: torch.Tensor, req: torch.Tensor,
          mask: torch.Tensor, sscore: torch.Tensor, w_lr: torch.Tensor,
          w_ba: torch.Tensor, w_ts: torch.Tensor, rw: torch.Tensor,
          rows: torch.Tensor | None = None,
          pending: torch.Tensor | None = None, masked: bool = False):
    """Kernel K5 on CUDA tensors, the plain version on CPU tensors."""
    dev = mask.device
    if dev.type == "cpu":
        return cycle_plain(alloc, used, req, mask, sscore, w_lr, w_ba, w_ts,
                           rw, rows, pending, masked)
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
    feasible = torch.empty((n_rows, N), dtype=torch.bool, device=dev)
    score = torch.empty((n_rows, N), dtype=torch.float32, device=dev)
    if n_rows * N == 0:
        return feasible, score
    _build.launch(
        "tpusched_cycle", n_rows, N, R,
        rows.data_ptr() if rows is not None else None,
        pending.data_ptr() if pending is not None else None,
        *(t.data_ptr() for t in (mask, sscore, alloc, used, req, w_lr, w_ba,
                                 w_ts, rw)),
        int(masked), feasible.data_ptr(), score.data_ptr(), stream_of(dev))
    cycle.launches += 1
    return feasible, score


cycle.launches = 0


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
    return topv, topi, pick


row_topk.launches = 0


# -- K7: node desirability --------------------------------------------------


def desirability_plain(feasible: torch.Tensor, masked: torch.Tensor,
                       allowed: torch.Tensor) -> torch.Tensor:
    """[N]: the column mean over allowed rows of where(feasible, masked,
    0), -inf where no allowed row is feasible. The column sum adds the
    rows one at a time in ascending order, as the kernel does."""
    ok = feasible & allowed[:, None]
    contrib = torch.where(ok, masked, torch.zeros((), dtype=masked.dtype,
                                                  device=masked.device))
    acc = torch.zeros(masked.shape[1], dtype=masked.dtype,
                      device=masked.device)
    for p in range(masked.shape[0]):
        acc = acc + contrib[p]
    n_allowed = allowed.sum().clamp_min(1).to(masked.dtype)
    return torch.where(ok.any(dim=0), acc / n_allowed,
                       torch.full((), NEG_INF, dtype=masked.dtype,
                                  device=masked.device))


def desirability(feasible: torch.Tensor, masked: torch.Tensor,
                 allowed: torch.Tensor) -> torch.Tensor:
    """Kernel K7 on CUDA tensors, the plain version on CPU tensors."""
    dev = masked.device
    if dev.type == "cpu":
        return desirability_plain(feasible, masked, allowed)
    rows, N = masked.shape
    k = "desirability"
    check(k, dev, feasible, torch.bool, (rows, N))
    check(k, dev, masked, torch.float32, (rows, N))
    check(k, dev, allowed, torch.bool, (rows,))
    desir = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return desir
    _build.launch("tpusched_desirability", rows, N, feasible.data_ptr(),
                  masked.data_ptr(), allowed.data_ptr(), desir.data_ptr(),
                  stream_of(dev))
    desirability.launches += 1
    return desir


desirability.launches = 0


# -- K8: one capacity-prefix commit sub-step --------------------------------


def _scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 in the kernel's Hillis-Steele
    order: at step d every row i >= d adds row i - d."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], x[d:] + x[:-d]])
        d <<= 1
    return x


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
    boundary = torch.ones(P, dtype=torch.bool, device=dev)
    boundary[1:] = cand_s[1:] != cand_s[:-1]
    seg = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
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


# -- ScoreBatch ---------------------------------------------------------------


def batched_cycle(cfg: EngineConfig, snap: ClusterSnapshot,
                  static: StaticCtx, used: torch.Tensor,
                  masked: bool = False, ops: "Ops | None" = None):
    """Full [P, N] Filter + Score against `used` (K5). With no pairwise
    signature the spread and inter-pod normalisers are the constants 100
    and 0, so the score is the oracle's sum without [P, N] pairwise
    work. masked=True returns where(feasible, score, -inf) as the
    score."""
    ops = ops or KERNELS
    _refuse_signatures(snap)
    nodes, pods = snap.nodes, snap.pods
    return ops.cycle(nodes.allocatable, used, pods.requests, static.mask,
                     static.score, static.w_lr, static.w_ba, static.w_ts,
                     static.rw, masked=masked)


def score_batch(cfg: EngineConfig, snap: ClusterSnapshot,
                node_sat_t: torch.Tensor, masked: bool = False,
                ops: "Ops | None" = None):
    """One-shot [P, N] feasibility + scores against the snapshot's usage
    (no commits): the ScoreBatch surface. The JAX function's
    pair_state_init is the identity at S = 0."""
    static = precompute_static(cfg, snap, node_sat_t, ops)
    return batched_cycle(cfg, snap, static, snap.nodes.used, masked, ops)


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
    round loops read (`host_reads`: one per round, per commit sub-step
    and per tranche), and, with `timing` (CUDA only), CUDA-event spans by
    stage name, read back by `ms()`."""

    def __init__(self, timing: bool = False):
        self.host_reads = 0
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


def _deal_commit(alloc, requests, used, feasible, masked, allowed, rank,
                 topv, topi, tie_pick=None, rank_is_sorted: bool = False,
                 ops: "Ops | None" = None,
                 stats: RoundStats | None = None):
    """One round's dealing + capacity-prefix conflict resolution +
    rescue (JAX `_deal_commit` with cum_width=None and no dealt
    override), over any pod-axis width. topv/topi: each row's top-K of
    `masked` (K6, ties to the lower index). Returns (used2, choice,
    chosen_val); choice[p] = committed node or -1.

    Dealing: the q-th allowed pod by rank targets the node where the
    cumulative remaining capacity (nodes by descending desirability, K7)
    first covers the cumulative demand of pods 0..q, for every resource.
    The dealt node (when feasible) leads each pod's candidate list, then
    its own top-K; K + 1 capacity sub-steps (K8) commit, per node, the
    longest rank-ordered prefix that fits. If nothing committed while an
    allowed pod is still feasible somewhere, the best-ranked such pod is
    committed at its own top choice (the rescue), so every round places
    a pod until nothing pending is placeable."""
    ops = ops or KERNELS
    stats = stats or RoundStats()
    P = requests.shape[0]
    N = alloc.shape[0]
    dev = requests.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    with stats.span("K7 desirability"):
        desir = ops.desirability(feasible, masked, allowed)
    node_order = torch.sort(-desir, stable=True).indices
    remaining = (alloc - used).clamp_min(0.0)
    remaining = torch.where(torch.isfinite(desir)[:, None], remaining, zero)
    # Inclusive cumulative demand of allowed pods in rank order.
    dem = torch.where(allowed[:, None], requests, zero)
    if rank_is_sorted:
        my_dem = torch.cumsum(dem, dim=0)
    else:
        rm = torch.zeros_like(dem)
        rm[rank.long()] = dem
        my_dem = torch.cumsum(rm, dim=0)[rank.long()]
    cum_rem = torch.cumsum(remaining[node_order], dim=0)     # [N, R]
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

    # Rescue. In the no-signature round `allowed` is any(feasible, 1),
    # the JAX code's `allowed & want`.
    commit = choice >= 0
    can_rescue = ~commit.any() & allowed.any()
    BIG = torch.iinfo(torch.int32).max
    p_star = torch.argmin(torch.where(allowed, rank,
                                      torch.full_like(rank, BIG)))
    n_star = (tie_pick if tie_pick is not None else first_best)[p_star].long()
    used_j = used_j.clone()
    used_j[n_star] = used_j[n_star] + torch.where(can_rescue,
                                                  requests[p_star], zero)
    choice[p_star] = torch.where(can_rescue, n_star.to(torch.int32),
                                 choice[p_star])
    chosen_val = masked.gather(1, choice.clamp(0, N - 1).long()[:, None])[:, 0]
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


def gang_rollback(snap: ClusterSnapshot, used, assigned, chosen):
    """The all-or-nothing gang gate (JAX `gang_rollback`): the identity
    at G = 0, the only case ported (ROADMAP A7; `refuse_unported` turns
    gangs away first). Returns (used, assigned, chosen, rolled)."""
    rolled = torch.zeros_like(assigned, dtype=torch.bool)
    return used, assigned, chosen, rolled


def solve_rounds(cfg: EngineConfig, snap: ClusterSnapshot,
                 node_sat_t: torch.Tensor | None,
                 static: StaticCtx | None = None, ops: "Ops | None" = None,
                 stats: RoundStats | None = None):
    """Fast mode: batched commit rounds. Returns (assigned, chosen, used,
    order, round_of, rounds, evicted); round_of is the commit key (pods
    of an earlier round committed strictly earlier)."""
    ops = ops or KERNELS
    refuse_unported(cfg, snap)
    if static is None:
        static = precompute_static(cfg, snap, node_sat_t, ops)
    pods, nodes = snap.pods, snap.nodes
    P = pods.valid.shape[0]
    N = nodes.valid.shape[0]
    dev = pods.valid.device
    order = pop_order(cfg, snap)
    rank = torch.zeros(P, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(P, dtype=torch.int32, device=dev)
    # Worst case one pod commits per round; cfg.max_rounds > 0 caps it.
    max_rounds = cfg.max_rounds if cfg.max_rounds > 0 else 2 * P + 8
    used, assigned, chosen, round_of, rounds = _solve_rounds_nosig(
        cfg, snap, static, rank, order, max_rounds, _fallback_depth(N),
        ops=ops, stats=stats)
    evicted = torch.zeros(snap.running.valid.shape[0], dtype=torch.bool,
                          device=dev)
    used, assigned, chosen, rolled = gang_rollback(snap, used, assigned,
                                                   chosen)
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


KERNELS = Ops(atom_sat, _tableau_cells, finalize_score, parity_scan, cycle,
              row_topk, desirability, prefix_commit)
PLAIN = Ops(atom_sat_plain, _tableau_cells_plain, finalize_score_plain,
            parity_scan_plain, cycle_plain, row_topk_plain,
            desirability_plain, prefix_commit_plain)
