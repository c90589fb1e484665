"""Feasibility predicates as boolean masks: the port of
`tpusched/kernels/filter.py`.

Plain torch. These are the building blocks of the tableau kernel's
(K2) plain version; the parity scan kernel (K4) evaluates
`resource_fit` per cell itself, and its plain version calls it here.
"""

from __future__ import annotations

import torch

from tpusched_torch.config import EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE
from tpusched_torch.kernels.atoms import gather_term_sat
from tpusched_torch.snapshot import ClusterSnapshot


def resource_fit(alloc: torch.Tensor, used: torch.Tensor,
                 requests: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit: forall r: used + req <= alloc.
    alloc/used: [N, R]; requests: [P, R] -> [P, N] (or [R] -> [N])."""
    if requests.dim() == 1:
        return (used + requests[None, :] <= alloc).all(dim=-1)
    return (used[None, :, :] + requests[:, None, :]
            <= alloc[None, :, :]).all(dim=-1)


def taint_mask(node_taint_ids: torch.Tensor, taint_effect: torch.Tensor,
               tolerated: torch.Tensor) -> torch.Tensor:
    """TaintToleration filter: every NoSchedule/NoExecute taint
    tolerated. node_taint_ids: [N, TN] (-1 pad); taint_effect: [VT];
    tolerated: [P, VT] -> [P, N] (or [VT] -> [N])."""
    tid = node_taint_ids.clamp(min=0).long()
    eff = taint_effect[tid]                              # [N, TN]
    hard = (node_taint_ids >= 0) & (
        (eff == EFFECT_NO_SCHEDULE) | (eff == EFFECT_NO_EXECUTE)
    )
    if tolerated.dim() == 1:
        return (~hard | tolerated[tid]).all(dim=-1)
    tol = tolerated[:, tid]                              # [P, N, TN]
    return (~hard[None] | tol).all(dim=-1)


def node_affinity_mask(node_sat_t: torch.Tensor,
                       req_term_atoms: torch.Tensor,
                       req_term_valid: torch.Tensor) -> torch.Tensor:
    """Required node affinity + nodeSelector: OR over terms, AND within.
    node_sat_t: [A, N]; req_term_atoms: [P, T, AT] or [T, AT]. A pod
    with zero valid terms matches all nodes."""
    term_ok = gather_term_sat(node_sat_t, req_term_atoms)     # [..., T, N]
    term_ok &= req_term_valid[..., None]
    has_req = req_term_valid.any(dim=-1)
    any_term = term_ok.any(dim=-2)
    return torch.where(has_req[..., None], any_term,
                       torch.ones_like(any_term))


def full_static_mask(snap: ClusterSnapshot,
                     node_sat_t: torch.Tensor) -> torch.Tensor:
    """Taints & node affinity & node/pod validity -> [P, N]."""
    m = taint_mask(snap.nodes.taint_ids, snap.taint_effect,
                   snap.pods.tolerated)
    m &= node_affinity_mask(node_sat_t, snap.pods.req_term_atoms,
                            snap.pods.req_term_valid)
    m &= snap.nodes.valid[None, :]
    m &= snap.pods.valid[:, None]
    return m
