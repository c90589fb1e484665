"""Scoring plugins: the port of `tpusched/kernels/score.py`.

Plain torch, in the JAX functions' op order, so each value is the same
f32. Sums over the small R (resource) and PT (preferred term) axes run
left to right from 0, the order the parity kernels use. Every divisor
is a tensor on the operands' device: PyTorch's CUDA `div` turns a
division by a Python scalar into a multiply by its reciprocal, which
can differ from the division in the last bit.
"""

from __future__ import annotations

import torch

from tpusched_torch.config import EFFECT_PREFER_NO_SCHEDULE, MAX_NODE_SCORE
from tpusched_torch.kernels.atoms import gather_term_sat


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis, starting from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for r in range(x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def _full_like(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=x.dtype, device=x.device)


def least_requested(alloc: torch.Tensor, used: torch.Tensor,
                    requests: torch.Tensor,
                    resource_weights: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit/LeastAllocated:
    sum_r w_r * (alloc - used - req) * 100 / alloc / sum_r w_r.
    alloc/used: [N, R]; requests: [P, R] or [R]; resource_weights: [R]."""
    if requests.dim() == 1:
        free = alloc - used - requests[None, :]
    else:
        free = alloc[None] - used[None] - requests[:, None, :]
    zero = _full_like(free, 0.0)
    per_r = torch.where(alloc > 0, free * MAX_NODE_SCORE / alloc, zero)
    per_r = torch.where(per_r < 0, zero, per_r)
    wsum = _sum_last(resource_weights).clamp_min(1e-9)
    return _sum_last(per_r * resource_weights) / wsum


def balanced_allocation(alloc: torch.Tensor, used: torch.Tensor,
                        requests: torch.Tensor,
                        resource_weights: torch.Tensor) -> torch.Tensor:
    """NodeResourcesBalancedAllocation: (1 - stddev(fractions)) * 100
    over resources with positive score weight."""
    if requests.dim() == 1:
        tot = used + requests[None, :]
    else:
        tot = used[None] + requests[:, None, :]
    frac = torch.where(alloc > 0, tot / alloc, _full_like(tot, 1.0))
    frac = frac.clamp(0.0, 1.0)
    sel = (resource_weights > 0).to(frac.dtype)
    k = _sum_last(sel).clamp_min(1.0)
    mean = _sum_last(frac * sel)[..., None] / k
    d = frac - mean
    var = _sum_last((d * d) * sel) / k
    # The square root in f64, rounded once to f32: the correctly rounded
    # f32 root, as CUDA's sqrtf and numpy give. PyTorch's f32 sqrt on
    # AVX-512 CPUs is not always correctly rounded.
    return (1.0 - torch.sqrt(var.double()).to(var.dtype)) * MAX_NODE_SCORE


def node_affinity_raw(node_sat_t: torch.Tensor,
                      pref_term_atoms: torch.Tensor,
                      pref_term_valid: torch.Tensor,
                      pref_weight: torch.Tensor) -> torch.Tensor:
    """Sum of satisfied preferred-term weights per (pod, node): the
    cell-local half of node_affinity_score."""
    term_ok = gather_term_sat(node_sat_t, pref_term_atoms)    # [..., PT, N]
    term_ok &= pref_term_valid[..., None]
    terms = pref_weight[..., None] * term_ok.to(pref_weight.dtype)
    acc = torch.zeros(terms.shape[:-2] + terms.shape[-1:],
                      dtype=terms.dtype, device=terms.device)
    for t in range(terms.shape[-2]):
        acc = acc + terms[..., t, :]
    return acc


def node_affinity_score(node_sat_t: torch.Tensor,
                        pref_term_atoms: torch.Tensor,
                        pref_term_valid: torch.Tensor,
                        pref_weight: torch.Tensor,
                        node_valid: torch.Tensor) -> torch.Tensor:
    """Preferred node affinity, default-normalised per pod."""
    raw = node_affinity_raw(node_sat_t, pref_term_atoms, pref_term_valid,
                            pref_weight)
    return default_normalize(raw, node_valid)


def taint_intolerable_count(node_taint_ids: torch.Tensor,
                            taint_effect: torch.Tensor,
                            tolerated: torch.Tensor) -> torch.Tensor:
    """Intolerable PreferNoSchedule taints per (pod, node), as f32."""
    tid = node_taint_ids.clamp(min=0).long()
    soft = (node_taint_ids >= 0) & (taint_effect[tid]
                                    == EFFECT_PREFER_NO_SCHEDULE)
    if tolerated.dim() == 1:
        intol = soft & ~tolerated[tid]
    else:
        intol = soft[None] & ~tolerated[:, tid]
    return intol.sum(dim=-1).to(torch.float32)


def taint_toleration_from_count(count: torch.Tensor,
                                node_valid: torch.Tensor) -> torch.Tensor:
    """Inverse-normalise the intolerable-taint counts per pod row."""
    zero = _full_like(count, 0.0)
    mx = torch.where(node_valid, count, zero).amax(dim=-1, keepdim=True)
    return torch.where(
        mx > 0, (mx - count) * MAX_NODE_SCORE / mx.clamp_min(1e-9),
        _full_like(count, MAX_NODE_SCORE))


def taint_toleration_score(node_taint_ids: torch.Tensor,
                           taint_effect: torch.Tensor,
                           tolerated: torch.Tensor,
                           node_valid: torch.Tensor) -> torch.Tensor:
    count = taint_intolerable_count(node_taint_ids, taint_effect, tolerated)
    return taint_toleration_from_count(count, node_valid)


def default_normalize(raw: torch.Tensor,
                      node_valid: torch.Tensor) -> torch.Tensor:
    """Upstream DefaultNormalizeScore: the row max becomes 100; an
    all-zero row gives 0."""
    zero = _full_like(raw, 0.0)
    mx = torch.where(node_valid, raw, zero).amax(dim=-1, keepdim=True)
    return torch.where(mx > 0, raw * MAX_NODE_SCORE / mx.clamp_min(1e-9),
                       zero)


def inverse_normalize(penalty: torch.Tensor,
                      node_valid: torch.Tensor) -> torch.Tensor:
    """Lower penalty -> higher score; all-equal -> 100."""
    big = torch.where(node_valid, penalty, _full_like(penalty, -torch.inf))
    sml = torch.where(node_valid, penalty, _full_like(penalty, torch.inf))
    mx = big.amax(dim=-1, keepdim=True)
    mn = sml.amin(dim=-1, keepdim=True)
    return torch.where(
        mx > mn,
        (mx - penalty) * MAX_NODE_SCORE / (mx - mn).clamp_min(1e-9),
        _full_like(penalty, MAX_NODE_SCORE),
    )


def minmax_normalize(raw: torch.Tensor,
                     node_valid: torch.Tensor) -> torch.Tensor:
    """Upstream InterPodAffinity normalize: (raw-min)/(max-min)*100,
    max == min -> 0."""
    big = torch.where(node_valid, raw, _full_like(raw, -torch.inf))
    sml = torch.where(node_valid, raw, _full_like(raw, torch.inf))
    mx = big.amax(dim=-1, keepdim=True)
    mn = sml.amin(dim=-1, keepdim=True)
    return torch.where(
        mx > mn, (raw - mn) * MAX_NODE_SCORE / (mx - mn).clamp_min(1e-9),
        _full_like(raw, 0.0),
    )
