"""Decision provenance: the port of `tpusched/kernels/explain.py`.

The solve answers what was decided; the probe answers why, for one
snapshot against its starting state:

  * per-pod filter tallies: every (valid pod, valid node) cell is
    counted under its FIRST failing predicate in FILTER_REASONS order,
    so feasible_nodes + sum(filter_counts) == the number of valid nodes
    for every valid pod;
  * the top-k candidate nodes by total score, with the score split into
    its SCORE_TERMS, each times the solve's effective (urgency
    reweighted) weight;
  * the QoS inputs: per-pod pressure and effective priority, per-victim
    effective priority, slack and the auction's shifted eviction cost.

Everything goes into ONE flat f32 buffer (JAX's layout, decoded by
`unpack_probe`). The [P, N] pass is kernel K22 (`explain_cells`, with
`explain_terms` for the chosen cells' terms, csrc/explain.cu), the top-k
K6; the victim columns are [M] elementwise and stay plain torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import check, ptrs, stream_of
from tpusched_torch.kernels import filter as kfilter
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels import score as kscore
from tpusched_torch.qos import (
    effective_weights,
    evict_cost_raw,
    pressure_of,
    priority_terms,
    victim_effective_priority,
)
from tpusched_torch.snapshot import ClusterSnapshot

# First-failing-predicate order; padded node slots are outside the
# universe, so feasible + sum(tallies) == the number of VALID nodes.
FILTER_REASONS = (
    "cordoned",
    "taint",
    "node_affinity",
    "resources",
    "spread",
    "interpod_affinity",
)

# Score decomposition columns (qos._PLUGINS order).
SCORE_TERMS = (
    "least_requested",
    "balanced_allocation",
    "node_affinity",
    "taint_toleration",
    "topology_spread",
    "interpod_affinity",
)

NR = len(FILTER_REASONS)
NT = len(SCORE_TERMS)


@dataclasses.dataclass
class ScoreExplain:
    """Host-side decode of one probe (full bucketed axes)."""

    k: int
    topk_idx: np.ndarray        # [P, k] int32 node, -1 = no candidate
    topk_score: np.ndarray      # [P, k] f32 total (0 at -1 slots)
    topk_terms: np.ndarray      # [P, k, T] f32 per-term contributions
    filter_counts: np.ndarray   # [P, NR] int32 eliminated nodes by reason
    feasible_nodes: np.ndarray  # [P] int32
    pressure: np.ndarray        # [P] f32 QoS pressure
    priority: np.ndarray        # [P] f32 effective priority
    victim_priority: np.ndarray  # [M] f32 victim effective priority
    victim_slack: np.ndarray    # [M] f32
    evict_cost: np.ndarray      # [M] f32 shifted-positive auction cost


@dataclasses.dataclass
class ProbeInputs:
    """What K22 reads: the snapshot, its tableau (K2: aff_ok, na_raw,
    tt_count), the per-pod effective weights, and with signatures the
    pair state of the running members (K10) and the signature domains."""

    snap: ClusterSnapshot
    aff_ok: torch.Tensor        # [P, N] bool
    na_raw: torch.Tensor        # [P, N] f32
    tt_count: torch.Tensor      # [P, N] f32
    sig_match: torch.Tensor     # [S, M+P] bool
    w: dict                     # SCORE_TERMS name -> [P] f32
    rw: torch.Tensor            # [R] f32 resource score weights
    st: "kpair.PairState | None"
    dom_s: torch.Tensor | None


def probe_inputs(cfg: EngineConfig, snap: ClusterSnapshot, tab,
                 pair_counts, init_counts=None) -> ProbeInputs:
    """ProbeInputs from a tableau (assign.WarmTableau); pair_counts is
    K10 (or its plain version), run only with signatures; init_counts,
    the ring's, replace its counts."""
    pods = snap.pods
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    st = dom_s = None
    if snap.sigs.key.shape[0] > 0:
        dom_s = kpair.sig_domains(snap)
        st = pair_counts(tab.sig_match, dom_s, snap.running, pods,
                         counts=init_counts)
    return ProbeInputs(
        snap=snap, aff_ok=tab.aff_ok, na_raw=tab.na_raw,
        tt_count=tab.tt_count, sig_match=tab.sig_match,
        w={k: w[k].contiguous() for k in SCORE_TERMS},
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=tab.mask.device),
        st=st, dom_s=dom_s)


# -- K22: plain version --------------------------------------------------------


def _pairwise_plain(q: ProbeInputs):
    """(spread_ok, pen, ia_ok, raw) [P, N] against the running members'
    state, or None without signatures."""
    if q.st is None:
        return None
    return kpair.pairwise_from_counts(q.snap, q.st, q.aff_ok, q.sig_match,
                                      q.dom_s)


def _terms_plain(q: ProbeInputs, pw) -> torch.Tensor:
    """The [P, N, 6] term tensor in explain_probe's op order."""
    snap = q.snap
    nodes, pods = snap.nodes, snap.pods
    nvalid = nodes.valid
    w = q.w
    lr = w["least_requested"][:, None] * kscore.least_requested(
        nodes.allocatable, nodes.used, pods.requests, q.rw)
    ba = w["balanced_allocation"][:, None] * kscore.balanced_allocation(
        nodes.allocatable, nodes.used, pods.requests, q.rw)
    na = w["node_affinity"][:, None] * kscore.default_normalize(q.na_raw,
                                                                nvalid)
    tt = w["taint_toleration"][:, None] * kscore.taint_toleration_from_count(
        q.tt_count, nvalid)
    if pw is not None:
        _, pen, _, raw = pw
        ts = w["topology_spread"][:, None] * kscore.inverse_normalize(
            pen, nvalid)
        ia = w["interpod_affinity"][:, None] * kscore.minmax_normalize(
            raw, nvalid)
    else:
        ts = (w["topology_spread"][:, None] * 100.0).expand_as(lr)
        ia = torch.zeros_like(lr)
    return torch.stack([lr, ba, na, tt, ts, ia], dim=-1)


def _sum_terms(terms: torch.Tensor) -> torch.Tensor:
    """The six terms summed left to right from 0.0 (K22's order)."""
    acc = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                      device=terms.device)
    for k in range(terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


def explain_cells_plain(q: ProbeInputs):
    """K22's first entry point in plain torch: (tallies [P, 6] int32,
    feasible [P] int32, masked [P, N] f32, norms None). It builds the
    [P, N, 6] term tensor (CPU and test use only)."""
    snap = q.snap
    nodes, pods = snap.nodes, snap.pods
    cordon_ok = nodes.schedulable[None, :] | pods.tolerates_unsched[:, None]
    taint_ok = kfilter.taint_mask(nodes.taint_ids, snap.taint_effect,
                                  pods.tolerated)
    res_ok = kfilter.resource_fit(nodes.allocatable, nodes.used,
                                  pods.requests)
    pw = _pairwise_plain(q)
    ones = torch.ones_like(res_ok)
    spread_ok, ia_ok = (ones, ones) if pw is None else (pw[0], pw[2])
    alive = pods.valid[:, None] & nodes.valid[None, :]
    tallies = []
    for ok in (cordon_ok, taint_ok, q.aff_ok, res_ok, spread_ok, ia_ok):
        hit = alive & ~ok
        tallies.append(hit.sum(dim=1, dtype=torch.int32))
        alive = alive & ~hit
    total = _sum_terms(_terms_plain(q, pw))
    masked = torch.where(alive, total, torch.full((), float("-inf"),
                                                  device=total.device))
    return (torch.stack(tallies, dim=1), alive.sum(dim=1, dtype=torch.int32),
            masked, None)


def explain_terms_plain(q: ProbeInputs, norms, topv: torch.Tensor,
                        topi: torch.Tensor) -> torch.Tensor:
    """K22's second entry point in plain torch: the [P, kb, 6] terms at
    the chosen cells, gathered from the full term tensor, zero where a
    slot has no candidate. norms is unused (the plain version
    recomputes the rows)."""
    terms = _terms_plain(q, _pairwise_plain(q))
    N = terms.shape[1]
    idx = topi.long().clamp(0, N - 1)
    got = torch.gather(terms, 1, idx[..., None].expand(*idx.shape, NT))
    ok = torch.isfinite(topv)[..., None]
    return torch.where(ok, got, torch.zeros((), device=got.device))


# -- K22: the kernel -----------------------------------------------------------


def _k22_args(k: str, q: ProbeInputs) -> tuple:
    """The pairwise block (K11's, from kpair._pair_term_args, or zeros at
    S = 0) and the probe block of both K22 entry points, checked."""
    snap = q.snap
    nodes, pods = snap.nodes, snap.pods
    dev = q.aff_ok.device
    P, N = q.aff_ok.shape
    R = nodes.allocatable.shape[1]
    TN = nodes.taint_ids.shape[1]
    VT = pods.tolerated.shape[1]
    if R > 8:
        raise ValueError(f"{k}: {R} resource axes, the kernel takes <= 8")
    if q.st is None:
        pair = (0, 0, 0, snap.running.valid.shape[0]) + (None,) * 16
    else:
        pair = kpair._pair_term_args(k, snap, q.aff_ok, q.sig_match,
                                     q.dom_s, q.st)
    check(k, dev, nodes.allocatable, torch.float32, (N, R))
    check(k, dev, nodes.used, torch.float32, (N, R))
    check(k, dev, pods.requests, torch.float32, (P, R))
    check(k, dev, q.rw, torch.float32, (R,))
    check(k, dev, pods.valid, torch.bool, (P,))
    check(k, dev, nodes.valid, torch.bool, (N,))
    check(k, dev, nodes.schedulable, torch.bool, (N,))
    check(k, dev, pods.tolerates_unsched, torch.bool, (P,))
    check(k, dev, nodes.taint_ids, torch.int32, (N, TN))
    check(k, dev, snap.taint_effect, torch.int8, (VT,))
    check(k, dev, pods.tolerated, torch.bool, (P, VT))
    check(k, dev, q.aff_ok, torch.bool, (P, N))
    check(k, dev, q.na_raw, torch.float32, (P, N))
    check(k, dev, q.tt_count, torch.float32, (P, N))
    for name in SCORE_TERMS:
        check(k, dev, q.w[name], torch.float32, (P,))
    probe = (R, TN, VT, nodes.allocatable, nodes.used, pods.requests, q.rw,
             pods.valid, nodes.valid, nodes.schedulable,
             pods.tolerates_unsched, nodes.taint_ids, snap.taint_effect,
             pods.tolerated, q.aff_ok, q.na_raw, q.tt_count,
             *(q.w[name] for name in SCORE_TERMS))
    return pair, probe


def explain_cells(q: ProbeInputs):
    """Kernel K22 (explain_cells) on CUDA tensors, the plain version on
    CPU tensors: (tallies [P, 6] int32, feasible [P] int32, masked
    [P, N] f32, norms [P, 6 + 2C] f32, the row normalisers the second
    entry point reads; None from the plain version)."""
    dev = q.aff_ok.device
    if dev.type == "cpu":
        return explain_cells_plain(q)
    k = "explain_cells"
    pair, probe = _k22_args(k, q)
    P, N = q.aff_ok.shape
    C = pair[1]
    tallies = torch.empty((P, NR), dtype=torch.int32, device=dev)
    feasible = torch.empty((P,), dtype=torch.int32, device=dev)
    masked = torch.empty((P, N), dtype=torch.float32, device=dev)
    norms = torch.empty((P, 6 + 2 * C), dtype=torch.float32, device=dev)
    if P * N == 0:
        return tallies.zero_(), feasible.zero_(), masked, norms
    _build.launch("tpusched_explain_cells",
                  *ptrs((P, N, *pair, *probe, tallies, feasible, masked,
                         norms)), stream_of(dev))
    explain_cells.launches += 1
    return tallies, feasible, masked, norms


explain_cells.launches = 0


def explain_terms(q: ProbeInputs, norms, topv: torch.Tensor,
                  topi: torch.Tensor) -> torch.Tensor:
    """Kernel K22 (explain_terms) on CUDA tensors, the plain version on
    CPU tensors: the six terms at each chosen cell (topi [P, kb], K6's),
    [P, kb, 6] f32, zero where topv is -inf."""
    dev = q.aff_ok.device
    if dev.type == "cpu":
        return explain_terms_plain(q, norms, topv, topi)
    k = "explain_terms"
    pair, probe = _k22_args(k, q)
    P, kb = topi.shape
    check(k, dev, norms, torch.float32, (P, 6 + 2 * pair[1]))
    check(k, dev, topi, torch.int32, (P, kb))
    check(k, dev, topv, torch.float32, (P, kb))
    terms = torch.empty((P, kb, NT), dtype=torch.float32, device=dev)
    if P * kb == 0:
        return terms
    _build.launch("tpusched_explain_terms",
                  *ptrs((P, q.aff_ok.shape[1], *pair, *probe, norms, kb,
                         topi, topv, terms)), stream_of(dev))
    explain_terms.launches += 1
    return terms


explain_terms.launches = 0


# -- the probe -----------------------------------------------------------------


def explain_probe(cfg: EngineConfig, snap: ClusterSnapshot, tab, k: int,
                  ops, init_counts=None) -> torch.Tensor:
    """One flat f32 buffer of the provenance arrays (module docstring),
    from the snapshot's tableau `tab` (K1, K2; K9 with signatures):
    K10's pair state with signatures, K22's tallies and masked totals,
    K6's top k (1 <= k <= N, ties to the lower index), K22's terms at
    the chosen cells, then the QoS columns. ops: the kernel table
    (assign.KERNELS, or assign.PLAIN for the plain versions).
    init_counts: the ring's [S, N] counts, in place of K10's."""
    q = probe_inputs(cfg, snap, tab, ops.pair_counts, init_counts)
    tallies, feasible, masked, norms = ops.explain_cells(q)
    topv, topi, _ = ops.row_topk(masked, k)
    terms = ops.explain_terms(q, norms, topv, topi)
    ok = torch.isfinite(topv)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=topv.device)
    idx = torch.where(ok, topi, -1)
    val = torch.where(ok, topv, zero)

    pods, run = snap.pods, snap.running
    pt = priority_terms(cfg, pods.base_priority, pods.slo_target,
                        pods.observed_avail)
    vprio = victim_effective_priority(cfg, run.priority, run.slack)
    raw = evict_cost_raw(cfg, run.priority, run.slack).to(f32)
    # The positive shift of kernels/preempt.precompute: the reported costs
    # are the auction's.
    mn = torch.where(run.valid, raw, torch.full((), float("inf"),
                                                device=raw.device)).amin() \
        if raw.numel() else torch.full((), float("inf"), device=raw.device)
    mn = torch.where(torch.isfinite(mn), mn, zero)
    cost = raw - mn + 1.0
    return torch.cat([
        idx.to(f32).reshape(-1), val.reshape(-1), terms.reshape(-1),
        tallies.to(f32).reshape(-1), feasible.to(f32),
        pt["pressure"].to(f32), pt["effective"].to(f32), vprio.to(f32),
        run.slack.to(f32), cost.to(f32),
    ])


def unpack_probe(snap: ClusterSnapshot, buf, k: int) -> ScoreExplain:
    """Decode explain_probe's flat buffer (the layout authority)."""
    buf = np.asarray(buf)
    P = snap.pods.valid.shape[0]
    M = snap.running.valid.shape[0]
    off = 0

    def take(n, shape=None):
        nonlocal off
        out = buf[off:off + n]
        off += n
        return out.reshape(shape) if shape is not None else out

    return ScoreExplain(
        k=k,
        topk_idx=take(P * k, (P, k)).astype(np.int32),
        topk_score=take(P * k, (P, k)).astype(np.float32),
        topk_terms=take(P * k * NT, (P, k, NT)).astype(np.float32),
        filter_counts=take(P * NR, (P, NR)).astype(np.int32),
        feasible_nodes=take(P).astype(np.int32),
        pressure=take(P).astype(np.float32),
        priority=take(P).astype(np.float32),
        victim_priority=take(M).astype(np.float32),
        victim_slack=take(M).astype(np.float32),
        evict_cost=take(M).astype(np.float32),
    )
