#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`tpusched_torch`) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc (the kernels build from
tpusched_torch/csrc at first use), imports nothing of JAX or of the JAX
package, and
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels and prints the build time;
  3. kernel phase: holds each kernel against its plain PyTorch version
     on the same CUDA tensors of a 10 000 x 5 000 cluster with taints,
     selectors, affinity and cordons (cell b), requiring exact equality
     (bool, int and f32: the kernels are built with --fmad=false and
     keep their plain versions' order of f32 operations), and times
     both with CUDA events (median of several runs): K1 atom_sat,
     K2 tableau_cells, K3 finalize_static, K4 parity_scan; K5 cycle at
     full width and on a 1024-row index view (equal to the same view
     gathered), K6 row_topk (K = 8 seeded, kb = 8, beside torch.topk),
     K7 desirability on K5's output, K8 prefix_commit on the first
     sub-step of the first fast round;
     Then, on the pairwise cluster (d) (BASELINE config 3 at 10 000 x
     5 000: topology spread and inter-pod affinity), K9 sig_match, K10
     pair_counts, K11 pairwise_batch and K4's pairwise variant against
     their plain versions, exactly (the scan: assignment, chosen, used
     and the final pair state); and, on the arguments of their first
     call in a fast solve of (d), K12 waterfill, K13 (excess_min,
     excess_survive), K14 ia_ok_at_choice, K10's pair_commit, K8's
     node_add, K7 in fixed point, K11 with ia_ok and K5 with the
     relaxed output;
  4. main-path phases, each with every launch counter zeroed just
     before and read just after, requiring each of its kernels to
     launch:
     - parity: `Engine.solve` at 10 000 pods x 5 000 nodes on (a) the
       headline config-2 cluster, (b) the same size with constraints,
       (c) the headline with the seeded tie-break (K1-K4);
     - fast: the same three requests with mode="fast" (K5-K8), and
       (b) once more with the plain versions on the host's CPU, which
       must place as many pods as the card;
     - ScoreBatch: `Engine.score`, `score_top1` and `score_topk(k=8)`
       on (b) (K5, K6);
     - pairwise parity: `Engine.solve` on (d), on (d) with the seeded
       tie-break, and on (e) = (d) plus running anti-affinity holders,
       three namespaces (`*` and explicit scopes) and key-less nodes
       (K1-K3, K9, K10, K4's pairwise variant);
     - pairwise ScoreBatch: `score_top1` and `score_topk(k=8)` on (d),
       `score_top1` on (e) (K1-K3, K9-K11, K5, K6);
     - fast pairwise: `Engine.solve` in fast mode on (d), (d) with the
       seeded tie-break and (e) (K1-K3, K9, K10 and its commit entry
       point, K11, K5, K6, K7 in fixed point, K8 and its node_add,
       K12-K14), then (d) with compact_cap=0 (full-width rounds only),
       which must equal the compacted solve, and (d) once more with the
       plain versions on the host's CPU, which must place as many pods
       as the card;
     after each solve a validity audit (no node over capacity, every
     placed pod's static mask true at its node, no padded pod placed)
     and equality with the same solve through the plain versions on
     the same CUDA tensors; for (d) and (e) also a pairwise audit: the
     plain scan's final pair state equals K10's recount at the final
     assignment bitwise, no placed holder of a required anti term
     shares its domain with another matching member, and no placed pod
     sits in a domain holding a required anti term that matches it; for
     the fast pairwise solves the same audit of the plain solve's final
     pair state and, in numpy, the commit-key audit: every placed pod's
     DoNotSchedule skew and required inter-pod terms hold against K10's
     recount of the pods committed at its key or before, itself left
     out; each ScoreBatch result equal to its plain version;
     - gangs (BASELINE config 4, 2 500 groups of 4): `Engine.solve` in
       parity and fast mode on (f) 5 000 nodes and (g) 1 000 nodes (the
       gang gate's K8 node_add besides each path's kernels), each with
       the audit, equality with its plain solve and a gang audit (no
       group placed in part; the plain solve's rolled-back pods
       unplaced; (g) must roll back a group);
     - preemption (BASELINE config 5 at 10 000 x 5 000, 90 % tight, a
       third of the running pods under PodDisruptionBudgets): parity
       `Engine.solve` with preemption=True on (h) (K1-K3, K4's
       preemption variant, which runs K15's victim search inside the
       scan), the audit, equality with its plain solve (evictions
       included) and a preemption audit (final usage = usage - evicted
       victims + placed pods, in f64; victims only from nodes a
       preempted pod took; no gang member preempts; at least one
       eviction); then K4's preemption variant against that plain scan,
       K15 against its plain version at the scan's state at (h)'s first
       8 preemptors (with the violation counts K15 leaves in its scratch
       equal to the plain tableau's; at least one PDB violation among
       them), and K4's pairwise preemption variant on (h) with spread
       and inter-pod terms, all exact;
     - fast preemption: `Engine.solve` with mode="fast",
       preemption=True on (h) and on (h) with spread and inter-pod
       terms (the main rounds' kernels, then the auction rounds: K17's
       auction_ok, K16 auction_tables, K17 auction_rank, K6 at K = 256,
       K18 auction_claim, K8's node_add; with signatures also K11, K10,
       K14 and K13 in the rounds' validation), each once and then 5
       steady solves (median) with a stage breakdown, the audit,
       equality with its plain solve (evictions and host reads
       included), the commit-key audit in both eviction arms (every
       eviction applied, none; a pairwise violation counts only in
       both), the preemption audit (with signatures the victims of each
       round on nodes its kept eviction bids claimed, and the victims
       a reverted preemptor stranded counted) and at least one
       eviction; then the auction kernels against their plain versions
       on the arguments of each cell's first auction round, exactly,
       timed with CUDA events and the profiler's kernel time, K6 at
       K = 256 beside torch.topk;
  5. prints per-stage time breakdowns of one steady parity and one
     steady fast solve (with the host-clock cost of the dealing
     prefixes in three forms), of one steady pairwise parity solve and
     one steady fast pairwise solve on (d), a JSON line with every
     kernel's numbers, and, last, the device JSON line.

Any failure raises and the exit code is not 0. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.engine import (
    Engine,
    _pack_solve,
    _sat_tables,
    score_core,
    score_top1_core,
    score_topk_core,
    solve_core,
)
from tpusched_torch.kernels import assign as kassign
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.kernels.atoms import atom_sat, atom_sat_plain
from tpusched_torch.qos import effective_priority, effective_weights, pressure_of
from tpusched_torch.synth import (
    config2_scale,
    config3_pairwise,
    config4_gangs,
    config5_preemption,
)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit): HBM3
# bandwidth and the f32 rate outside the tensor cores. None of these
# kernels uses the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PODS, NODES, SEED = 10_000, 5_000, 42
CONSTRAINED = dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.05)
# Cell (d) is the JAX bench's pairwise snapshot (seed 43); (e) adds
# running anti-affinity holders, namespace scopes and key-less nodes.
PAIR_SEED = 43
PAIR_EXTRA = dict(run_anti_frac=0.1, namespace_count=3, keyless_node_frac=0.05)
# Cells (f) and (g) are BASELINE config 4, 2 500 gangs of 4 (seed 44) on
# the JAX bench's 5 000 nodes and on the generator's own 1 000; (h) is
# config 5 at 10 000 x 5 000 (seed 45), the JAX bench's preemption
# snapshot, solved with preemption=True. (h) with spread and inter-pod
# terms drives K4's pairwise preemption variant in the kernel phase.
GANG_SEED, PRE_SEED = 44, 45
GANGS = dict(n_groups=2500, gang_size=4)
PRE_PAIR = dict(spread_frac=0.3, interpod_frac=0.3)
K15_STATES = 8   # (h)'s first preemptors, in pop order

# (name, wrapper, its launch counter, source, the JAX function it
# replaces). A variant of a kernel (K5's relaxed output, K7's fixed point,
# K11's ia_ok) has a row of its own, counted by its own counter on the
# wrapper; the wrapper's `launches` counts every launch.
KERNELS = (
    ("atom_sat", atom_sat, "launches", "tpusched_torch/csrc/atoms.cu",
     "tpusched/kernels/atoms.py:29"),
    ("tableau_cells", kassign._tableau_cells, "launches",
     "tpusched_torch/csrc/tableau.cu", "tpusched/kernels/assign.py:110"),
    ("finalize_static", kassign.finalize_score, "launches",
     "tpusched_torch/csrc/finalize.cu", "tpusched/kernels/assign.py:233"),
    ("parity_scan", kassign.parity_scan, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/assign.py:426"),
    ("cycle", kassign.cycle, "launches", "tpusched_torch/csrc/cycle.cu",
     "tpusched/kernels/assign.py:265"),
    ("row_topk", kassign.row_topk, "launches", "tpusched_torch/csrc/topk.cu",
     "tpusched/kernels/assign.py:854"),
    ("desirability", kassign.desirability, "launches",
     "tpusched_torch/csrc/deal.cu", "tpusched/kernels/assign.py:793"),
    ("prefix_commit", kassign.prefix_commit, "launches",
     "tpusched_torch/csrc/commit.cu", "tpusched/kernels/assign.py:894"),
    ("sig_match", kpair.sig_match, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:85"),
    ("pair_counts", kpair.pair_counts, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:145"),
    ("pairwise_batch", kpair.pairwise_batch, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:342"),
    ("parity_scan_pair", kassign.parity_scan_pair, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/pairwise.py:504"),
    ("waterfill", kassign.waterfill, "launches",
     "tpusched_torch/csrc/waterfill.cu", "tpusched/kernels/assign.py:563"),
    ("excess_min", kassign.excess_min, "launches",
     "tpusched_torch/csrc/excess.cu", "tpusched/kernels/assign.py:1093"),
    ("excess_survive", kassign.excess_survive, "launches",
     "tpusched_torch/csrc/excess.cu", "tpusched/kernels/assign.py:1147"),
    ("ia_ok_at_choice", kpair.ia_ok_at_choice, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:434"),
    ("pair_commit", kpair.pair_commit, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:174"),
    ("node_add", kassign.node_add, "launches",
     "tpusched_torch/csrc/commit.cu", "tpusched/kernels/assign.py:701"),
    ("desirability_fixed", kassign.desirability, "fixed_launches",
     "tpusched_torch/csrc/deal.cu", "tpusched/kernels/assign.py:799"),
    ("pairwise_batch_ia_ok", kpair.pairwise_batch, "ia_ok_launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/assign.py:297"),
    ("cycle_relaxed", kassign.cycle, "relaxed_launches",
     "tpusched_torch/csrc/cycle.cu", "tpusched/kernels/assign.py:306"),
    ("preempt_step", kpre.preempt_step, "launches",
     "tpusched_torch/csrc/preempt.cu", "tpusched/kernels/preempt.py:317"),
    ("parity_scan_preempt", kassign.parity_scan_preempt, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/assign.py:408"),
    ("parity_scan_pair_preempt", kassign.parity_scan_pair_preempt,
     "launches", "tpusched_torch/csrc/scan.cu",
     "tpusched/kernels/pairwise.py:240"),
    ("auction_tables", kpre.auction_tables, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:488"),
    ("auction_ok", kpre.auction_ok, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:443"),
    ("auction_rank", kpre.auction_rank, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:511"),
    ("row_topk_k256", kassign.row_topk, "wide_launches",
     "tpusched_torch/csrc/topk.cu", "tpusched/kernels/preempt.py:563"),
    ("auction_claim", kpre.auction_claim, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:588"),
)
# Kernels whose counters the main path leaves at 0, and why; each is
# held against its plain version at full size in the kernel phase.
OFF_PATH = {
    "preempt_step": "K15's standalone entry point; the main path runs K15 "
                    "as a device function inside parity_scan_preempt",
    "parity_scan_pair_preempt": "no parity cell has both signatures and "
                                "preemption",
}
PARITY_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                  "parity_scan")
PAIR_PARITY_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                       "sig_match", "pair_counts", "parity_scan_pair")
PAIR_SCORE_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                      "sig_match", "pair_counts", "pairwise_batch", "cycle",
                      "row_topk")
# Kernels an entry-point call launches at most once (K1 twice with
# signatures: node labels, then member labels).
ONCE = ("tableau_cells", "finalize_static", "parity_scan", "sig_match",
        "pair_counts", "pairwise_batch", "parity_scan_pair",
        "parity_scan_preempt", "parity_scan_pair_preempt")
FAST_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                "row_topk", "desirability", "prefix_commit")
FAST_PAIR_KERNELS = FAST_KERNELS + (
    "sig_match", "pair_counts", "pairwise_batch", "waterfill", "excess_min",
    "excess_survive", "ia_ok_at_choice", "pair_commit", "node_add",
    "desirability_fixed", "pairwise_batch_ia_ok", "cycle_relaxed")
FAST_PAIR_ONCE = ("tableau_cells", "finalize_static", "sig_match",
                  "pair_counts")
SCORE_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                 "row_topk")
# The gang gate reverts through K8's node_add.
GANG_PARITY_KERNELS = PARITY_KERNELS + ("node_add",)
GANG_FAST_KERNELS = FAST_KERNELS + ("node_add",)
PREEMPT_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                   "parity_scan_preempt")
# Fast mode with preemption: the main rounds, then the auction rounds
# (K16-K18, K6 at K = 256, the plain commits' node_add).
AUCTION_KERNELS = ("node_add", "auction_tables", "auction_ok",
                   "auction_rank", "row_topk_k256", "auction_claim")
FAST_PREEMPT_KERNELS = FAST_KERNELS + AUCTION_KERNELS
FAST_PREEMPT_PAIR_KERNELS = FAST_PAIR_KERNELS + AUCTION_KERNELS[1:]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_clock_ms(fn, reps: int) -> float:
    """Host-clock ms per call of fn() over `reps` back-to-back calls
    (synchronised at both ends), after one warm-up call: what a
    launch-bound loop pays for it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over positions where both are finite (0 for bool
    and int outputs that agree); infinities must sit at the same
    places."""
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    a64, b64 = a.double(), b.double()
    if not torch.equal(torch.isfinite(a64), torch.isfinite(b64)):
        return float("inf")
    fin = torch.isfinite(a64)
    if not bool(torch.equal(a64[~fin], b64[~fin])):
        return float("inf")
    return float((a64[fin] - b64[fin]).abs().max().item()) if fin.any() else 0.0


def require_equal(name: str, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        err = max(err, max_abs_err(g, w))
        if not torch.equal(g, w):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max abs err {max_abs_err(g, w)})")
    return err


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_result(cfg: EngineConfig, dsnap, ops=kassign.PLAIN, stats=None):
    """The whole solve (either mode) through the plain versions only, on
    the snapshot's device: no kernel launches."""
    buf = _pack_solve(solve_core(cfg, dsnap, ops=ops, stats=stats))
    return Engine.unpack(dsnap, buf.cpu().numpy())


def audit(name: str, cfg: EngineConfig, dsnap, res, hook=None) -> dict:
    """Validity of one solve result, then equality with the plain solve
    on the same CUDA tensors (host reads too, in fast mode); with
    signatures also the pairwise audit of the plain solve's final pair
    state (parity: the plain scan's, with its time; fast: the last
    state the rounds' commits and reverts left) and the commit-key
    audit (with preemption, in both eviction arms). hook(ops) may wrap
    the plain solve's ops table to record calls."""
    plain = kassign.PLAIN
    static = kassign.precompute_static(cfg, dsnap, *_sat_tables(dsnap, plain),
                                       ops=plain)
    mask = static.mask.cpu().numpy()
    pvalid = dsnap.pods.valid.cpu().numpy()
    alloc = dsnap.nodes.allocatable.cpu().numpy()
    a = res.assignment
    placed = a >= 0
    if (placed & ~pvalid).any():
        raise AssertionError(f"{name}: a padded pod was placed")
    hit = np.zeros(alloc.shape[0], bool)
    hit[a[placed]] = True
    over = (res.final_used[hit] > alloc[hit]).any(axis=1)
    if over.any():
        raise AssertionError(f"{name}: {int(over.sum())} nodes over capacity")
    if not mask[np.nonzero(placed)[0], a[placed]].all():
        raise AssertionError(f"{name}: a pod was placed where its static "
                             "mask is false")
    # A preempted placement carries chosen = -inf (no rescore).
    if not cfg.preemption and not np.isfinite(res.chosen_score[placed]).all():
        raise AssertionError(f"{name}: a placed pod has no finite score")
    P = a.shape[0]
    if sorted(res.order.tolist()) != list(range(P)):
        raise AssertionError(f"{name}: order is not a permutation")
    info = {"placed": int(placed.sum()), "valid_pods": int(pvalid.sum())}
    pstats = kassign.RoundStats()
    scans, states, pre_scans = [], [], []

    def record(*args):
        t0 = time.perf_counter()
        out = kassign.parity_scan_pair_plain(*args)
        torch.cuda.synchronize()
        scans.append((args, out[3], (time.perf_counter() - t0) * 1e3))
        return out

    def last_state(*args):
        out = kpair.pair_commit_plain(*args)
        states[:] = [out]
        return out

    def record_pre(*args):
        t0 = time.perf_counter()
        out = kassign.parity_scan_preempt_plain(*args)
        torch.cuda.synchronize()
        pre_scans.append((args, out, (time.perf_counter() - t0) * 1e3))
        return out

    ops = dataclasses.replace(
        plain, parity_scan_pair=record, pair_commit=last_state,
        parity_scan_preempt=record_pre)
    t0 = time.perf_counter()
    want = plain_result(cfg, dsnap, hook(ops) if hook else ops, pstats)
    info["plain_solve_ms"] = (time.perf_counter() - t0) * 1e3
    for field in ("assignment", "order", "chosen_score", "commit_key",
                  "final_used", "evicted", "rounds"):
        got, exp = getattr(res, field), getattr(want, field)
        if not np.array_equal(got, exp):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "solve on the same CUDA tensors")
    if cfg.mode == "fast" and res.host_reads != pstats.host_reads:
        raise AssertionError(f"{name}: {res.host_reads} host reads, the "
                             f"plain solve {pstats.host_reads}")
    dom_s = kpair.sig_domains(dsnap)
    if scans:
        info.update(pair_audit(name, dsnap, res, static.sig_match, dom_s,
                               scans[0][1]))
        info["plain_scan_ms"] = scans[0][2]
    if states:
        info.update(pair_audit(name, dsnap, res, static.sig_match, dom_s,
                               states[0]))
    fast_pre = cfg.mode == "fast" and cfg.preemption
    if states or fast_pre:
        info.update(commit_key_audit(name, dsnap, res, static, dom_s,
                                     res.evicted if fast_pre else None))
    if pre_scans:
        info["plain_preempt_scan"] = pre_scans[0]
    return info


def gang_audit(name: str, dsnap, res, rolled: np.ndarray) -> dict:
    """Every pod group has no placed member or at least min_member; the
    pods the plain solve's gang gate rolled back are unplaced."""
    group = dsnap.pods.group.cpu().numpy()
    gmin = dsnap.group_min_member.cpu().numpy()
    placed = res.assignment >= 0
    cnt = np.bincount(group[placed & (group >= 0)], minlength=gmin.shape[0])
    partial = (cnt > 0) & (cnt < gmin)
    if partial.any():
        raise AssertionError(f"{name}: {int(partial.sum())} pod groups are "
                             "placed in part")
    if placed[rolled].any():
        raise AssertionError(f"{name}: a rolled-back pod is placed")
    return {"groups": int((gmin > 0).sum()),
            "groups_placed": int((cnt > 0).sum()),
            "rolled_pods": int(rolled.sum()),
            "rolled_groups": int(np.unique(group[rolled]).shape[0])}


def preempt_audit(name: str, dsnap, res, rounds=None) -> dict:
    """final_used equals the snapshot's usage less the evicted victims'
    requests plus the placed pods' (recomputed in f64, rtol 1e-6 of each
    node's capacity); evicted victims are valid running pods on nodes
    where a preempted pod landed; no preempted pod (placed with chosen =
    -inf) belongs to a gang. rounds (fast preemption with signatures,
    where the end-of-round validation may revert a preemptor and leave
    its victims evicted): [(evicted before, kept eviction bids, their
    claimed nodes, evicted after)] of each auction round of the plain
    solve; the victims of a round must sit on nodes that round's kept
    eviction bids claimed, in place of the landing clause, whose misses
    are counted as stranded victims."""
    run, pods, nodes = dsnap.running, dsnap.pods, dsnap.nodes
    a, ev = res.assignment, res.evicted
    placed = a >= 0
    rnode = run.node_idx.cpu().numpy()
    if not (run.valid.cpu().numpy()[ev].all() and (rnode[ev] >= 0).all()):
        raise AssertionError(f"{name}: an evicted victim is not a running "
                             "pod on a node")
    want = nodes.used.cpu().numpy().astype(np.float64)
    np.subtract.at(want, rnode[ev], run.requests.cpu().numpy()[ev])
    np.add.at(want, a[placed], pods.requests.cpu().numpy()[placed])
    alloc = nodes.allocatable.cpu().numpy().astype(np.float64)
    off = np.abs(res.final_used - want) > 1e-6 * np.maximum(alloc, 1.0)
    if off.any():
        raise AssertionError(f"{name}: final_used differs from the usage "
                             f"less evictions plus placements at "
                             f"{int(off.sum())} entries")
    preempted = placed & ~np.isfinite(res.chosen_score)
    group = pods.group.cpu().numpy()
    if (group[preempted] >= 0).any():
        raise AssertionError(f"{name}: a gang member was placed by "
                             "preemption")
    landed = np.isin(rnode, a[preempted])
    stranded = int((ev & ~landed).sum())
    if rounds is None and stranded:
        raise AssertionError(f"{name}: a victim was evicted from a node no "
                             "preempted pod took")
    if rounds is not None:
        union = np.zeros_like(ev)
        for before, keep, target, after in rounds:
            new = (after & ~before).cpu().numpy()
            claimed = target[keep].cpu().numpy()
            if not np.isin(rnode[new], claimed).all():
                raise AssertionError(f"{name}: a victim was evicted from a "
                                     "node no kept eviction bid of its round "
                                     "claimed")
            union |= new
        if not np.array_equal(union, ev):
            raise AssertionError(f"{name}: the rounds' evictions are not "
                                 "the solve's")
    pvalid = pods.valid.cpu().numpy()
    return {"evicted": int(ev.sum()), "preempted": int(preempted.sum()),
            "stranded": stranded,
            "searches": int(preempted.sum()
                            + (pvalid & (group < 0) & ~placed).sum())}


def pair_audit(name: str, dsnap, res, sig_match, dom_s, final) -> dict:
    """The pairwise audit of a solve with signatures from the final pair
    state of its plain solve (already equal in assignment to `res`):
    that state equals K10's recount at the assignment (bitwise), and
    the required anti-affinity terms hold in the final placement both
    ways (numpy, from the recount)."""
    asg_t = torch.from_numpy(res.assignment).to(dom_s.device)
    rec = kpair.pair_counts(sig_match, dom_s, dsnap.running, dsnap.pods,
                            assigned=asg_t)
    for field in ("counts", "anti", "match_tot"):
        if not torch.equal(getattr(rec, field), getattr(final, field)):
            raise AssertionError(f"{name}: the solve's final {field} differs "
                                 "from K10's recount at the assignment")
    match = sig_match.cpu().numpy()
    dom = dom_s.cpu().numpy()
    counts, anti = rec.counts.cpu().numpy(), rec.anti.cpu().numpy()
    pods = dsnap.pods
    ia_sig = pods.ia_sig.cpu().numpy()
    holds = kpair.pod_anti_holds(pods).cpu().numpy()
    M = dsnap.running.valid.shape[0]
    S = dom.shape[0]
    asg = res.assignment
    placed = np.nonzero(asg >= 0)[0]
    mine = match[:, M + placed]                              # [S, Q]
    own = np.zeros((S, asg.shape[0]), np.int64)              # own holds
    holders = 0
    for t in range(ia_sig.shape[1]):
        sel = placed[holds[placed, t]]
        holders += sel.shape[0]
        np.add.at(own, (ia_sig[sel, t], sel), 1)
        s = ia_sig[sel, t]
        d = dom[s, asg[sel]]
        keyed = d >= 0
        others = (counts[s, np.maximum(d, 0)]
                  - match[s, M + sel].astype(np.float32))
        bad = keyed & (others != 0)
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} placed holders of a required "
                "anti term share their domain with a matching member")
    d_all = dom[:, asg[placed]]                              # [S, Q]
    held = np.take_along_axis(anti, np.maximum(d_all, 0), axis=1)
    others = held - own[:, placed]
    bad = mine & (d_all >= 0) & (others != 0)
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.any(axis=0).sum())} placed pods sit in a "
            "domain holding a required anti term that matches them")
    return {"anti_holders": holders, "signatures": S}


def commit_key_audit(name: str, dsnap, res, static, dom_s,
                     evicted: np.ndarray | None = None) -> dict:
    """The fast mode's contract (the JAX package's validate_assignment
    with the commit key, in numpy): every placed pod's DoNotSchedule
    spread skew, required inter-pod terms and the symmetric anti-affinity
    of the members hold against K10's recount of the pods whose commit
    key is at most its own, the pod itself left out. With `evicted` (fast
    preemption) the capacity holds with every eviction applied, and, as
    validate_assignment does without the evictions' timing, a pairwise
    violation counts only if it holds in both arms: the evicted running
    members counted, and left out."""
    pods, nodes = dsnap.pods, dsnap.nodes
    M = dsnap.running.valid.shape[0]
    asg, key = res.assignment, res.commit_key
    S = dom_s.shape[0]
    info = {"signatures": S}
    if evicted is not None:
        run = dsnap.running
        use = nodes.used.cpu().numpy().astype(np.float64)
        np.subtract.at(use, run.node_idx.cpu().numpy()[evicted],
                       run.requests.cpu().numpy()[evicted])
        np.add.at(use, asg[asg >= 0], pods.requests.cpu().numpy()[asg >= 0])
        over = (use > nodes.allocatable.cpu().numpy() + 1e-3).any(axis=1)
        if (over & nodes.valid.cpu().numpy()).any():
            raise AssertionError(f"{name}: {int(over.sum())} nodes over "
                                 "capacity with the evictions applied")
    if S == 0:
        return info
    match = static.sig_match.cpu().numpy()
    dom = dom_s.cpu().numpy()
    aff_ok = static.aff_ok.cpu().numpy()
    nvalid = nodes.valid.cpu().numpy()
    ts_sig, ts_valid, ts_when, ts_skew = (
        t.cpu().numpy() for t in (pods.ts_sig, pods.ts_valid, pods.ts_when,
                                  pods.ts_max_skew))
    ia_sig, ia_valid, ia_anti, ia_req = (
        t.cpu().numpy() for t in (pods.ia_sig, pods.ia_valid, pods.ia_anti,
                                  pods.ia_required))
    holds = kpair.pod_anti_holds(pods).cpu().numpy()
    ev_t = (torch.from_numpy(evicted).to(dom_s.device)
            if evicted is not None and evicted.any() else None)

    def violations(st, ps) -> np.ndarray:
        counts, anti = st.counts.cpu().numpy(), st.anti.cpu().numpy()
        mtot = st.match_tot.cpu().numpy()
        ns = asg[ps]
        bad = np.zeros(ps.shape[0], bool)
        for c in range(ts_sig.shape[1]):
            s = np.maximum(ts_sig[ps, c], 0)
            dp = dom[s]                                      # [Q, N]
            d = dp[np.arange(ps.shape[0]), ns]
            self_in = match[s, M + ps] & (d >= 0)
            excl = (np.take_along_axis(counts[s], np.maximum(dp, 0), axis=1)
                    - (self_in[:, None] & (dp == d[:, None])))
            elig = nvalid[None, :] & aff_ok[ps] & (dp >= 0)
            lo = np.where(elig, excl, np.inf).min(axis=1)
            lo = np.where(np.isfinite(lo), lo, 0.0)
            nc = excl[np.arange(ps.shape[0]), ns]
            ok = (d >= 0) & (nc + 1.0 - lo <= ts_skew[ps, c])
            bad |= ts_valid[ps, c] & (ts_when[ps, c] == 0) & ~ok
        own = np.zeros(ps.shape[0], np.int64)
        for t in range(ia_sig.shape[1]):
            s = np.maximum(ia_sig[ps, t], 0)
            d = dom[s, ns]
            self_m = match[s, M + ps]
            hk = d >= 0
            nc = counts[s, np.maximum(d, 0)] - (self_m & hk)
            node_has = hk & (nc > 0)
            all_zero = mtot[s] - self_m <= 0
            ok = np.where(ia_anti[ps, t], ~node_has,
                          node_has | (all_zero & self_m & hk))
            bad |= ia_valid[ps, t] & ia_req[ps, t] & ~ok
            own += holds[ps, t] & self_m & hk
        d_all = dom[:, ns]                                   # [S, Q]
        held = np.where(d_all >= 0, np.take_along_axis(
            anti, np.maximum(d_all, 0), axis=1), 0.0).astype(np.int64)
        return bad | ((match[:, M + ps] * held).sum(axis=0) - own > 0)

    checked = one_arm = 0
    for k in np.unique(key[asg >= 0]):
        upto = np.where((asg >= 0) & (key <= k), asg, -1).astype(np.int32)
        st = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods,
                               assigned=torch.from_numpy(upto).to(
                                   dom_s.device))
        ps = np.nonzero((asg >= 0) & (key == k))[0]
        bad = violations(st, ps)
        if ev_t is not None:
            bad_ev = violations(kpair.pair_state_evict(
                dsnap, st, static.sig_match, dom_s, ev_t), ps)
            one_arm += int((bad ^ bad_ev).sum())
            bad = bad & bad_ev
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} pods committed at key {k} violate "
                "a spread or required inter-pod term against the pods "
                "committed up to their key")
        checked += ps.shape[0]
    info.update(commit_key_checked=checked, keys=int(np.unique(
        key[asg >= 0]).shape[0]))
    if ev_t is not None:
        info["one_arm_only"] = one_arm
    return info


def counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr, _, _ in KERNELS}


def zero_counts() -> None:
    for _, fn, attr, _, _ in KERNELS:
        setattr(fn, attr, 0)


def pair_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K9-K11 and K4's pairwise variant against their plain versions on
    the full-size pairwise cell, with times and bounds."""
    nodes, pods = dsnap.nodes, dsnap.pods
    out = {}
    node_sat_t, member_sat_t = _sat_tables(dsnap)
    member_ns = kpair.merge_members(dsnap.running.namespace, pods.namespace)
    # K9
    args9 = (member_sat_t, dsnap.sigs, member_ns)
    sm = kpair.sig_match(*args9)
    err = require_equal("sig_match", [sm], [kpair.sig_match_plain(*args9)])
    A, X = member_sat_t.shape
    S, AT = dsnap.sigs.atoms.shape
    NS = dsnap.sigs.ns.shape[1]
    b9 = nbytes(member_sat_t, *vars(dsnap.sigs).values(), member_ns, sm)
    out["sig_match"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.sig_match(*args9), 20),
        plain_ms=cuda_ms(lambda: kpair.sig_match_plain(*args9), 5),
        bound=bound(b9, S * X * (AT + NS + 2)),
        shape=f"S={S} X={X} A={A} AT={AT} NS={NS}")
    # K10
    static = kassign.precompute_static(cfg, dsnap, node_sat_t, member_sat_t)
    order = kassign.pop_order(cfg, dsnap)
    dom_s = kpair.sig_domains(dsnap)
    run = dsnap.running
    args10 = (static.sig_match, dom_s, run, pods)
    st = kpair.pair_counts(*args10)
    want = kpair.pair_counts_plain(*args10)
    err = require_equal("pair_counts", [st.counts, st.anti, st.match_tot],
                        [want.counts, want.anti, want.match_tot])
    J, IT = run.anti_sig.shape[1], pods.ia_sig.shape[1]
    M, P = run.valid.shape[0], pods.valid.shape[0]
    N = nodes.valid.shape[0]
    b10 = nbytes(static.sig_match, dom_s, run.node_idx, run.valid,
                 run.anti_sig, pods.ia_sig, pods.ia_valid, pods.ia_anti,
                 pods.ia_required, st.counts, st.anti, st.match_tot)
    out["pair_counts"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.pair_counts(*args10), 20),
        plain_ms=cuda_ms(lambda: kpair.pair_counts_plain(*args10), 5),
        bound=bound(b10, S * X * 3 + M * J + P * IT),
        shape=f"S={S} N={N} M={M} P={P} J={J} IT={IT}",
        counted=float(st.counts.sum().item()))
    # K11
    args11 = (dsnap, st, static.aff_ok, static.sig_match, dom_s)
    got = kpair.pairwise_batch(*args11)
    err = require_equal("pairwise_batch", got,
                        kpair.pairwise_batch_plain(*args11))
    C = pods.ts_sig.shape[1]
    b11 = nbytes(static.aff_ok, nodes.valid, dom_s, static.sig_match,
                 pods.ts_sig, pods.ts_valid, pods.ts_when, pods.ts_max_skew,
                 pods.ia_sig, pods.ia_valid, pods.ia_anti, pods.ia_required,
                 pods.ia_weight, st.counts, st.anti, st.match_tot, *got)
    cell_ops = C * 6 + IT * 10 + S * 3 + 14
    out["pairwise_batch"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.pairwise_batch(*args11), 10),
        plain_ms=cuda_ms(lambda: kpair.pairwise_batch_plain(*args11), 3),
        bound=bound(b11, P * N * cell_ops),
        shape=f"P={P} N={N} S={S} C={C} IT={IT}",
        pair_ok=int(got[0].sum().item()))
    # K4's pairwise variant, exact in all four outputs (the final pair
    # state included); the plain scan is timed once (tens of seconds).
    R = nodes.allocatable.shape[1]
    args4 = (cfg, dsnap, static, order, st, dom_s)
    scan = kassign.parity_scan_pair(*args4)
    t0 = time.perf_counter()
    want = kassign.parity_scan_pair_plain(*args4)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    flat = lambda r: [r[0], r[1], r[2], r[3].counts, r[3].anti,
                      r[3].match_tot]
    err = require_equal("parity_scan_pair", flat(scan), flat(want))
    b4 = nbytes(static.mask, static.score, static.aff_ok, nodes.allocatable,
                nodes.used, pods.requests, static.w_lr, static.w_ba,
                static.w_ts, static.w_ia, static.rw, dom_s, static.sig_match,
                st.counts, st.anti, st.match_tot, *flat(scan)) + 4 * P
    out["parity_scan_pair"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.parity_scan_pair(*args4), 3),
        plain_ms=plain_ms,
        bound=bound(b4, P * N * (R * 14 + 12 + cell_ops)),
        shape=f"P={P} N={N} R={R} S={S} C={C} IT={IT}",
        placed=int((scan[0] >= 0).sum().item()))
    return out


def kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """Each kernel against its plain version on the same CUDA tensors,
    with times and bounds."""
    nodes, pods = dsnap.nodes, dsnap.pods
    out = {}
    # K1
    args1 = (dsnap.atoms, nodes.label_pairs, nodes.label_keys,
             nodes.label_nums)
    sat_k = atom_sat(*args1)
    sat_p = atom_sat_plain(*args1)
    err = require_equal("atom_sat", [sat_k], [sat_p])
    X, L = nodes.label_pairs.shape
    A, V = dsnap.atoms.pairs.shape
    b1 = nbytes(nodes.label_pairs, nodes.label_keys, nodes.label_nums,
                *vars(dsnap.atoms).values(), sat_k)
    out["atom_sat"] = dict(
        err=err, ms=cuda_ms(lambda: atom_sat(*args1), 20),
        plain_ms=cuda_ms(lambda: atom_sat_plain(*args1), 5),
        bound=bound(b1, X * A * L * (V + 3)), shape=f"X={X} L={L} A={A} V={V}")
    node_sat_t = sat_k.T.contiguous()
    # K2
    args2 = (dsnap, pods, nodes, node_sat_t)
    cells_k = kassign._tableau_cells(*args2)
    cells_p = kassign._tableau_cells_plain(*args2)
    err = require_equal("tableau_cells", cells_k, cells_p)
    P, N = cells_k[0].shape
    T, AT = pods.req_term_atoms.shape[1:]
    PT, TN = pods.pref_term_atoms.shape[1], nodes.taint_ids.shape[1]
    b2 = nbytes(node_sat_t, pods.req_term_atoms, pods.req_term_valid,
                pods.pref_term_atoms, pods.pref_term_valid,
                pods.pref_weight, nodes.taint_ids, dsnap.taint_effect,
                pods.tolerated, nodes.schedulable, nodes.valid,
                pods.tolerates_unsched, pods.valid, *cells_k)
    ops2 = P * N * ((T + PT) * (AT + 1) + 3 * TN + 6)
    out["tableau_cells"] = dict(
        err=err, ms=cuda_ms(lambda: kassign._tableau_cells(*args2), 10),
        plain_ms=cuda_ms(lambda: kassign._tableau_cells_plain(*args2), 5),
        bound=bound(b2, ops2), shape=f"P={P} N={N} T={T} AT={AT} PT={PT} "
                                     f"TN={TN}")
    # K3
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    args3 = (cells_k[2], cells_k[3], nodes.valid, w["node_affinity"],
             w["taint_toleration"])
    score_k = kassign.finalize_score(*args3)
    score_p = kassign.finalize_score_plain(*args3)
    err = require_equal("finalize_static", [score_k], [score_p])
    b3 = nbytes(*args3, score_k)
    out["finalize_static"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.finalize_score(*args3), 10),
        plain_ms=cuda_ms(lambda: kassign.finalize_score_plain(*args3), 5),
        bound=bound(b3, P * N * 12), shape=f"P={P} N={N}")
    # K4
    static = kassign.finalize_static(cfg, dsnap, *cells_k)
    order = kassign.pop_order(cfg, dsnap)
    scan_k = kassign.parity_scan(cfg, dsnap, static, order)
    # The plain scan is timed once, on the call compared (~17 s).
    t0 = time.perf_counter()
    scan_p = kassign.parity_scan_plain(cfg, dsnap, static, order)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = require_equal("parity_scan", scan_k, scan_p)
    R = nodes.allocatable.shape[1]
    b4 = nbytes(static.mask, static.score, nodes.allocatable, nodes.used,
                pods.requests, static.w_lr, static.w_ba, static.w_ts,
                static.w_ia, static.rw, *scan_k) + 4 * P
    ops4 = P * N * (R * 14 + 12)
    out["parity_scan"] = dict(
        err=err, ms=cuda_ms(
            lambda: kassign.parity_scan(cfg, dsnap, static, order), 5),
        plain_ms=plain_ms,
        bound=bound(b4, ops4), shape=f"P={P} N={N} R={R}",
        placed=int((scan_k[0] >= 0).sum().item()))
    out.update(fast_kernel_phase(cfg, dsnap, static, order))
    return out


def first_substep_args(cfg: EngineConfig, dsnap):
    """The arguments of the first prefix_commit (K8) call of a fast
    solve: the first sub-step of its first round."""
    calls = []

    def record(*args):
        if not calls:
            calls.append(args)
        return kassign.prefix_commit(*args)

    ops = dataclasses.replace(kassign.KERNELS, prefix_commit=record)
    kassign.solve_rounds(dataclasses.replace(cfg, mode="fast"), dsnap,
                         _sat_tables(dsnap)[0], ops=ops)
    return calls[0]


def fast_kernel_phase(cfg: EngineConfig, dsnap, static, order) -> dict:
    """K5-K8 against their plain versions at the shapes of ScoreBatch and
    of the first fast round."""
    nodes, pods = dsnap.nodes, dsnap.pods
    P, N = static.mask.shape
    R = nodes.allocatable.shape[1]
    out = {}
    # K5: full width (ScoreBatch), then a 1024-row view (a tranche: the
    # first 1024 pods in pop order, the even ones of them pending).
    args5 = (nodes.allocatable, nodes.used, pods.requests, static.mask,
             static.score, static.w_lr, static.w_ba, static.w_ts, static.rw)
    got = kassign.cycle(*args5)
    err = require_equal("cycle", got, kassign.cycle_plain(*args5))
    rows = order[:1024].to(torch.int32).contiguous()
    pend = pods.valid[rows.long()] & (torch.arange(
        rows.shape[0], device=rows.device) % 2 == 0)
    view_k = kassign.cycle(*args5, rows=rows, pending=pend, masked=True)
    err = max(err, require_equal("cycle (1024-row view)", view_k,
                                 kassign.cycle_plain(*args5, rows=rows,
                                                     pending=pend,
                                                     masked=True)))
    r64 = rows.long()
    gathered = (nodes.allocatable, nodes.used, pods.requests[r64].clone(),
                static.mask[r64].clone(), static.score[r64].clone(),
                static.w_lr[r64].clone(), static.w_ba[r64].clone(),
                static.w_ts[r64].clone(), static.rw)
    require_equal("cycle view vs gathered copies", view_k,
                  kassign.cycle(*gathered, pending=pend, masked=True))
    b5 = nbytes(*args5, *got)
    ops5 = P * N * (R * 14 + 12)
    view_ms = cuda_ms(lambda: kassign.cycle(*args5, rows=rows, pending=pend,
                                            masked=True), 10)
    out["cycle"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.cycle(*args5), 10),
        plain_ms=cuda_ms(lambda: kassign.cycle_plain(*args5), 3),
        bound=bound(b5, ops5), shape=f"P={P} N={N} R={R}; "
        f"{rows.shape[0]}-row view {view_ms:.4f} ms")
    # K6 on the first fast round's masked block (all valid pods pending).
    feasible, masked = kassign.cycle(*args5, pending=pods.valid, masked=True)
    K = kassign._fallback_depth(N)
    ids = torch.arange(P, dtype=torch.int32, device=masked.device)
    seed = cfg.tie_seed if cfg.tie_break == "seeded" else SEED
    args6 = (masked, K, True, seed, ids)
    top_k = kassign.row_topk(*args6)
    err = require_equal("row_topk (K=8, seeded)", top_k,
                        kassign.row_topk_plain(*args6))
    err = max(err, require_equal("row_topk (kb=8)",
                                 kassign.row_topk(masked, 8),
                                 kassign.row_topk_plain(masked, 8)))
    b6 = nbytes(masked, ids, *top_k)
    out["row_topk"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.row_topk(*args6), 10),
        plain_ms=cuda_ms(lambda: kassign.row_topk_plain(*args6), 3),
        library="torch.topk",
        library_ms=cuda_ms(lambda: torch.topk(masked, K, dim=1), 10),
        bound=bound(b6, P * N), shape=f"P={P} N={N} K={K} seeded")
    # K7 on K5's output.
    allowed = top_k[0][:, 0] > float("-inf")
    args7 = (feasible, masked, allowed)
    desir = kassign.desirability(*args7)
    err = require_equal("desirability", [desir],
                        [kassign.desirability_plain(*args7)])
    out["desirability"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.desirability(*args7), 10),
        plain_ms=cuda_ms(lambda: kassign.desirability_plain(*args7), 2),
        bound=bound(nbytes(*args7, desir), P * N), shape=f"P={P} N={N}")
    # K8 on the first sub-step of the first fast round.
    args8 = first_substep_args(cfg, dsnap)
    got8 = kassign.prefix_commit(*args8)
    err = require_equal("prefix_commit", got8,
                        kassign.prefix_commit_plain(*args8))
    perm, cand_s = args8[0], args8[1]
    active = int((cand_s < N).sum().item())
    committed = int((got8[1] >= 0).sum().item())
    b8 = nbytes(*args8[:7], *got8)
    ops8 = P * R * max(1, (P - 1).bit_length())
    out["prefix_commit"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.prefix_commit(*args8), 10),
        plain_ms=cuda_ms(lambda: kassign.prefix_commit_plain(*args8), 3),
        bound=bound(b8, ops8),
        shape=f"P={perm.shape[0]} R={R} active={active} "
              f"committed={committed}")
    return out


def first_pair_round_calls(cfg: EngineConfig, dsnap) -> dict:
    """The arguments of the first call of each fast pairwise kernel entry
    point in a fast solve of `dsnap` (its first round; node_add's first
    call that reverts anything), by kernels-line name."""
    calls = {}

    def rec(name, fn, want=lambda a, kw: True):
        def wrapped(*a, **kw):
            if name not in calls and want(a, kw):
                calls[name] = (fn, a, kw)
            return fn(*a, **kw)
        return wrapped

    k = kassign.KERNELS
    ops = dataclasses.replace(
        k, waterfill=rec("waterfill", k.waterfill),
        excess_min=rec("excess_min", k.excess_min),
        excess_survive=rec("excess_survive", k.excess_survive),
        ia_ok_at_choice=rec("ia_ok_at_choice", k.ia_ok_at_choice),
        pair_commit=rec("pair_commit", k.pair_commit),
        node_add=rec("node_add", k.node_add,
                     lambda a, kw: bool(a[2].any())),
        desirability=rec("desirability_fixed", k.desirability,
                         lambda a, kw: kw.get("fixed", False)),
        pairwise_batch=rec("pairwise_batch_ia_ok", k.pairwise_batch,
                           lambda a, kw: kw.get("with_ia_ok", False)),
        cycle=rec("cycle_relaxed", k.cycle,
                  lambda a, kw: kw.get("ia_ok") is not None))
    kassign.solve_rounds(dataclasses.replace(cfg, mode="fast"), dsnap,
                         *_sat_tables(dsnap), ops=ops)
    return calls


# Each fast pairwise entry point's plain version, by kernels-line name.
PLAIN_OF = {
    "waterfill": kassign.waterfill_plain,
    "excess_min": kassign.excess_min_plain,
    "excess_survive": kassign.excess_survive_plain,
    "ia_ok_at_choice": kpair.ia_ok_at_choice_plain,
    "pair_commit": kpair.pair_commit_plain,
    "node_add": kassign.node_add_plain,
    "desirability_fixed": kassign.desirability_plain,
    "pairwise_batch_ia_ok": kpair.pairwise_batch_plain,
    "cycle_relaxed": kassign.cycle_plain,
}


def _flat(out) -> list:
    if isinstance(out, kpair.PairState):
        return [out.counts, out.anti, out.match_tot]
    return list(out) if isinstance(out, tuple) else [out]


def fast_pair_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K12-K14 and the fast pairwise entry points of K5, K7, K8, K10 and
    K11 against their plain versions, on the arguments of their first
    call in a fast solve of the full-size pairwise cell, with times and
    bounds (bytes each input read once, each output written once; where
    a kernel gathers, only the entries it needs)."""
    calls = first_pair_round_calls(cfg, dsnap)
    out = {}
    P, N = dsnap.pods.valid.shape[0], dsnap.nodes.valid.shape[0]
    S = dsnap.sigs.key.shape[0]
    R = dsnap.nodes.allocatable.shape[1]
    IT = dsnap.pods.ia_sig.shape[1]
    for name, plain in PLAIN_OF.items():
        fn, a, kw = calls[name]
        got = _flat(fn(*a, **kw))
        want = _flat(plain(*a, **kw))
        err = require_equal(name, got, want)
        r = dict(err=err, ms=cuda_ms(lambda: fn(*a, **kw), 10),
                 plain_ms=cuda_ms(lambda: plain(*a, **kw), 3))
        if name == "waterfill":
            fill, ord_dom, dom_s, s_p, q, relaxed, cap, score, member, K1 = a
            b = nbytes(fill, ord_dom, dom_s, s_p, q, relaxed, cap, member,
                       *got) + 4 * P * K1
            r.update(bound=bound(b, 3 * P * N), shape=(
                f"P={P} N={N} S={S} K+1={K1}, {int(got[2].sum())} members "
                "dealt"))
        elif name == "excess_min":
            dom_s, counts, nvalid, aff_ok, s_c = a
            r.update(bound=bound(nbytes(*a, *got), 3 * P * N),
                     shape=f"P={P} N={N} S={S}")
        elif name == "excess_survive":
            r.update(bound=bound(nbytes(*a, *got), 4 * P),
                     shape=f"P={P}, {int(a[2].sum())} members, "
                           f"{int(got[0].sum())} bad")
        elif name == "ia_ok_at_choice":
            # Gathers: the member table's pod columns, the ia terms, and
            # counts/anti/dom at each pod's chosen node per signature.
            b = S * P + nbytes(*(getattr(a[0].pods, f) for f in (
                "ia_sig", "ia_valid", "ia_anti", "ia_required"))) \
                + 3 * 4 * S * P + nbytes(a[4], a[5], *got)
            r.update(bound=bound(b, (S + 10 * IT) * P),
                     shape=f"P={P} S={S} IT={IT}")
        elif name == "pair_commit":
            b = S * P + nbytes(a[4], a[5]) + 7 * P * IT + 2 * 4 * S * P
            r.update(bound=bound(b, (S + IT) * P),
                     shape=f"P={P} S={S}, {int(a[5].sum())} committed")
        elif name == "node_add":
            used, node, mask, req, rank, sign = a
            b = nbytes(node, mask, req, rank, used) + nbytes(*got)
            r.update(bound=bound(b, P * R), library="index_add_",
                     library_ms=cuda_ms(lambda: used.clone().index_add_(
                         0, node.clamp(min=0).long(),
                         torch.where(mask[:, None], req * sign, 0.0)), 10),
                     shape=f"P={P} N={N} R={R}, {int(mask.sum())} reverted")
        elif name == "desirability_fixed":
            r.update(bound=bound(nbytes(*a, *got), 4 * P * N),
                     shape=f"P={P} N={N}")
        elif name == "pairwise_batch_ia_ok":
            snap_v, st, aff_ok, sig_match, dom_s = a
            pods = snap_v.pods
            C = pods.ts_sig.shape[1]
            b = nbytes(aff_ok, snap_v.nodes.valid, dom_s, sig_match,
                       pods.ts_sig, pods.ts_valid, pods.ts_when,
                       pods.ts_max_skew, pods.ia_sig, pods.ia_valid,
                       pods.ia_anti, pods.ia_required, pods.ia_weight,
                       st.counts, st.anti, st.match_tot, *got)
            r.update(bound=bound(b, P * N * (C * 6 + IT * 10 + S * 3 + 14)),
                     shape=f"P={P} N={N} S={S} C={C} IT={IT}")
        elif name == "cycle_relaxed":
            b = nbytes(*a[:9], *kw["pair"], kw["w_ia"], kw["ia_ok"],
                       kw["pending"], *got)
            r.update(bound=bound(b, P * N * (R * 14 + 16)),
                     shape=f"P={P} N={N} R={R}")
        out[name] = r
    return out


def stage_breakdown(engine: Engine, snap) -> dict:
    """Device time of each stage of one parity solve (CUDA events), plus
    the host-clock transfers at both ends. With signatures the member
    label table (K1) and the signature match (K9) join the static stages
    and the pair state (K10) precedes the pairwise scan."""
    cfg = engine.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsnap = engine.put(snap)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    pairwise = dsnap.sigs.key.shape[0] > 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    ev[0].record()
    node_sat_t, member_sat_t = _sat_tables(dsnap)
    ev[1].record()
    cells = kassign._tableau_cells(dsnap, dsnap.pods, dsnap.nodes, node_sat_t)
    ev[2].record()
    static = kassign.finalize_static(cfg, dsnap, *cells)
    ev[3].record()
    if pairwise:
        static.sig_match = kpair.sig_match(
            member_sat_t, dsnap.sigs, kpair.merge_members(
                dsnap.running.namespace, dsnap.pods.namespace))
    ev[4].record()
    order = kassign.pop_order(cfg, dsnap)
    ev[5].record()
    if pairwise:
        dom_s = kpair.sig_domains(dsnap)
        st0 = kpair.pair_counts(static.sig_match, dom_s, dsnap.running,
                                dsnap.pods)
    ev[6].record()
    if pairwise:
        a, c, u, _ = kassign.parity_scan_pair(cfg, dsnap, static, order, st0,
                                              dom_s)
    else:
        a, c, u = kassign.parity_scan(cfg, dsnap, static, order)
    ev[7].record()
    P = a.shape[0]
    rank = torch.zeros(P, dtype=torch.int32, device=a.device)
    rank[order] = torch.arange(P, dtype=torch.int32, device=a.device)
    buf = _pack_solve((a, c, u, order, rank,
                       torch.full((), P, dtype=torch.int32, device=a.device),
                       torch.zeros(dsnap.running.valid.shape[0],
                                   dtype=torch.bool, device=a.device)))
    ev[8].record()
    t1 = time.perf_counter()
    buf.cpu()
    d2h_wait_ms = (time.perf_counter() - t1) * 1e3
    names = ("K1 atom_sat (+transpose)", "K2 tableau_cells",
             "K3 finalize_static (+QoS weights)", "K9 sig_match",
             "pop_order sort", "sig_domains + K10 pair_counts",
             "K4 parity_scan_pair" if pairwise else "K4 parity_scan",
             "rank + pack")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)
              if pairwise or not n.startswith(("K9", "sig_domains"))}
    return {"h2d_ms_host": h2d_ms, **stages,
            "d2h_wait_ms_host": d2h_wait_ms}


def fast_breakdown(engine: Engine, snap) -> dict:
    """Device time of one fast solve (CUDA events around solve_core and
    around each round-loop stage and kernel call inside it), the host
    reads, and the host-clock transfers at both ends."""
    cfg = engine.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsnap = engine.put(snap)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    stats = kassign.RoundStats(timing=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t1 = time.perf_counter()
    ev[0].record()
    out = solve_core(cfg, dsnap, stats=stats)
    ev[1].record()
    buf = _pack_solve(out)
    ev[2].record()
    buf.cpu()
    host_ms = (time.perf_counter() - t1) * 1e3
    spans = stats.ms()
    n = stats.counts()
    # The dealing prefixes, once per K7 call, in three forms on the
    # snapshot's [P, R] requests and [N, R] capacity: the one fixed scan
    # the solve runs, the same order as two scans, and two torch.cumsum
    # calls (f32 bits that depend on the device; timing only).
    dem, rem = dsnap.pods.requests, dsnap.nodes.allocatable
    forms = {
        "one _deal_prefixes scan": lambda: kassign._deal_prefixes(dem, rem),
        "two _scan_plain": lambda: (kassign._scan_plain(dem),
                                    kassign._scan_plain(rem)),
        "two torch.cumsum": lambda: (torch.cumsum(dem, 0),
                                     torch.cumsum(rem, 0)),
    }
    prefix = {f"dealing prefixes per call, {k} (host clock)":
              host_clock_ms(f, 20) for k, f in forms.items()}
    total = ev[0].elapsed_time(ev[1])
    loops = sum(spans.get(k, 0.0) for k in (
        "round 1", "tranches", "direct rounds", "full-width rounds",
        "compacted rounds", "preemption rounds"))
    return {"h2d_ms_host": h2d_ms, "solve_core (device)": total,
            "K1-K3 + pop_order (rest of solve_core)": total - loops,
            **{f"{k} (x{n[k]})": v for k, v in spans.items()},
            "pack": ev[1].elapsed_time(ev[2]),
            "solve_core + pack + D2H (host clock)": host_ms,
            "host_reads": stats.host_reads, "rounds": int(out[5].item()),
            **({"preemption rounds": stats.preempt_rounds,
                "preemption host reads": stats.preempt_reads}
               if cfg.preemption else {}),
            **prefix}


def check_launches(name: str, moved: dict, want: tuple[str, ...],
                   has_atoms: bool, calls: int = 1,
                   once: tuple[str, ...] = ONCE) -> None:
    """Each kernel of the path launched (K1 only with atoms to match),
    no other kernel; the set-up kernels (`once`) once per entry-point
    call (K1 twice with signatures)."""
    k1_calls = 2 if "sig_match" in want else 1
    for k, n in moved.items():
        need = k in want and (k != "atom_sat" or has_atoms)
        most = (k1_calls * calls if k == "atom_sat"
                else calls if k in once else None)
        if (need and n < 1) or (not need and n) or (most and n > most):
            raise AssertionError(f"{name}: kernel {k} launched {n} times "
                                 f"(launches {moved})")


def solve_phase(label: str, requests, want: tuple[str, ...],
                once: tuple[str, ...] = ONCE) -> tuple:
    """Drive one main path: every counter zeroed just before, read just
    after; each request must launch each kernel of the path."""
    zero_counts()
    results = []
    for name, cfg, snap in requests:
        eng = Engine(cfg)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.solve(snap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        eng.close()
        moved = {k: counts()[k] - v for k, v in before.items()}
        results.append((name, cfg, snap, res, wall_ms, moved))
    phase_counts = counts()
    for name, cfg, snap, res, wall_ms, moved in results:
        check_launches(f"{label} {name}", moved, want,
                       snap.atoms.key.shape[0] > 0, once=once)
    return results, phase_counts


def score_phase(cfg: EngineConfig, snap, smi: str) -> dict:
    """ScoreBatch through the engine (counters zeroed just before, read
    just after), then each result against its plain version."""
    zero_counts()
    eng = Engine(cfg)
    walls = {}
    t0 = time.perf_counter()
    sb = eng.score(snap)
    walls["score"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    best, mx, anyf, _ = eng.score_top1(snap)
    walls["score_top1"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    idx, val, _ = eng.score_topk(snap, 8)
    walls["score_topk(k=8)"] = (time.perf_counter() - t0) * 1e3
    phase_counts = counts()
    check_launches("ScoreBatch", phase_counts, SCORE_KERNELS,
                   snap.atoms.key.shape[0] > 0, calls=3)
    dsnap = eng.put(snap)
    plain = kassign.PLAIN
    f, sc = score_core(cfg, dsnap, ops=plain)
    pb, pm, pa = score_top1_core(cfg, dsnap, ops=plain)
    pi, pv = score_topk_core(cfg, dsnap, 8, ops=plain)
    checks = (("feasible", sb.feasible, f), ("scores", sb.scores, sc),
              ("top1 best", best, pb), ("top1 score", mx, pm),
              ("top1 feasible", anyf, pa), ("topk idx", idx, pi[:, :8]),
              ("topk val", val, pv[:, :8]))
    for field, got, want in checks:
        if not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(f"ScoreBatch {field} differs from its "
                                 "plain version on the same CUDA tensors")
    P, N = sb.feasible.shape
    if not (np.isfinite(sb.scores).all() and (best[anyf] < N).all()
            and (best[~anyf] == -1).all()):
        raise AssertionError("ScoreBatch: non-finite score or bad index")
    eng.close()
    log(f"ScoreBatch on (b) [{P}x{N}]: {int(sb.feasible.sum())} feasible "
        f"cells, {int(anyf.sum())} pods with a feasible node; walls (ms, "
        "first call each) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        walls.items())
        + f"; launches {phase_counts}; equal to the plain versions; {smi}")
    return phase_counts


def pair_score_phase(requests, smi: str) -> dict:
    """Pairwise ScoreBatch through the engine (counters zeroed just
    before, read just after): (label, cfg, snap, forms) requests, each
    form "top1" or "topk8"; then each result against its plain version
    on the same CUDA tensors."""
    zero_counts()
    results = []
    for label, cfg, snap, forms in requests:
        eng = Engine(cfg)
        for form in forms:
            t0 = time.perf_counter()
            if form == "top1":
                got = eng.score_top1(snap)[:3]
            else:
                got = eng.score_topk(snap, 8)[:2]
            results.append((label, cfg, eng.put(snap), form, got,
                            (time.perf_counter() - t0) * 1e3))
        eng.close()
    phase_counts = counts()
    check_launches("pairwise ScoreBatch", phase_counts, PAIR_SCORE_KERNELS,
                   True, calls=len(results))
    plain = kassign.PLAIN
    for label, cfg, dsnap, form, got, wall in results:
        if form == "top1":
            want = score_top1_core(cfg, dsnap, ops=plain)
        else:
            want = tuple(t[:, :8] for t in score_topk_core(cfg, dsnap, 8,
                                                           ops=plain))
        for g, w in zip(got, want):
            if not np.array_equal(g, w.cpu().numpy()):
                raise AssertionError(f"pairwise ScoreBatch {label} {form} "
                                     "differs from its plain version")
        extra = (f"{int(got[2].sum())} pods with a feasible node"
                 if form == "top1" else
                 f"{int((got[0] >= 0).sum())} feasible (pod, rank) slots")
        log(f"pairwise ScoreBatch {label} {form}: {wall:.3f} ms wall "
            f"(first call), {extra}, equal to the plain version; {smi}")
    log(f"pairwise ScoreBatch launches {phase_counts}")
    return phase_counts


def with_recorded(fn, module, attr: str, keep: int | None = None):
    """Run fn() with module.attr wrapped to record its calls' arguments
    (cloned tensors) and outputs, the first `keep` of them (all when
    None); returns (fn's result, [(args, out)])."""
    orig = getattr(module, attr)
    calls = []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        if keep is None or len(calls) < keep:
            calls.append((tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args), out))
        return out

    setattr(module, attr, rec)
    try:
        return fn(), calls
    finally:
        setattr(module, attr, orig)


def gang_phase(cells, label: str, want: tuple[str, ...], smi: str) -> dict:
    """Gang cells through the engine (counters zeroed just before, read
    just after), then the audit, equality with the plain solve and the
    gang audit on the plain solve's rolled-back set."""
    results, phase_counts = solve_phase(label, cells, want)
    for name, cfg, snap, res, wall_ms, moved in results:
        dsnap = Engine(cfg).put(snap)
        info, calls = with_recorded(lambda: audit(name, cfg, dsnap, res),
                                    kassign, "gang_rollback")
        info.update(gang_audit(name, dsnap, res, calls[0][1][4].cpu().numpy()))
        log(f"{label} solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, audit "
            f"clean, equal to the plain solve ({info['plain_solve_ms']:.1f} "
            f"ms); gang audit clean: {info['groups_placed']} of "
            f"{info['groups']} groups placed, {info['rolled_groups']} groups "
            f"({info['rolled_pods']} pods) rolled back; {smi}")
        if name.startswith("g") and info["rolled_groups"] < 1:
            raise AssertionError(f"{label} {name}: no group rolled back")
    return phase_counts


def preempt_kernel_phase(cfg: EngineConfig, dsnap, plain_scan,
                         steps) -> dict:
    """K4's preemption variant against the (h) audit's plain scan (run
    once), and K15 against its plain version on the scan's state at (h)'s
    first preemptors (the plain scan's first preempt_step_plain calls),
    exactly, with the violation counts K15 leaves in its scratch equal to
    the plain tableau's; times and bounds."""
    out = {}
    nodes, pods = dsnap.nodes, dsnap.pods
    args4, want4, plain_ms = plain_scan
    got4 = kassign.parity_scan_preempt(*args4)
    err = require_equal("parity_scan_preempt", got4, want4)
    _, _, static, order, pctx = args4
    P, N = static.mask.shape
    M, R = pctx.req_s.shape
    vic_bytes = nbytes(pctx.perm, pctx.node_s, pctx.seg_start, pctx.cost_s,
                       pctx.vprio_s, pctx.req_s, pctx.pdb_s)
    placed = got4[0] >= 0
    searches = int((placed & torch.isinf(got4[1])).sum()
                   + (pods.valid & (pods.group < 0) & ~placed).sum())
    b4 = nbytes(static.mask, static.score, nodes.allocatable, nodes.used,
                pods.requests, static.w_lr, static.w_ba, static.w_ts,
                static.w_ia, static.rw, *got4) + 4 * P + vic_bytes
    scan_ms = cuda_ms(lambda: kassign.parity_scan_preempt(*args4), 3)
    no_pre_ms = cuda_ms(lambda: kassign.parity_scan(cfg, dsnap, static,
                                                    order), 3)
    out["parity_scan_preempt"] = dict(
        err=err, ms=scan_ms, plain_ms=plain_ms,
        bound=bound(b4, P * N * (R * 14 + 12) + searches * M * (3 * R + 12)),
        shape=f"P={P} N={N} R={R} M={M}, {searches} K15 searches, "
              f"{int(got4[3].sum())} evicted; K4 without preemption on the "
              f"same inputs {no_pre_ms:.3f} ms, so "
              f"{(scan_ms - no_pre_ms) * 1e3 / max(searches, 1):.2f} us a "
              "search inside the scan")
    errs, viols = 0.0, 0
    for a, _ in steps:
        scratch = kpre.victim_scratch(M, R, nodes.valid.device)
        got = kpre.preempt_step(*a, scratch=scratch)
        errs = max(errs, require_equal("preempt_step", got,
                                       kpre.preempt_step_plain(*a)))
        c, snap_a, ctx, prio, req, allowed, used, evicted = a
        elig, _, wviol, _, viol = kpre.tableau_plain(
            c, snap_a, ctx, prio, req, used, evicted,
            kpre.pdb_remaining(snap_a, evicted))
        require_equal("preempt_step tableau",
                      [kpre.deinterleave(scratch[0], M),
                       kpre.deinterleave(scratch[2], M)],
                      [elig.to(torch.uint8), wviol])
        viols += int(viol.sum())
    if viols < 1:
        raise AssertionError("K15: no victim is a PDB violation at (h)'s "
                             "first preemptors")
    b15 = vic_bytes + M + nbytes(nodes.valid, nodes.used, nodes.allocatable) \
        + N + M
    k = len(steps)
    out["preempt_step"] = dict(
        err=errs,
        ms=cuda_ms(lambda: [kpre.preempt_step(*a) for a, _ in steps], 5) / k,
        plain_ms=cuda_ms(lambda: [kpre.preempt_step_plain(*a)
                                  for a, _ in steps], 2) / k,
        bound=bound(b15, M * (3 * R + 12)),
        shape=f"M={M} N={N} R={R} GP={dsnap.pdb_allowed.shape[0]}, {k} "
              f"preemptor states, {viols} PDB-violating victims in their "
              f"tableaus, {sum(int(o[1]) for _, o in steps)} found a prefix")
    return out


def pair_preempt_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K4's pairwise preemption variant against its plain version (timed
    once) on (h) with spread and inter-pod terms, exactly in all five
    outputs; the final pair state also equals K10's recount at the
    assignment less the evicted members."""
    nodes, pods = dsnap.nodes, dsnap.pods
    static = kassign.precompute_static(cfg, dsnap, *_sat_tables(dsnap))
    dom_s = kpair.sig_domains(dsnap)
    st = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods)
    order = kassign.pop_order(cfg, dsnap)
    pctx = kpre.precompute(cfg, dsnap)
    args = (cfg, dsnap, static, order, st, dom_s, pctx)
    got = kassign.parity_scan_pair_preempt(*args)
    t0 = time.perf_counter()
    want = kassign.parity_scan_pair_preempt_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    flat = lambda r: [r[0], r[1], r[2], *_flat(r[3]), r[4]]
    err = require_equal("parity_scan_pair_preempt", flat(got), flat(want))
    rec = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods,
                            assigned=got[0])
    left = kpair.pair_state_evict(dsnap, rec, static.sig_match, dom_s, got[4])
    require_equal("parity_scan_pair_preempt state", _flat(got[3]),
                  _flat(left))
    P, N = static.mask.shape
    M, R = pctx.req_s.shape
    S, C = dom_s.shape[0], pods.ts_sig.shape[1]
    IT = pods.ia_sig.shape[1]
    b = nbytes(static.mask, static.score, static.aff_ok, nodes.allocatable,
               nodes.used, pods.requests, static.w_lr, static.w_ba,
               static.w_ts, static.w_ia, static.rw, dom_s, static.sig_match,
               st.counts, st.anti, st.match_tot, pctx.perm, pctx.node_s,
               pctx.seg_start, pctx.cost_s, pctx.vprio_s, pctx.req_s,
               pctx.pdb_s, *flat(got)) + 4 * P
    return {"parity_scan_pair_preempt": dict(
        err=err, ms=cuda_ms(lambda: kassign.parity_scan_pair_preempt(*args),
                            3),
        plain_ms=plain_ms,
        bound=bound(b, P * N * (R * 14 + 12 + C * 6 + IT * 10 + S * 3 + 14)),
        shape=f"P={P} N={N} R={R} M={M} S={S} C={C} IT={IT}, placed "
              f"{int((got[0] >= 0).sum())}, evicted {int(got[4].sum())}")}


def preempt_phase(snap_h, snap_hp, smi: str) -> tuple[dict, dict]:
    """Cell (h) through the engine with preemption (counters zeroed just
    before, read just after), the audit, equality with the plain solve
    (run once, its scan recorded with the states at its first
    preemptors) and the preemption audit; then the kernel phase of K4's
    preemption variants and K15. Returns (the phase's launch counts, the
    kernel rows)."""
    cfg = EngineConfig(mode="parity", preemption=True)
    pre, phase_counts = solve_phase(
        "preemption parity",
        (("h: config5 10000x5000 at 90% tight, 30% of running pods under "
          "PDBs, preemption on", cfg, snap_h),), PREEMPT_KERNELS)
    name, _, _, res, wall_ms, moved = pre[0]
    eng = Engine(cfg)
    dsnap = eng.put(snap_h)
    info, steps = with_recorded(lambda: audit(name, cfg, dsnap, res), kpre,
                                "preempt_step_plain", keep=K15_STATES)
    info.update(preempt_audit(name, dsnap, res))
    if info["evicted"] < 1:
        raise AssertionError(f"{name}: no victim evicted")
    log(f"preemption parity solve {name}: {wall_ms:.3f} ms wall, placed "
        f"{info['placed']}/{info['valid_pods']}, {info['preempted']} by "
        f"preemption, {info['searches']} K15 searches in the scan, "
        f"{info['evicted']} victims evicted, launches {moved}, audit clean, "
        f"equal to the plain solve in assignment, chosen, used and evicted "
        f"(plain scan {info['plain_preempt_scan'][2]:.1f} ms), preemption "
        f"audit clean; {smi}")
    kp = preempt_kernel_phase(cfg, dsnap, info["plain_preempt_scan"], steps)
    kp.update(pair_preempt_kernel_phase(cfg, eng.put(snap_hp)))
    eng.close()
    for kname, r in kp.items():
        log(f"kernel {kname} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {smi}")
    return phase_counts, kp


def profiler_ms(fn, kernel: str, reps: int = 5) -> float | None:
    """The device time of the CUDA kernels whose name holds `kernel`,
    per fn() call, from a torch.profiler trace of `reps` calls (after a
    warm-up); None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, False
    for e in prof.key_averages():
        if kernel in e.key:
            seen = True
            total += getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
    return total / 1e3 / reps if seen and total > 0 else None


def first_auction_calls(cfg: EngineConfig, dsnap) -> dict:
    """The arguments of the first call of each auction kernel (K16, K17's
    two entry points, K6 at K = 256, K18) in a fast preemption solve of
    `dsnap`: its first auction round, by kernels-line name."""
    calls = {}

    def rec(name, fn, want=lambda a: True):
        def wrapped(*a):
            if name not in calls and want(a):
                calls[name] = (fn, tuple(x.clone() if isinstance(
                    x, torch.Tensor) else x for x in a))
            return fn(*a)
        return wrapped

    k = kassign.KERNELS
    ops = dataclasses.replace(
        k, auction_ok=rec("auction_ok", k.auction_ok),
        auction_tables=rec("auction_tables", k.auction_tables),
        auction_rank=rec("auction_rank", k.auction_rank),
        row_topk=rec("row_topk_k256", k.row_topk, lambda a: a[1] > 16),
        auction_claim=rec("auction_claim", k.auction_claim))
    solve_core(cfg, dsnap, ops=ops)
    return calls


AUCTION_PLAIN = {
    "auction_tables": kpre.auction_tables_plain,
    "auction_ok": kpre.auction_ok_plain,
    "auction_rank": kpre.auction_rank_plain,
    "row_topk_k256": kassign.row_topk_plain,
    "auction_claim": kpre.auction_claim_plain,
}
# The CUDA kernel of each auction row, for the profiler's kernel times.
AUCTION_CUDA_NAME = {
    "auction_tables": "auction_tables_kernel",
    "auction_ok": "auction_ok_kernel",
    "auction_rank": "auction_rank_kernel",
    "row_topk_k256": "row_topk_kernel",
    "auction_claim": "auction_claim_kernel",
}


def auction_kernel_phase(dsnap, calls: dict) -> dict:
    """K16, K17 (both entry points), K6 at K = 256 and K18 against their
    plain versions on the arguments of their first call (exact), with
    CUDA-event and profiler times and bounds (bytes each input read once,
    each output written once; the tables K17 and K18 gather, only the
    rows they read)."""
    out = {}
    for name, plain in AUCTION_PLAIN.items():
        fn, a = calls[name]
        got = _flat(fn(*a))
        err = require_equal(name, got, _flat(plain(*a)))
        r = dict(err=err, ms=cuda_ms(lambda: fn(*a), 20),
                 prof_ms=profiler_ms(lambda: fn(*a), AUCTION_CUDA_NAME[name]),
                 plain_ms=cuda_ms(lambda: plain(*a), 3))
        if name == "auction_tables":
            ctx, ev, thr, rem, _ = a
            L = thr.shape[0]
            N, V, R = ctx.vreq.shape
            # Every lane reads the same victim rows: the table once.
            b = nbytes(ctx.vreq, ctx.vcost, ctx.vprio, ctx.vpdb, ctx.vvalid,
                       ctx.vidx) + N * V + nbytes(thr, rem, *got)
            r.update(bound=bound(b, L * N * V * (2 * R + V + 8)),
                     shape=f"L={L} N={N} V={V} R={R}")
        elif name == "auction_ok":
            mask, rows, pair_ok, pre, nvalid = a
            C, N = got[0].shape
            b = C * N * (2 if pair_ok is not None else 1) + nbytes(
                pre, nvalid, *got) + (4 * C if rows is not None else 0)
            r.update(bound=bound(b, 4 * C * N),
                     shape=f"C={C} N={N}, {int(got[1].sum())} active")
        elif name == "auction_rank":
            cum_req, cum_cost, cum_viol, lane, ok, used, alloc, p_req = a
            L, N, V, R = cum_req.shape
            C = lane.shape[0]
            b = nbytes(*a, *got)
            steps = max(1, V.bit_length())
            r.update(bound=bound(b, C * N * (2 * R * (steps + 3) + 8)),
                     shape=f"C={C} N={N} L={L} V={V} R={R}, "
                           f"{int(torch.isfinite(got[0]).sum())} bids")
        elif name == "row_topk_k256":
            masked, K = a[0], a[1]
            C, N = masked.shape
            r.update(bound=bound(nbytes(masked, *got[:2]), C * N),
                     library="torch.topk",
                     library_ms=cuda_ms(lambda: torch.topk(masked, K, dim=1),
                                        20),
                     shape=f"C={C} N={N} K={K}")
        elif name == "auction_claim":
            topv, topi, can_plain, n_plain, rank, ctx = a[:6]
            p_prio, p_req, could = a[7], a[8], a[11]
            iters = kpre.CLAIM_ITERS
            C, K = topi.shape
            N, V, R = ctx.vreq.shape
            row = ctx.vreq[0].numel() * 4 + V * (4 + 4 + 1 + 4 + 1)
            b = nbytes(topv, topi, can_plain, n_plain, rank, p_prio, p_req,
                       could, *got) + C * (row + 2 * R * 4)
            r.update(bound=bound(b, iters * C * K * 3 + C * V * (R + 4)),
                     shape=f"C={C} K={K} N={N} V={V} iters={iters}, "
                           f"{int(got[1].sum())} claimed, "
                           f"{int(got[2].sum())} to evict")
        out[name] = r
    return out


def fast_preempt_phase(snap_h, snap_hp, smi: str) -> tuple[dict, dict]:
    """Fast mode with preemption on (h) and on (h) with spread and
    inter-pod terms, each through the engine (counters zeroed just before,
    read just after), then 5 steady solves (median), the audit with
    equality to the plain solve (host reads too) and the commit-key audit
    in both eviction arms, the preemption audit, a stage breakdown; then
    the auction kernels against their plain versions on the arguments of
    each cell's first auction round. Returns (the phases' launch counts,
    the kernel rows of (h))."""
    cfg = EngineConfig(mode="fast", preemption=True)
    cells = (
        ("h fast: config5 10000x5000, preemption on", snap_h,
         FAST_PREEMPT_KERNELS, ONCE),
        ("h fast + spread/inter-pod terms", snap_hp,
         FAST_PREEMPT_PAIR_KERNELS, FAST_PAIR_ONCE))
    launches, rows = {}, {}
    for name, snap, want, once in cells:
        pair = snap.sigs.key.shape[0] > 0
        results, phase_counts = solve_phase(
            "fast preemption", ((name, cfg, snap),), want, once=once)
        for k, v in phase_counts.items():
            launches[k] = launches.get(k, 0) + v
        _, _, _, res, wall_ms, moved = results[0]
        eng = Engine(cfg)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.solve(snap)
            walls.append((time.perf_counter() - t0) * 1e3)
        bd = fast_breakdown(eng, snap)
        dsnap = eng.put(snap)
        eng.close()
        claims = []

        def hook(ops):
            def rec(*a):
                out = ops.auction_claim(*a)
                claims.append(out[0].clone())
                return out
            return dataclasses.replace(ops, auction_claim=rec)

        info, evs = with_recorded(
            lambda: audit(name, cfg, dsnap, res, hook=hook), kassign,
            "_evict_round")
        per_round = [(a[0], a[2], t, out) for (a, out), t in zip(evs, claims)]
        info.update(preempt_audit(name, dsnap, res,
                                  per_round if pair else None))
        if info["evicted"] < 1:
            raise AssertionError(f"{name}: no victim evicted")
        extra = (f", pairwise audit clean (S={info['signatures']}, "
                 f"{info['anti_holders']} placed required-anti holders), "
                 f"commit-key audit clean in both eviction arms "
                 f"({info['commit_key_checked']} pods over {info['keys']} "
                 f"keys; {info['one_arm_only']} checks fail in one arm "
                 f"only), {info['stranded']} stranded victims (their "
                 "preemptor reverted by the round's validation)"
                 if pair else ", capacity holds with the evictions applied")
        log(f"fast preemption solve {name}: {wall_ms:.3f} ms wall (first "
            f"request), steady median of 5 {statistics.median(walls):.3f} "
            f"ms; placed {info['placed']}/{info['valid_pods']}, "
            f"{info['preempted']} by preemption, {info['evicted']} victims "
            f"evicted; rounds {res.rounds} of which preemption "
            f"{bd['preemption rounds']}, host reads {res.host_reads} of "
            f"which preemption {bd['preemption host reads']}; launches "
            f"{moved}; audit clean, equal to the plain solve in assignment, "
            f"order, chosen, commit key, used, evicted, rounds and host "
            f"reads (plain solve {info['plain_solve_ms']:.1f} ms); "
            f"preemption audit clean{extra}; {smi}")
        log(f"steady fast preemption solve {name}: stages (ms): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in bd.items()) + f"; {smi}")
        kp = auction_kernel_phase(dsnap, first_auction_calls(cfg, dsnap))
        for kname, r in kp.items():
            lib = (f", {r['library']} {r['library_ms']:.4f} ms"
                   if r.get("library_ms") is not None else "")
            prof = ("not measured" if r["prof_ms"] is None
                    else f"{r['prof_ms']:.4f} ms")
            log(f"kernel {kname} on {name.split(':')[0]}'s first auction "
                f"round [{r['shape']}]: exact match, kernel {r['ms']:.4f} ms "
                f"(CUDA events; profiler kernel time {prof}), plain "
                f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]}); {smi}")
        if not rows:
            rows = kp
        else:
            for kname, r in kp.items():
                rows[kname]["err"] = max(rows[kname]["err"], r["err"])
    return launches, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU and has no CPU mode", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    n_src = len(list(_build.CSRC.glob("*.cu")))
    log(f"kernel build (nvcc, {n_src} sources in parallel) and load: "
        f"{time.perf_counter() - t0:.3f} s")
    ptxas = _build.BUILD_DIR / "ptxas.txt"
    if ptxas.exists():
        print(ptxas.read_text(), file=sys.stderr)

    t0 = time.perf_counter()
    snap_a, meta_a = config2_scale(np.random.default_rng(SEED), PODS, NODES,
                                   with_qos=True)
    snap_b, meta_b = config2_scale(np.random.default_rng(SEED), PODS, NODES,
                                   with_qos=True, **CONSTRAINED)
    log(f"snapshots built on the host: {time.perf_counter() - t0:.3f} s; "
        f"(a) buckets P={meta_a.buckets.pods} N={meta_a.buckets.nodes} "
        f"M={meta_a.buckets.running_pods} A={meta_a.buckets.atoms}; "
        f"(b) A={meta_b.buckets.atoms} T={meta_b.buckets.terms} "
        f"TN={meta_b.buckets.node_taints} VT={meta_b.buckets.taint_vocab}")
    t0 = time.perf_counter()
    snap_d, meta_d = config3_pairwise(np.random.default_rng(PAIR_SEED), PODS,
                                      NODES)
    snap_e, meta_e = config3_pairwise(np.random.default_rng(PAIR_SEED), PODS,
                                      NODES, **PAIR_EXTRA)
    log(f"pairwise snapshots built on the host: "
        f"{time.perf_counter() - t0:.3f} s; (d) P={meta_d.buckets.pods} "
        f"N={meta_d.buckets.nodes} M={meta_d.buckets.running_pods} "
        f"S={meta_d.buckets.signatures} C={meta_d.buckets.spread_constraints} "
        f"IT={meta_d.buckets.affinity_terms} A={meta_d.buckets.atoms}; "
        f"(e) S={meta_e.buckets.signatures} "
        f"NSV={meta_e.buckets.sig_namespaces} "
        f"IT={meta_e.buckets.affinity_terms}")

    cfg_first = EngineConfig(mode="parity")
    cfg_seeded = EngineConfig(mode="parity", tie_break="seeded",
                              tie_seed=SEED)
    engine = Engine(cfg_first)

    # -- kernel phase --------------------------------------------------------
    kp = kernel_phase(cfg_first, engine.put(snap_b))
    kp.update(pair_kernel_phase(cfg_first, engine.put(snap_d)))
    kp.update(fast_pair_kernel_phase(cfg_first, engine.put(snap_d)))
    for name, r in kp.items():
        lib = (f", {r['library']} {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
        log(f"kernel {name} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {smi}")

    # -- main-path phases ------------------------------------------------------
    cells = (("a: config2 10000x5000 qos", cfg_first, snap_a),
             ("b: + taints/tolerations/selectors/affinity/cordon",
              cfg_first, snap_b),
             ("c: config2 10000x5000 qos, seeded tie-break", cfg_seeded,
              snap_a))
    launches = {name: 0 for name, _, _, _, _ in KERNELS}
    parity, phase_counts = solve_phase("parity", cells, PARITY_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    parity_placed = {}
    for name, cfg, snap, res, wall_ms, moved in parity:
        info = audit(name, cfg, engine.put(snap), res)
        parity_placed[name] = info["placed"]
        log(f"parity solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, "
            f"audit clean, equal to the plain solve; {smi}")
    fast_cells = tuple((name, dataclasses.replace(cfg, mode="fast"), snap)
                       for name, cfg, snap in cells)
    fast, phase_counts = solve_phase("fast", fast_cells, FAST_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in fast:
        info = audit(f"fast {name}", cfg, engine.put(snap), res)
        log(f"fast solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']} (parity placed "
            f"{parity_placed[name]}), rounds {res.rounds}, host reads "
            f"{res.host_reads}, launches {moved}, audit clean, equal to "
            f"the plain fast solve; {smi}")
    # The plain fast solve on the host's CPU places on (b) what the card
    # placed (its f32 prefix sums have one order on every device).
    _, cfg_b, _, res_b, _, _ = fast[1]
    t0 = time.perf_counter()
    cpu_eng = Engine(cfg_b, device="cpu")
    res_cpu = cpu_eng.solve(snap_b)
    cpu_eng.close()
    n_card = int((res_b.assignment >= 0).sum())
    n_cpu = int((res_cpu.assignment >= 0).sum())
    if n_cpu != n_card:
        raise AssertionError(f"fast (b): {n_cpu} placed on the CPU, "
                             f"{n_card} on the card")
    log(f"fast solve (b) on the host CPU (plain versions): placed {n_cpu}, "
        f"as on the card; {int((res_cpu.assignment != res_b.assignment).sum())}"
        f" assignments differ from the card's; rounds {res_cpu.rounds}, "
        f"host reads {res_cpu.host_reads}; "
        f"{(time.perf_counter() - t0):.3f} s host clock")
    for k, v in score_phase(cfg_first, snap_b, smi).items():
        launches[k] += v
    pair_cells = (
        ("d: config3 10000x5000 pairwise", cfg_first, snap_d),
        ("d seeded: config3 10000x5000, seeded tie-break", cfg_seeded,
         snap_d),
        ("e: d + running anti, 3 namespaces, key-less nodes", cfg_first,
         snap_e))
    pair_parity, phase_counts = solve_phase("pairwise parity", pair_cells,
                                            PAIR_PARITY_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in pair_parity:
        info = audit(name, cfg, engine.put(snap), res)
        log(f"pairwise parity solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, "
            f"audit clean, equal to the plain solve (plain scan "
            f"{info['plain_scan_ms']:.1f} ms), pairwise audit clean "
            f"(S={info['signatures']}, {info['anti_holders']} placed "
            f"required-anti holders); {smi}")
    for k, v in pair_score_phase(
            (("d", cfg_first, snap_d, ("top1", "topk8")),
             ("e", cfg_first, snap_e, ("top1",))), smi).items():
        launches[k] += v
    fast_pair_cells = tuple((f"fast {name}", dataclasses.replace(
        cfg, mode="fast"), snap) for name, cfg, snap in pair_cells)
    fast_pair, phase_counts = solve_phase(
        "fast pairwise", fast_pair_cells, FAST_PAIR_KERNELS,
        once=FAST_PAIR_ONCE)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in fast_pair:
        info = audit(name, cfg, engine.put(snap), res)
        log(f"fast pairwise solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, rounds {res.rounds}, "
            f"host reads {res.host_reads}, launches {moved}, audit clean, "
            f"equal to the plain fast solve ({info['plain_solve_ms']:.1f} "
            f"ms), pairwise audit clean (S={info['signatures']}, "
            f"{info['anti_holders']} placed required-anti holders), "
            f"commit-key audit clean ({info['commit_key_checked']} pods "
            f"over {info['keys']} keys); {smi}")
    # Compacted rounds (compact_cap -1: [1024, N] views once the pending
    # frontier fits) equal full-width rounds (compact_cap 0) on (d).
    _, cfg_d, snap_fd, res_d, _, _ = fast_pair[0]
    eng_full = Engine(dataclasses.replace(cfg_d, compact_cap=0))
    t0 = time.perf_counter()
    res_full = eng_full.solve(snap_fd)
    full_ms = (time.perf_counter() - t0) * 1e3
    eng_full.close()
    for field in ("assignment", "chosen_score", "commit_key", "final_used",
                  "rounds"):
        if not np.array_equal(getattr(res_d, field), getattr(res_full,
                                                             field)):
            raise AssertionError(f"fast (d): compacted rounds differ from "
                                 f"full-width rounds in {field}")
    log(f"fast (d) compaction twin: compact_cap=-1 equals compact_cap=0 in "
        f"assignment, chosen_score, commit_key, final_used and rounds "
        f"({res_d.rounds}); host reads {res_d.host_reads} vs "
        f"{res_full.host_reads}, full-width solve {full_ms:.3f} ms wall; "
        f"{smi}")
    # The plain fast solve of (d) on the host's CPU places what the card
    # placed.
    t0 = time.perf_counter()
    cpu_eng = Engine(cfg_d, device="cpu")
    res_cpu = cpu_eng.solve(snap_fd)
    cpu_eng.close()
    n_card = int((res_d.assignment >= 0).sum())
    n_cpu = int((res_cpu.assignment >= 0).sum())
    if n_cpu != n_card:
        raise AssertionError(f"fast (d): {n_cpu} placed on the CPU, "
                             f"{n_card} on the card")
    log(f"fast solve (d) on the host CPU (plain versions): placed {n_cpu}, "
        f"as on the card; "
        f"{int((res_cpu.assignment != res_d.assignment).sum())} assignments"
        f" differ from the card's; rounds {res_cpu.rounds}, host reads "
        f"{res_cpu.host_reads}; {(time.perf_counter() - t0):.3f} s host "
        "clock")

    # -- gangs (config 4) and preemption (config 5) ----------------------------
    t0 = time.perf_counter()
    snap_f, meta_f = config4_gangs(np.random.default_rng(GANG_SEED),
                                   n_nodes=NODES, **GANGS)
    snap_g, meta_g = config4_gangs(np.random.default_rng(GANG_SEED), **GANGS)
    snap_h, meta_h = config5_preemption(np.random.default_rng(PRE_SEED), PODS,
                                        NODES)
    snap_hp, meta_hp = config5_preemption(np.random.default_rng(PRE_SEED),
                                          PODS, NODES, **PRE_PAIR)
    log(f"gang and preemption snapshots built on the host: "
        f"{time.perf_counter() - t0:.3f} s; (f) P={meta_f.buckets.pods} "
        f"N={meta_f.buckets.nodes} G={meta_f.buckets.pod_groups}; (g) "
        f"N={meta_g.buckets.nodes}; (h) M={meta_h.buckets.running_pods} "
        f"GP={meta_h.buckets.pdb_groups}, {meta_h.n_running} running pods; "
        f"(h) with spread and inter-pod terms S={meta_hp.buckets.signatures}")
    gang_cells = (("f: config4 2500 gangs of 4 on 5000 nodes", cfg_first,
                   snap_f),
                  ("g: config4 2500 gangs of 4 on 1000 nodes", cfg_first,
                   snap_g))
    for k, v in gang_phase(gang_cells, "gang parity", GANG_PARITY_KERNELS,
                           smi).items():
        launches[k] += v
    fast_gang_cells = tuple((name.replace(":", " fast:", 1),
                             dataclasses.replace(cfg, mode="fast"), snap)
                            for name, cfg, snap in gang_cells)
    for k, v in gang_phase(fast_gang_cells, "gang fast", GANG_FAST_KERNELS,
                           smi).items():
        launches[k] += v
    phase_counts, kp_pre = preempt_phase(snap_h, snap_hp, smi)
    for k, v in phase_counts.items():
        launches[k] += v
    kp.update(kp_pre)
    phase_counts, kp_auction = fast_preempt_phase(snap_h, snap_hp, smi)
    for k, v in phase_counts.items():
        launches[k] += v
    kp.update(kp_auction)

    for name, n in launches.items():
        if name in OFF_PATH:
            log(f"kernel {name}: {n} launches on the main path "
                f"({OFF_PATH[name]})")
        elif n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # -- steady-state solve time and stage breakdowns -------------------------
    for mode, breakdown, steady in (("parity", stage_breakdown, cells[:2]),
                                    ("fast", fast_breakdown, cells[:2]),
                                    ("parity", stage_breakdown,
                                     pair_cells[:1]),
                                    ("fast", fast_breakdown,
                                     fast_pair_cells[:1])):
        for name, cfg, snap in steady:
            eng = Engine(dataclasses.replace(cfg, mode=mode))
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.solve(snap)
                walls.append((time.perf_counter() - t0) * 1e3)
            median = statistics.median(walls)
            bd = breakdown(eng, snap)
            eng.close()
            log(f"steady {mode} solve {name}: median of 5 {median:.3f} ms "
                "wall; stages (ms): " + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in bd.items()) + f"; {smi}")

    kernels = []
    for name, _, _, source, replaces in KERNELS:
        r = kp[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
