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
  4. main-path phases, each with every launch counter zeroed just
     before and read just after, requiring each of its kernels to
     launch:
     - parity: `Engine.solve` at 10 000 pods x 5 000 nodes on (a) the
       headline config-2 cluster, (b) the same size with constraints,
       (c) the headline with the seeded tie-break (K1-K4);
     - fast: the same three requests with mode="fast" (K5-K8);
     - ScoreBatch: `Engine.score`, `score_top1` and `score_topk(k=8)`
       on (b) (K5, K6);
     after each solve a validity audit (no node over capacity, every
     placed pod's static mask true at its node, no padded pod placed)
     and equality with the same solve through the plain versions on the
     same CUDA tensors; each ScoreBatch result equal to its plain
     version;
  5. prints per-stage time breakdowns of one steady parity and one
     steady fast solve, a JSON line with every kernel's numbers, and,
     last, the device JSON line.

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
from tpusched_torch.kernels.atoms import atom_sat, atom_sat_plain
from tpusched_torch.qos import effective_weights, pressure_of
from tpusched_torch.synth import config2_scale

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit): HBM3
# bandwidth and the f32 rate outside the tensor cores. None of these
# kernels uses the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PODS, NODES, SEED = 10_000, 5_000, 42
CONSTRAINED = dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.05)

# (name, wrapper, source, the JAX function it replaces)
KERNELS = (
    ("atom_sat", atom_sat, "tpusched_torch/csrc/atoms.cu",
     "tpusched/kernels/atoms.py:29"),
    ("tableau_cells", kassign._tableau_cells,
     "tpusched_torch/csrc/tableau.cu", "tpusched/kernels/assign.py:110"),
    ("finalize_static", kassign.finalize_score,
     "tpusched_torch/csrc/finalize.cu", "tpusched/kernels/assign.py:233"),
    ("parity_scan", kassign.parity_scan, "tpusched_torch/csrc/scan.cu",
     "tpusched/kernels/assign.py:426"),
    ("cycle", kassign.cycle, "tpusched_torch/csrc/cycle.cu",
     "tpusched/kernels/assign.py:265"),
    ("row_topk", kassign.row_topk, "tpusched_torch/csrc/topk.cu",
     "tpusched/kernels/assign.py:854"),
    ("desirability", kassign.desirability, "tpusched_torch/csrc/deal.cu",
     "tpusched/kernels/assign.py:793"),
    ("prefix_commit", kassign.prefix_commit, "tpusched_torch/csrc/commit.cu",
     "tpusched/kernels/assign.py:894"),
)
PARITY_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                  "parity_scan")
FAST_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                "row_topk", "desirability", "prefix_commit")
SCORE_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                 "row_topk")


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


def plain_result(cfg: EngineConfig, dsnap, stats=None):
    """The whole solve (either mode) through the plain versions only, on
    the snapshot's device: no kernel launches."""
    buf = _pack_solve(solve_core(cfg, dsnap, ops=kassign.PLAIN, stats=stats))
    return Engine.unpack(dsnap, buf.cpu().numpy())


def audit(name: str, cfg: EngineConfig, dsnap, res) -> dict:
    """Validity of one solve result, then equality with the plain solve
    on the same CUDA tensors."""
    pstats = kassign.RoundStats()
    want = plain_result(cfg, dsnap, pstats)
    plain = kassign.PLAIN
    mask = kassign.precompute_static(
        cfg, dsnap, _sat_tables(dsnap, plain), plain).mask.cpu().numpy()
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
    if not np.isfinite(res.chosen_score[placed]).all():
        raise AssertionError(f"{name}: a placed pod has no finite score")
    P = a.shape[0]
    if sorted(res.order.tolist()) != list(range(P)):
        raise AssertionError(f"{name}: order is not a permutation")
    for field in ("assignment", "order", "chosen_score", "commit_key",
                  "final_used", "evicted", "rounds"):
        got, exp = getattr(res, field), getattr(want, field)
        if not np.array_equal(got, exp):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "solve on the same CUDA tensors")
    if cfg.mode == "fast" and res.host_reads != pstats.host_reads:
        raise AssertionError(f"{name}: {res.host_reads} host reads, the "
                             f"plain solve {pstats.host_reads}")
    return {"placed": int(placed.sum()), "valid_pods": int(pvalid.sum())}


def counts() -> dict:
    return {name: fn.launches for name, fn, _, _ in KERNELS}


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
    scan_p = kassign.parity_scan_plain(cfg, dsnap, static, order)
    err = require_equal("parity_scan", scan_k, scan_p)
    R = nodes.allocatable.shape[1]
    b4 = nbytes(static.mask, static.score, nodes.allocatable, nodes.used,
                pods.requests, static.w_lr, static.w_ba, static.w_ts,
                static.w_ia, static.rw, *scan_k) + 4 * P
    ops4 = P * N * (R * 14 + 12)
    out["parity_scan"] = dict(
        err=err, ms=cuda_ms(
            lambda: kassign.parity_scan(cfg, dsnap, static, order), 5),
        plain_ms=cuda_ms(
            lambda: kassign.parity_scan_plain(cfg, dsnap, static, order), 2),
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
                         _sat_tables(dsnap), ops=ops)
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


def stage_breakdown(engine: Engine, snap) -> dict:
    """Device time of each stage of one solve (CUDA events), plus the
    host-clock transfers at both ends."""
    cfg = engine.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsnap = engine.put(snap)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    node_sat_t = _sat_tables(dsnap)
    ev[1].record()
    cells = kassign._tableau_cells(dsnap, dsnap.pods, dsnap.nodes, node_sat_t)
    ev[2].record()
    static = kassign.finalize_static(cfg, dsnap, *cells)
    ev[3].record()
    order = kassign.pop_order(cfg, dsnap)
    ev[4].record()
    a, c, u = kassign.parity_scan(cfg, dsnap, static, order)
    ev[5].record()
    P = a.shape[0]
    rank = torch.zeros(P, dtype=torch.int32, device=a.device)
    rank[order] = torch.arange(P, dtype=torch.int32, device=a.device)
    buf = _pack_solve((a, c, u, order, rank,
                       torch.full((), P, dtype=torch.int32, device=a.device),
                       torch.zeros(dsnap.running.valid.shape[0],
                                   dtype=torch.bool, device=a.device)))
    ev[6].record()
    t1 = time.perf_counter()
    buf.cpu()
    d2h_wait_ms = (time.perf_counter() - t1) * 1e3
    names = ("K1 atom_sat (+transpose)", "K2 tableau_cells",
             "K3 finalize_static (+QoS weights)", "pop_order sort",
             "K4 parity_scan", "rank + pack")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
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
    total = ev[0].elapsed_time(ev[1])
    loops = sum(spans.get(k, 0.0) for k in ("round 1", "tranches",
                                             "direct rounds"))
    return {"h2d_ms_host": h2d_ms, "solve_core (device)": total,
            "K1-K3 + pop_order (rest of solve_core)": total - loops,
            **{f"{k} (x{n[k]})": v for k, v in spans.items()},
            "pack": ev[1].elapsed_time(ev[2]),
            "solve_core + pack + D2H (host clock)": host_ms,
            "host_reads": stats.host_reads, "rounds": int(out[5].item())}


def check_launches(name: str, moved: dict, want: tuple[str, ...],
                   has_atoms: bool, calls: int = 1) -> None:
    """Each kernel of the path launched (K1 only with atoms to match),
    no other kernel; K1-K4 once per entry-point call."""
    for k, n in moved.items():
        need = k in want and (k != "atom_sat" or has_atoms)
        once = k in ("atom_sat", "tableau_cells", "finalize_static",
                     "parity_scan")
        if (need and n < 1) or (not need and n) or (once and n > calls):
            raise AssertionError(f"{name}: kernel {k} launched {n} times "
                                 f"(launches {moved})")


def solve_phase(label: str, requests, want: tuple[str, ...]) -> tuple:
    """Drive one main path: every counter zeroed just before, read just
    after; each request must launch each kernel of the path."""
    for _, fn, _, _ in KERNELS:
        fn.launches = 0
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
                       snap.atoms.key.shape[0] > 0)
    return results, phase_counts


def score_phase(cfg: EngineConfig, snap, smi: str) -> dict:
    """ScoreBatch through the engine (counters zeroed just before, read
    just after), then each result against its plain version."""
    for _, fn, _, _ in KERNELS:
        fn.launches = 0
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

    cfg_first = EngineConfig(mode="parity")
    cfg_seeded = EngineConfig(mode="parity", tie_break="seeded",
                              tie_seed=SEED)
    engine = Engine(cfg_first)

    # -- kernel phase --------------------------------------------------------
    kp = kernel_phase(cfg_first, engine.put(snap_b))
    for name, r in kp.items():
        lib = (f", torch.topk {r['library_ms']:.4f} ms"
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
    launches = {name: 0 for name, _, _, _ in KERNELS}
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
    for k, v in score_phase(cfg_first, snap_b, smi).items():
        launches[k] += v
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # -- steady-state solve time and stage breakdowns -------------------------
    for mode, breakdown in (("parity", stage_breakdown),
                            ("fast", fast_breakdown)):
        for name, cfg, snap in cells[:2]:
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
    for name, fn, source, replaces in KERNELS:
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
