#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`tpusched_torch`) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc (the kernels build from
tpusched_torch/csrc at first use), imports nothing of JAX or of the JAX
package, and
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels and prints the build time;
  3. kernel phase: holds each kernel (K1 atom_sat, K2 tableau_cells,
     K3 finalize_static, K4 parity_scan) against its plain PyTorch
     version on the same CUDA tensors of a 10 000 x 5 000 cluster with
     taints, selectors, affinity and cordons, requiring exact equality
     (bool, int and f32: the kernels are built with --fmad=false), and
     times both with CUDA events (median of several runs);
  4. main-path phase: three parity `Engine.solve` requests at
     10 000 pods x 5 000 nodes (the headline config-2 cluster, the same
     size with constraints, and the headline with the seeded
     tie-break), with every launch counter zeroed just before and read
     just after; after each: a validity audit (no node over capacity,
     every placed pod's static mask true at its node) and equality with
     the plain-PyTorch solve on the same CUDA tensors;
  5. prints a per-stage time breakdown of one solve, a JSON line with
     every kernel's numbers, and, last, the device JSON line.

Any failure raises and the exit code is not 0. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import EngineConfig
from tpusched_torch.engine import Engine, _pack_solve, _sat_tables
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
)


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


def plain_solve(cfg: EngineConfig, snap):
    """The whole parity solve through the plain versions only (no kernel
    launch), on the snapshot's device."""
    node_sat_t = atom_sat_plain(snap.atoms, snap.nodes.label_pairs,
                                snap.nodes.label_keys,
                                snap.nodes.label_nums).T.contiguous()
    cells = kassign._tableau_cells_plain(snap, snap.pods, snap.nodes,
                                         node_sat_t)
    w = effective_weights(cfg, pressure_of(snap.pods.slo_target,
                                           snap.pods.observed_avail))
    score = kassign.finalize_score_plain(
        cells[2], cells[3], snap.nodes.valid, w["node_affinity"],
        w["taint_toleration"])
    static = kassign.StaticCtx(
        mask=cells[0], aff_ok=cells[1], score=score,
        w_lr=w["least_requested"], w_ba=w["balanced_allocation"],
        w_ts=w["topology_spread"], w_ia=w["interpod_affinity"],
        rw=torch.tensor(cfg.score_weights_vector(), dtype=torch.float32,
                        device=score.device))
    order = kassign.pop_order(cfg, snap)
    assigned, chosen, used = kassign.parity_scan_plain(cfg, snap, static,
                                                       order)
    return static, order, assigned, chosen, used


def audit(name: str, cfg: EngineConfig, dsnap, res) -> dict:
    """Validity of one solve result, then equality with the plain solve
    on the same CUDA tensors."""
    static, order, assigned, chosen, used = plain_solve(cfg, dsnap)
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
    mask = static.mask.cpu().numpy()
    if not mask[np.nonzero(placed)[0], a[placed]].all():
        raise AssertionError(f"{name}: a pod was placed where its static "
                             "mask is false")
    P = a.shape[0]
    if sorted(res.order.tolist()) != list(range(P)):
        raise AssertionError(f"{name}: order is not a permutation")
    checks = (("assignment", a, assigned), ("order", res.order, order),
              ("chosen_score", res.chosen_score, chosen),
              ("final_used", res.final_used, used))
    for field, got, want in checks:
        want = want.cpu().numpy()
        if not np.array_equal(got, want.astype(got.dtype)):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "solve on the same CUDA tensors")
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
            lambda: kassign.parity_scan_plain(cfg, dsnap, static, order), 5),
        bound=bound(b4, ops4), shape=f"P={P} N={N} R={R}",
        placed=int((scan_k[0] >= 0).sum().item()))
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
    log(f"kernel build (nvcc, 4 sources in parallel) and load: "
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
        log(f"kernel {name} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")

    # -- main-path phase -----------------------------------------------------
    requests = (("a: config2 10000x5000 qos", cfg_first, snap_a),
                ("b: + taints/tolerations/selectors/affinity/cordon",
                 cfg_first, snap_b),
                ("c: config2 10000x5000 qos, seeded tie-break", cfg_seeded,
                 snap_a))
    results = []
    for _, fn, _, _ in KERNELS:
        fn.launches = 0
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
    main_counts = counts()
    for name, cfg, snap, res, wall_ms, moved in results:
        want = {"atom_sat": 1 if snap.atoms.key.shape[0] else 0,
                "tableau_cells": 1, "finalize_static": 1, "parity_scan": 1}
        if moved != want:
            raise AssertionError(f"{name}: launches {moved}, want {want}")
        info = audit(name, cfg, engine.put(snap), res)
        log(f"solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, "
            f"audit clean, equal to the plain solve; {smi}")
    for name, n in main_counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # -- steady-state solve time and stage breakdown --------------------------
    for name, cfg, snap in requests[:2]:
        eng = Engine(cfg)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.solve(snap)
            walls.append((time.perf_counter() - t0) * 1e3)
        median = statistics.median(walls)
        bd = stage_breakdown(eng, snap)
        eng.close()
        log(f"steady solve {name}: median of 5 {median:.3f} ms wall; "
            "stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in bd.items()))

    kernels = []
    for name, fn, source, replaces in KERNELS:
        r = kp[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
