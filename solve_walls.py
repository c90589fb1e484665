#!/usr/bin/env python3
"""Steady solve walls of chip_smoke.py's preemption cells, from one or
more source trees in one process.

    python3 solve_walls.py --trees DIR [DIR ...] [--cell h|hp]
        [--mode fast|parity] [--pairs 12] [--split] [--profile]

Each DIR is a checkout (or an unpacked `git archive` of a commit) whose
`tpusched_torch` is imported on its own: the package's modules are
swapped in `sys.modules` before each solve, so every lazy import
resolves inside the tree that runs. The cell is chip_smoke's (h), or
(h) with spread and inter-pod terms (`hp`), built from chip_smoke's own
constants by each tree's generator and put on the card once per tree;
one solve builds the kernels and warms up. Then `--pairs` rounds each
solve once per tree, in turns (the order reversed every other round, so
a drift of the host weighs on every tree alike), through `Engine.solve`
on the snapshot already on the card.

Prints one JSON line per tree: the card's name and power limit, the
host-clock walls in ms with their median and quartiles, host reads,
placed and evicted pods, and whether its outputs equal the first
tree's. With `--split` (fast mode), the walls' solves also time the
preemption rounds (`kernels.assign._preempt_rounds`, a device sync on
each side) by the host clock, and the line adds their ms and each wall
less them. With `--profile`, one more line per tree: the device ms of each
`RoundStats` span of one solve (CUDA events), the device's busy ms per
solve (the sum of its kernels' times in a torch.profiler trace of 3
solves, or null where the trace holds none), and the 25 functions with
the most host time of their own per solve (cProfile over 3 solves).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity

import chip_smoke

# The cells, as chip_smoke.py builds them: config 5 at its PODS x NODES
# from PRE_SEED, and the same with its spread and inter-pod terms.
CELLS = {"h": {}, "hp": chip_smoke.PRE_PAIR}
PACKAGE = "tpusched_torch"
PROFILE_REPS = 3


def _drop() -> None:
    for name in [m for m in sys.modules if m.split(".")[0] == PACKAGE]:
        del sys.modules[name]


class Tree:
    """One tree's package, engine and the cell's snapshot on the card."""

    def __init__(self, path: str, cell: str, mode: str, split: bool):
        self.path = path
        self.pre_ms = []
        root = Path(path).resolve()
        _drop()
        sys.path.insert(0, str(root))
        try:
            pkg = importlib.import_module(PACKAGE)
            synth = importlib.import_module(PACKAGE + ".synth")
            self.engine_mod = importlib.import_module(PACKAGE + ".engine")
            self.assign = importlib.import_module(PACKAGE + ".kernels.assign")
            if split:
                self._time_preemption()
            snap, _ = synth.config5_preemption(
                np.random.default_rng(chip_smoke.PRE_SEED), chip_smoke.PODS,
                chip_smoke.NODES, **CELLS[cell])
            self.cfg = pkg.EngineConfig(mode=mode, preemption=True)
            self.eng = pkg.Engine(self.cfg)
            self.dsnap = self.eng.put(snap)
            self.res = self.eng.solve(self.dsnap)   # build, warm up
        finally:
            sys.path.remove(str(root))
        self.mods = {k: v for k, v in sys.modules.items()
                     if k.split(".")[0] == PACKAGE}
        self._check(root)

    def _time_preemption(self) -> None:
        rounds = self.assign._preempt_rounds

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rounds(*a, **kw)
            torch.cuda.synchronize()
            self.pre_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.assign._preempt_rounds = timed

    def _check(self, root: Path) -> None:
        for name, mod in self.mods.items():
            f = getattr(mod, "__file__", None)
            if f and root not in Path(f).resolve().parents:
                raise RuntimeError(f"{name} of {self.path} came from {f}")

    def activate(self) -> None:
        _drop()
        sys.modules.update(self.mods)

    def wall(self) -> float:
        self.activate()
        self.pre_ms.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.res = self.eng.solve(self.dsnap)
        return (time.perf_counter() - t0) * 1e3, sum(self.pre_ms)

    def profile(self) -> dict:
        self.activate()
        stats = self.assign.RoundStats(timing=True)
        self.engine_mod.solve_core(self.cfg, self.dsnap, stats=stats)
        spans = stats.ms()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_REPS):
                self.eng.solve(self.dsnap)
            torch.cuda.synchronize()
        busy = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages())
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(PROFILE_REPS):
            self.eng.solve(self.dsnap)
        pr.disable()
        st = pstats.Stats(pr)
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:25]
        return {
            "tree": self.path, "spans_ms": spans,
            "device_busy_ms": busy / 1e3 / PROFILE_REPS if busy else None,
            "host_self_ms": [
                {"fn": f"{Path(f).name}:{line}({fn})",
                 "calls": cc // PROFILE_REPS,
                 "self_ms": tt * 1e3 / PROFILE_REPS,
                 "cum_ms": ct * 1e3 / PROFILE_REPS}
                for (f, line, fn), (cc, _, tt, ct, _) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--cell", choices=sorted(CELLS), default="h")
    ap.add_argument("--mode", choices=("parity", "fast"), default="fast")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_walls: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    split = args.split and args.mode == "fast"
    trees = [Tree(p, args.cell, args.mode, split) for p in args.trees]
    walls = {t.path: [] for t in trees}
    pre = {t.path: [] for t in trees}
    for i in range(args.pairs):
        for t in (trees if i % 2 == 0 else trees[::-1]):
            w, p = t.wall()
            walls[t.path].append(w)
            pre[t.path].append(p)
    ref = trees[0].res
    for t in trees:
        w = walls[t.path]
        q = statistics.quantiles(w, n=4) if len(w) > 1 else [w[0]] * 3
        more = {}
        if split:
            p = pre[t.path]
            more = {"preempt_ms": p, "preempt_median_ms": statistics.median(
                p), "rest_median_ms": statistics.median(
                    a - b for a, b in zip(w, p))}
        same = t.res.rounds == ref.rounds and all(
            np.array_equal(getattr(t.res, f), getattr(ref, f))
            for f in ("assignment", "chosen_score", "final_used", "order",
                      "evicted"))
        print(json.dumps({
            "tree": t.path, "cell": args.cell, "mode": args.mode,
            "card": smi, "walls_ms": w, "median_ms": q[1], "q1_ms": q[0],
            "q3_ms": q[2], "host_reads": t.res.host_reads,
            "placed": int((t.res.assignment >= 0).sum()),
            "evicted": int(t.res.evicted.sum()),
            "equal_to_first_tree": bool(same), **more}))
    if args.profile:
        for t in trees:
            print(json.dumps(t.profile()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
