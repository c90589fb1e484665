#!/usr/bin/env python3
"""Steady solve walls of chip_smoke.py's cells, from one or more source
trees in one process.

    python3 solve_walls.py --trees DIR [DIR ...] [--cells a c d h th ...]
        [--mode fast|parity|score] [--pairs 12] [--split] [--profile]

Each DIR is a checkout (or an unpacked `git archive` of a commit) whose
`tpusched_torch` is imported on its own: the package's modules are
swapped in `sys.modules` before each solve, so every lazy import
resolves inside the tree that runs. A cell is one of chip_smoke's: (a)
config 2 at its PODS x NODES with QoS, (b) (a) with its constraints, (c)
(a) with the seeded tie-break, (d) config 3 (spread and inter-pod
terms), (h) config 5 with preemption, `hp` (h) with spread and inter-pod
terms, the tenant batch (t) (eight config-2 tenants with (b)'s
constraints), the tenant batches with preemption (th) and (thp) (eight
config-5 tenants under one floor, solved by `solve_many`), `ths` and
`thps` the same with the seeded tie-break, `t9` nine tenants of (a)'s
size, and `k4q1`, `k4q2`, `k4q4`, `k4q8` K4 alone on (a)'s parity scan
at cluster size 1, 2, 4, 8 (parity mode; a tree whose scan takes
`cluster`). Each tree's
generator builds the cell from chip_smoke's own constants and puts it on
the card once; one solve builds the kernels and warms up. Then `--pairs`
rounds each solve once per tree, in turns (the order reversed every
other round, so a drift of the host weighs on every tree alike), through
`Engine.solve` on the snapshot already on the card (`solve_many` and a
read of its outputs for a batch). `--mode score` times ScoreBatch
instead: `Engine.score_topk(k=8)` on a one-snapshot cell (K1-K3, K5 over
every [P, N] cell, K6; the matrix stays on the card). The cells run one
after another.

Prints one JSON line per tree and cell: the card's name and power
limit, the host-clock walls in ms with their median and quartiles, host
reads, placed and evicted pods, and whether its outputs equal the first
tree's; exits 1 after the last cell if any tree's outputs did not. With `--split` (fast mode), the walls' solves also time the
preemption rounds (`kernels.assign._preempt_rounds`, a device sync on
each side) by the host clock, and the line adds their ms and each wall
less them. With `--profile` (one-snapshot cells), one more line per
tree: the device ms of each `RoundStats` span of one solve (CUDA
events), the device's busy ms per solve (the sum of its kernels' times
in a torch.profiler trace of 3 solves, or null where the trace holds
none), and the 25 functions with the most host time of their own per
solve (cProfile over 3 solves).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
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

# The cells, as chip_smoke.py builds them: (generator, seed, its keyword
# arguments, EngineConfig fields); th and thp are eight tenants.
CS = chip_smoke
CELLS = {
    "a": ("config2_scale", CS.SEED, dict(with_qos=True), {}),
    "b": ("config2_scale", CS.SEED, dict(with_qos=True, **CS.CONSTRAINED),
          {}),
    "c": ("config2_scale", CS.SEED, dict(with_qos=True),
          dict(tie_break="seeded", tie_seed=CS.SEED)),
    "d": ("config3_pairwise", CS.PAIR_SEED, {}, {}),
    "h": ("config5_preemption", CS.PRE_SEED, {}, dict(preemption=True)),
    "hp": ("config5_preemption", CS.PRE_SEED, CS.PRE_PAIR,
           dict(preemption=True)),
    "t": ("config2_scale", CS.TENANT_SEED,
          dict(with_qos=True, **CS.CONSTRAINED), {}),
    "th": ("config5_preemption", CS.PRE_TENANT_SEED, {},
           dict(preemption=True)),
    "thp": ("config5_preemption", CS.PRE_PAIR_TENANT_SEED, CS.PRE_PAIR,
            dict(preemption=True)),
    "ths": ("config5_preemption", CS.PRE_TENANT_SEED, {},
            dict(preemption=True, tie_break="seeded", tie_seed=CS.SEED)),
    "thps": ("config5_preemption", CS.PRE_PAIR_TENANT_SEED, CS.PRE_PAIR,
             dict(preemption=True, tie_break="seeded", tie_seed=CS.SEED)),
    "t9": ("config2_scale", CS.SEED, dict(with_qos=True), {}),
    "k4q1": ("config2_scale", CS.SEED, dict(with_qos=True), {}),
    "k4q8": ("config2_scale", CS.SEED, dict(with_qos=True), {}),
}
CELLS["k4q2"] = CELLS["k4q4"] = CELLS["k4q1"]
# The tenant batches: (tenants, tenant 0's pods, pods fewer a tenant,
# nodes, fixed fields of the floor). t9 is nine tenants of (a)'s size
# (the policy's Q = 8 at N = 5 120).
TENANT_SHAPE = {
    c: (CS.TENANTS, CS.TENANT_PODS, CS.TENANT_STEP, CS.TENANT_NODES, {})
    for c in ("th", "thp", "ths", "thps")}
TENANT_SHAPE["t"] = (CS.TENANTS, CS.TENANT_PODS, CS.TENANT_STEP,
                     CS.TENANT_NODES, dict(signatures=0))
TENANT_SHAPE["t9"] = (9, CS.PODS, 0, CS.NODES, dict(signatures=0))
TENANT_CELLS = tuple(TENANT_SHAPE)
# K4 alone at a given cluster size Q, on the arguments of (a)'s solve
# (its one parity scan), then a device sync.
K4_CELLS = {"k4q1": 1, "k4q2": 2, "k4q4": 4, "k4q8": 8}
PACKAGE = "tpusched_torch"
PROFILE_REPS = 3
RESULT_FIELDS = ("assignment", "chosen_score", "final_used", "order",
                 "evicted")


def _drop() -> None:
    for name in [m for m in sys.modules if m.split(".")[0] == PACKAGE]:
        del sys.modules[name]


class Tree:
    """One tree's package, engine and the cell's snapshot (or tenant
    stack) on the card."""

    def __init__(self, path: str, cell: str, mode: str, split: bool):
        self.path = path
        self.cell = cell
        self.pre_ms = []
        root = Path(path).resolve()
        _drop()
        sys.path.insert(0, str(root))
        try:
            pkg = importlib.import_module(PACKAGE)
            synth = importlib.import_module(PACKAGE + ".synth")
            config = importlib.import_module(PACKAGE + ".config")
            self.engine_mod = importlib.import_module(PACKAGE + ".engine")
            self.assign = importlib.import_module(PACKAGE + ".kernels.assign")
            if split:
                self._time_preemption()
            gen, seed, kw, cfg_kw = CELLS[cell]
            draw = getattr(synth, gen)
            self.score = mode == "score"
            self.cfg = pkg.EngineConfig(
                mode="parity" if self.score else mode, **cfg_kw)
            if cell in TENANT_CELLS:
                n, pods, step, nodes, fixed = TENANT_SHAPE[cell]
                built = CS.floored(lambda b, **x: draw(
                    np.random.default_rng(seed + b), pods - step * b, nodes,
                    **kw, **x), n, buckets=config.Buckets, **fixed)
                self.dsnap = pkg.stack_snapshots(
                    [s for s, _ in built]).to("cuda")
                self.run = self._batch(pkg)
            elif cell in K4_CELLS:
                snap, _ = draw(np.random.default_rng(seed), CS.PODS,
                               CS.NODES, **kw)
                self.run = self._k4(pkg.Engine(self.cfg).put(snap),
                                    K4_CELLS[cell])
            else:
                snap, _ = draw(np.random.default_rng(seed), CS.PODS,
                               CS.NODES, **kw)
                self.eng = pkg.Engine(self.cfg)
                self.dsnap = self.eng.put(snap)
                self.run = ((lambda: self.eng.score_topk(self.dsnap, 8))
                            if self.score else
                            (lambda: self.eng.solve(self.dsnap)))
            self.res = self.run()   # build, warm up
        finally:
            sys.path.remove(str(root))
        self.mods = {k: v for k, v in sys.modules.items()
                     if k.split(".")[0] == PACKAGE}
        self._check(root)

    def _batch(self, pkg):
        """solve_many on the stack, its outputs read back; the host reads
        of the last run kept."""
        def run():
            stats = self.assign.RoundStats()
            out = [t.cpu() for t in pkg.solve_many(self.cfg, self.dsnap,
                                                   stats=stats)]
            self.reads = stats.host_reads
            return out

        return run

    def _k4(self, dsnap, q: int):
        """A call of K4 at cluster size q on the arguments of dsnap's
        parity scan (recorded from one solve), synced."""
        seen = []

        def rec(*a):
            seen.append(a)
            return self.assign.parity_scan(*a)

        ops = dataclasses.replace(self.assign.KERNELS, parity_scan=rec)
        self.engine_mod.solve_core(self.cfg, dsnap, ops=ops)
        args = seen[0]

        def run():
            out = self.assign.parity_scan(*args, cluster=q)
            torch.cuda.synchronize()
            return out

        return run

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
        self.res = self.run()
        return (time.perf_counter() - t0) * 1e3, sum(self.pre_ms)

    def summary(self, ref: "Tree") -> dict:
        """Host reads, placed and evicted pods, and whether the outputs
        equal `ref`'s."""
        if self.score:
            return {"equal_to_first_tree": all(
                np.array_equal(a, b) for a, b in zip(self.res[:2],
                                                     ref.res[:2]))}
        if self.cell in TENANT_CELLS or self.cell in K4_CELLS:
            reads = ({"host_reads": self.reads}
                     if self.cell in TENANT_CELLS else {})
            return {**reads, "placed": int((self.res[0] >= 0).sum()),
                    "evicted": (int(self.res[5].sum())
                                if self.cell in TENANT_CELLS else 0),
                    "equal_to_first_tree": all(
                        torch.equal(a, b) for a, b in zip(self.res,
                                                          ref.res))}
        return {"host_reads": self.res.host_reads,
                "placed": int((self.res.assignment >= 0).sum()),
                "evicted": int(self.res.evicted.sum()),
                "equal_to_first_tree": self.res.rounds == ref.res.rounds
                and all(np.array_equal(getattr(self.res, f),
                                       getattr(ref.res, f))
                        for f in RESULT_FIELDS)}

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
    ap.add_argument("--cells", nargs="+", choices=sorted(CELLS),
                    default=["h"])
    ap.add_argument("--mode", choices=("parity", "fast", "score"),
                    default="fast")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    batch = [c for c in args.cells if c in TENANT_CELLS or c in K4_CELLS]
    if args.mode == "score" and batch:
        ap.error("--mode score times Engine.score_topk on a one-snapshot "
                 f"cell, not on {', '.join(batch)}")
    if not torch.cuda.is_available():
        print("solve_walls: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    split = args.split and args.mode == "fast"
    unequal = []
    for cell in args.cells:
        trees = [Tree(p, cell, args.mode, split) for p in args.trees]
        walls = {t.path: [] for t in trees}
        pre = {t.path: [] for t in trees}
        for i in range(args.pairs):
            for t in (trees if i % 2 == 0 else trees[::-1]):
                w, p = t.wall()
                walls[t.path].append(w)
                pre[t.path].append(p)
        for t in trees:
            w = walls[t.path]
            q = statistics.quantiles(w, n=4) if len(w) > 1 else [w[0]] * 3
            summary = t.summary(trees[0])
            if not summary["equal_to_first_tree"]:
                unequal.append(f"{cell}: {t.path}")
            more = {}
            if split:
                p = pre[t.path]
                more = {"preempt_ms": p,
                        "preempt_median_ms": statistics.median(p),
                        "rest_median_ms": statistics.median(
                            a - b for a, b in zip(w, p))}
            print(json.dumps({
                "tree": t.path, "cell": cell, "mode": args.mode,
                "card": smi, "walls_ms": w, "median_ms": q[1],
                "q1_ms": q[0], "q3_ms": q[2], **summary,
                **more}), flush=True)
        if (args.profile and not args.mode == "score"
                and cell not in TENANT_CELLS + tuple(K4_CELLS)):
            for t in trees:
                print(json.dumps(t.profile()), flush=True)
        del trees
        torch.cuda.empty_cache()
    if unequal:
        print("solve_walls: outputs differ from the first tree's: "
              + ", ".join(unequal), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
