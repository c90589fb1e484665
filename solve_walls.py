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
constraints), (tp) eight config-3 tenants under one floor, the tenant batches with preemption (th) and (thp) (eight
config-5 tenants under one floor, solved by `solve_many`), `ths` and
`thps` the same with the seeded tie-break, `t9` nine tenants of (a)'s
size, and `k4q1`, `k4q2`, `k4q4`, `k4q8` K4 alone on (a)'s parity scan
at cluster size 1, 2, 4, 8 (parity mode; a tree whose scan takes
`cluster`). The kernel cells time one kernel wrapper alone, by CUDA
events (the median of KERNEL_REPS calls a turn) and, once a tree, by
the profiler: `k6s8`, `k6s16` K6 seeded at K = 8, 16 on (b)'s first fast
round (every valid pod pending), `k6u1`, `k6u4`, `k6u8`, `k6u16` the
same unseeded at K = 1, 4, 8, 16, `k6v8`, `k6v8u` a 1 024-row view of it
(the first 1 024 pods in pop order) at K = 8, seeded and not; `k2b` K2
on (b), `k2t` K2 on the tenant stack (t), `k2w` K2 on 128 gathered pod
rows of the warm lineage (w)'s snapshot against every node (a 1 %
value churn, padded, as `refresh_tableau` passes them); `k13d`, `k12d`
`_spread_excess_mask` and `_spread_waterfill_deal` (K13 and K12 with
the torch steps around them) on the arguments of their first call in a
fast solve of (d), `k13tp`, `k12tp` the same in (tp)'s fast batch (the
profiler line: the device time of every K13 kernel, of K12's kernel);
`k10d`, `k10tp` K10's commit on its first call's arguments in a fast
solve of (d), (tp) (the timed calls alternate the sign on one working
state; a tree whose commit copies its state copies it); `k23b`, `k23d`,
`k23t` the round's hand-off from K7's desirability to K8's lists
(`_deal_commit` on its first call's arguments, K7 answered by the
recorded desirability, the events from the call to K8's, which is cut
off; the profiler line: every kernel the hand-off runs) in (b), (d) and
(t). Each tree's
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
    "tp": ("config3_pairwise", CS.PAIR_TENANT_SEED, {}, {}),
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
# The kernel cells: (the cell whose snapshot feeds it, what it times).
KERNEL_CELLS = {
    **{f"k6s{k}": ("b", ("topk", k, True, False)) for k in (8, 16)},
    **{f"k6u{k}": ("b", ("topk", k, False, False)) for k in (1, 4, 8, 16)},
    "k6v8": ("b", ("topk", 8, True, True)),
    "k6v8u": ("b", ("topk", 8, False, True)),
    "k2b": ("b", ("tableau",)), "k2t": ("t", ("tableau",)),
    "k2w": ("w", ("tableau_rows",)),
    "k13d": ("d", ("excess",)), "k12d": ("d", ("waterfill",)),
    "k13tp": ("tp", ("excess",)), "k12tp": ("tp", ("waterfill",)),
    "k10d": ("d", ("commit",)), "k10tp": ("tp", ("commit",)),
    "k23b": ("b", ("handoff",)), "k23d": ("d", ("handoff",)),
    "k23t": ("t", ("handoff",)),
}
CELLS.update({c: CELLS[src] for c, (src, _) in KERNEL_CELLS.items()
              if src in CELLS})
CELLS["k2w"] = ("make_cluster", CS.WARM_SEED,
                dict(n_running_per_node=1, with_qos=True), {})
KERNEL_REPS = 10
VIEW_ROWS = 1024
WARM_ROWS = 128
# The tenant batches: (tenants, tenant 0's pods, pods fewer a tenant,
# nodes, fixed fields of the floor). t9 is nine tenants of (a)'s size
# (the policy's Q = 8 at N = 5 120).
TENANT_SHAPE = {
    c: (CS.TENANTS, CS.TENANT_PODS, CS.TENANT_STEP, CS.TENANT_NODES, {})
    for c in ("th", "thp", "ths", "thps")}
TENANT_SHAPE["t"] = (CS.TENANTS, CS.TENANT_PODS, CS.TENANT_STEP,
                     CS.TENANT_NODES, dict(signatures=0))
TENANT_SHAPE["t9"] = (9, CS.PODS, 0, CS.NODES, dict(signatures=0))
TENANT_SHAPE["tp"] = (CS.TENANTS, CS.TENANT_PODS, CS.TENANT_STEP,
                      CS.TENANT_NODES, {})
TENANT_SHAPE["k2t"] = TENANT_SHAPE["t"]
TENANT_SHAPE["k13tp"] = TENANT_SHAPE["k12tp"] = TENANT_SHAPE["tp"]
TENANT_SHAPE["k10tp"] = TENANT_SHAPE["tp"]
TENANT_SHAPE["k23t"] = TENANT_SHAPE["t"]
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
        self.kernel_ms = None
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
                self.run = (self._kernel(pkg, self.dsnap)
                            if cell in KERNEL_CELLS else self._batch(pkg))
            elif cell in K4_CELLS:
                snap, _ = draw(np.random.default_rng(seed), CS.PODS,
                               CS.NODES, **kw)
                self.run = self._k4(pkg.Engine(self.cfg).put(snap),
                                    K4_CELLS[cell])
            elif cell in KERNEL_CELLS:
                snap = draw(np.random.default_rng(seed), CS.PODS, CS.NODES,
                            **kw)[0]
                self.run = self._kernel(pkg, pkg.Engine(self.cfg).put(snap))
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

    def _kernel(self, pkg, dsnap):
        """One call of the kernel cell's wrapper on its arguments (built
        once, as chip_smoke's kernel phase builds them), synced."""
        what = KERNEL_CELLS[self.cell][1]
        a = self.assign
        sat = self.engine_mod._sat_tables(dsnap)[0]
        if what[0] == "tableau_rows":
            P = dsnap.pods.valid.shape[-1]
            rows = torch.from_numpy(np.random.default_rng(CS.WARM_SEED)
                                    .choice(P, WARM_ROWS, replace=False))
            pods = a.permute_rows(dsnap.pods, rows.sort()[0].to("cuda"))
            fn = lambda: a._tableau_cells(dsnap, pods, dsnap.nodes, sat)
        elif what[0] == "tableau":
            fn = lambda: a._tableau_cells(dsnap, dsnap.pods, dsnap.nodes, sat)
        elif what[0] in ("excess", "waterfill"):
            name = ("_spread_excess_mask" if what[0] == "excess"
                    else "_spread_waterfill_deal")
            args = self._first_call(pkg, dsnap, name)
            fn = lambda: getattr(a, name)(*args)
        elif what[0] == "commit":
            return self._commit(pkg, dsnap)
        elif what[0] == "handoff":
            return self._handoff(pkg, dsnap)
        else:
            _, K, seeded, view = what
            static = a.precompute_static(self.cfg, dsnap, sat)
            nodes, pods = dsnap.nodes, dsnap.pods
            masked = a.cycle(nodes.allocatable, nodes.used, pods.requests,
                             static.mask, static.score, static.w_lr,
                             static.w_ba, static.w_ts, static.rw,
                             pending=pods.valid, masked=True)[1]
            if view:
                order = a.pop_order(self.cfg, dsnap)[:VIEW_ROWS]
                masked = masked[order.long()].contiguous()
            ids = torch.arange(masked.shape[0], dtype=torch.int32,
                               device=masked.device)
            fn = ((lambda: a.row_topk(masked, K, True, CS.SEED, ids))
                  if seeded else (lambda: a.row_topk(masked, K)))
        self.kernel_fn = fn

        def run():
            out = fn()
            torch.cuda.synchronize()
            return out if isinstance(out, tuple) else (out,)

        return run

    def _solve_fast(self, pkg, dsnap, ops=None) -> None:
        cfg = dataclasses.replace(self.cfg, mode="fast")
        ops = ops or self.assign.KERNELS
        if self.cell in TENANT_CELLS:
            pkg.solve_many(cfg, dsnap, ops=ops)
        else:
            self.engine_mod.solve_core(cfg, dsnap, ops=ops)

    def _commit(self, pkg, dsnap):
        """K10's commit on the arguments (state and all cloned) of its
        first call in a fast solve: the timed calls alternate the sign on
        one working state (a tree whose commit adds in place then makes
        no copy; one that copies, copies); the compared output is one +1
        commit into a fresh copy."""
        a, kp = self.assign, importlib.import_module(
            PACKAGE + ".kernels.pairwise")
        real, seen = kp.pair_commit, []

        def rec(*args):
            if not seen:
                seen.append(tuple(
                    kp.copy_state(x) if isinstance(x, kp.PairState)
                    else x.clone() if isinstance(x, torch.Tensor) else x
                    for x in args[:6]))
            return real(*args)

        self._solve_fast(pkg, dsnap, dataclasses.replace(
            a.KERNELS, pair_commit=rec))
        snap, st0, *rest = seen[0]
        work, sign = kp.copy_state(st0), [1.0]

        def fn():
            out = kp.pair_commit(snap, work, *rest, sign[0])
            sign[0] = -sign[0]
            return out

        self.kernel_fn = fn

        def run():
            out = kp.pair_commit(snap, kp.copy_state(st0), *rest, 1.0)
            torch.cuda.synchronize()
            return (out.counts, out.anti, out.match_tot)

        return run

    def _handoff(self, pkg, dsnap):
        """The fast round's hand-off from K7's desirability to K8's lists
        (`_deal_commit` with its K7 call answered by the recorded
        desirability and its K8 call cut off), on the arguments of the
        first `_deal_commit` call in a fast solve: timed by CUDA events
        from the call to K8's, and the lists compared."""
        a = self.assign
        real, seen = a._deal_commit, []

        def rec(*args, **kw):
            if not seen:
                clone = lambda x: (x.clone() if isinstance(x, torch.Tensor)
                                   else tuple(map(clone, x))
                                   if isinstance(x, tuple) else x)
                seen.append((clone(args), {k: clone(v)
                                           for k, v in kw.items()}))
            return real(*args, **kw)

        a._deal_commit = rec
        try:
            self._solve_fast(pkg, dsnap)
        finally:
            a._deal_commit = real
        args, kw = seen[0]
        alloc, requests, used, feasible, masked, allowed = args[:6]
        fixed = kw.get("cum_width") is not None
        desir = a.KERNELS.desirability(feasible, masked, allowed,
                                       **({"fixed": True} if fixed else {}))

        class Cut(Exception):
            pass

        ev = {}

        def k8(topi, topv, *rest):
            ev["end"].record()
            ev["out"] = (topi, topv)
            raise Cut

        ops = dataclasses.replace(
            a.KERNELS, desirability=lambda *x, **k: desir,
            prefix_commit_loop=k8)

        def once():
            ev["start"] = torch.cuda.Event(enable_timing=True)
            ev["end"] = torch.cuda.Event(enable_timing=True)
            ev["start"].record()
            try:
                a._deal_commit(*args, **dict(kw, ops=ops))
            except Cut:
                pass
            return ev["out"]

        def ms():
            once()
            times = []
            for _ in range(KERNEL_REPS):
                once()
                ev["end"].synchronize()
                times.append(ev["start"].elapsed_time(ev["end"]))
            return statistics.median(times)

        self.kernel_fn, self.kernel_ms = once, ms

        def run():
            out = once()
            torch.cuda.synchronize()
            return out

        return run

    def _first_call(self, pkg, dsnap, name: str) -> tuple:
        """The arguments (tensors cloned) of the first call of the
        assign module's `name` in a fast solve of dsnap (solve_many for a
        stack): the first round's K12 or K13 call, through KERNELS."""
        a = self.assign
        real, seen = getattr(a, name), []
        n = 7 if name == "_spread_excess_mask" else 9   # before `ops`

        def rec(*args):
            if not seen:
                seen.append(tuple(x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in args[:n]))
            return real(*args)

        cfg = dataclasses.replace(self.cfg, mode="fast")
        setattr(a, name, rec)
        try:
            if self.cell in TENANT_CELLS:
                pkg.solve_many(cfg, dsnap)
            else:
                pkg.Engine(cfg).solve(dsnap)
        finally:
            setattr(a, name, real)
        return (*seen[0], a.KERNELS)

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
        if self.cell in KERNEL_CELLS:
            self.res = self.run()
            if self.kernel_ms is not None:
                return self.kernel_ms(), 0.0
            return CS.cuda_ms(self.kernel_fn, KERNEL_REPS), 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.res = self.run()
        return (time.perf_counter() - t0) * 1e3, sum(self.pre_ms)

    def summary(self, ref: "Tree") -> dict:
        """Host reads, placed and evicted pods, and whether the outputs
        equal `ref`'s."""
        if self.cell in KERNEL_CELLS:
            self.activate()
            # k23: every kernel the hand-off runs (the name "" holds in
            # each).
            kernel = ("" if self.cell.startswith("k23")
                      else "tableau_kernel" if self.cell.startswith("k2")
                      else "excess" if self.cell.startswith("k13")
                      else "waterfill_kernel" if self.cell.startswith("k12")
                      else "pair_commit_kernel" if self.cell.startswith("k10")
                      else "row_topk")
            return {"profiler_ms": CS.profiler_ms(self.kernel_fn, kernel),
                    "equal_to_first_tree": all(
                        (a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(self.res, ref.res))}
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
    batch = [c for c in args.cells
             if c in TENANT_CELLS or c in K4_CELLS or c in KERNEL_CELLS]
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
                and cell not in (*TENANT_CELLS, *K4_CELLS, *KERNEL_CELLS)):
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
