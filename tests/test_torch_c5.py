"""ROADMAP C5: the victim search's f32 sums, on the CPU.

JAX and the oracle sum each victim prefix as a prefix over all M
victims minus its value at the node segment's start
(`tpusched/kernels/preempt.py:278-297`). The subtraction cancels: on
BASELINE config 5 the sum grows with M, and the fits and near-equal
costs then follow the order of the adds. The port sums within each
segment (`kernels/preempt.segment_prefix`). The test holds the port's
pick to the exact one (the lexicographic minimum of (violations, cost)
over prefixes that fit, with the sums and the fit in f64) on every
search of a small config-5 solve.

Run as a script for the numbers ROADMAP C5 records (from the repository
root):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c5.py picks 2000 1000 400
        along the port's plain parity solve of config5_preemption(rng(45),
        2000, 1000), its first 400 searches: how often the port's pick,
        JAX's `preempt_step` and the JAX association in the port's order
        (a left-to-right prefix over all M minus the segment offset) on
        the same states equal the exact pick, and the searches where
        JAX's does not;
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c5.py used
        final_used of the port, the JAX engine and the oracle on the JAX
        tests' preemption clusters: the entries where they differ.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.kernels import preempt as jpre
from tpusched.oracle import Oracle
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import preempt as tpre
from tpusched_torch.snapshot import snapshot_from_numpy


def searches(P: int, N: int, limit: int, seed: int = 45):
    """The (JAX snapshot, port snapshot, victim table, states) of the
    first `limit` searches of the port's plain parity solve of
    config5_preemption(rng(seed), P, N) with preemption: each state is
    preempt_step_plain's arguments when the search ran."""
    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed), P, N)
    snap = snapshot_from_numpy(jax.device_get(jsnap))
    cfg = EngineConfig(preemption=True)
    states = []
    orig = tpre.preempt_step_plain

    class Enough(Exception):
        pass

    def record(*args):
        states.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args))
        if len(states) >= limit:
            raise Enough
        return orig(*args)

    static = tassign.precompute_static(cfg, snap, *_sat_tables(snap))
    order = tassign.pop_order(cfg, snap)
    ctx = tpre.precompute(cfg, snap)
    tpre.preempt_step_plain = record
    try:
        tassign._scan_loop(cfg, snap, static, order, pctx=ctx)
    except Enough:
        pass
    finally:
        tpre.preempt_step_plain = orig
    return jsnap, snap, ctx, states


def exact_pick(snap, ctx, state) -> int:
    """The exact pick's node (-1: none): the port's eligibility and
    violation counts (integers), the sums and the fit in f64."""
    cfg, _, _, prio, req, allowed, used, evicted = state
    elig, _, wviol, _, _ = tpre.tableau_plain(
        cfg, snap, ctx, prio, req, used, evicted,
        tpre.pdb_remaining(snap, evicted))
    e = elig.numpy()
    node = ctx.node_s.numpy()
    seg = ctx.seg_start.numpy()
    vals = np.concatenate([ctx.req_s.numpy(), ctx.cost_s.numpy()[:, None]],
                          axis=1).astype(np.float64) * e[:, None]
    within = np.zeros_like(vals)
    for i in np.nonzero(e)[0]:
        within[i] = vals[seg[i]:i + 1].sum(axis=0)
    N, R = used.shape
    n = np.minimum(node, N - 1)
    u = used.numpy().astype(np.float64)
    alloc = snap.nodes.allocatable.numpy().astype(np.float64)
    fits = e & ((u[n] - within[:, :R] + req.numpy().astype(np.float64)
                 <= alloc[n]).all(axis=1))
    ok = (fits & (node < N) & allowed.numpy()[n]
          & snap.nodes.valid.numpy()[n])
    if not ok.any():
        return -1
    wv = wviol.numpy()
    cand = ok & (wv == wv[ok].min())
    cost = within[:, R]
    return int(node[np.nonzero(cand & (cost == cost[cand].min()))[0][0]])


def _port_pick(state) -> int:
    best, can, _, _ = tpre.preempt_step_plain(*state)
    return int(best) if bool(can) else -1


def _jax_pick(jsnap, jctx, state) -> int:
    _, _, _, prio, req, allowed, used, evicted = state
    best, can, _, _ = jpre.preempt_step(
        JConfig(preemption=True), jsnap, jctx, jnp.float32(prio.item()),
        jnp.asarray(req.numpy()), jnp.asarray(allowed.numpy()),
        jnp.asarray(used.numpy()), jnp.asarray(evicted.numpy()))
    return int(best) if bool(can) else -1


def _global(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The JAX association in the port's order: one prefix over all M
    rows, left to right from 0.0, minus its value at the segment's
    start."""
    M = x.shape[0]
    # numpy's cumsum accumulates in order, in the array's f32.
    cum = torch.from_numpy(np.cumsum(x.numpy(), axis=0, dtype=np.float32))
    idx = torch.arange(M)
    seg = torch.cummax(torch.where(start, idx, 0), dim=0).values
    off = torch.where((seg > 0)[:, None], cum[(seg - 1).clamp(min=0)], 0.0)
    return cum - off


@pytest.mark.parametrize("seed", [45, 46])
def test_port_picks_the_exact_prefix(seed):
    """Every search of the port's parity solve of config 5 at 400 x 100
    (the segment sums) picks the exact lexicographic minimum."""
    _, snap, ctx, states = searches(400, 100, 10_000, seed)
    assert len(states) > 100
    for k, st in enumerate(states):
        assert _port_pick(st) == exact_pick(snap, ctx, st), k


def _report_picks(P: int, N: int, limit: int) -> None:
    jsnap, snap, ctx, states = searches(P, N, limit)
    jctx = jpre.precompute(JConfig(preemption=True), jsnap)
    counts = dict(port=0, jax=0, jax_association=0)
    orig = tpre.segment_prefix
    for k, st in enumerate(states):
        want = exact_pick(snap, ctx, st)
        port = _port_pick(st)
        jax_n = _jax_pick(jsnap, jctx, st)
        tpre.segment_prefix = _global
        try:
            glob = _port_pick(st)
        finally:
            tpre.segment_prefix = orig
        counts["port"] += port == want
        counts["jax"] += jax_n == want
        counts["jax_association"] += glob == want
        if jax_n != want:
            print(f"search {k}: exact {want}, port {port}, JAX {jax_n}, "
                  f"JAX association in the port's order {glob}")
    print(f"{len(states)} searches on config5_preemption(rng(45), {P}, {N});"
          f" the exact pick: " + ", ".join(f"{k} {v}"
                                           for k, v in counts.items()))


def _report_used() -> None:
    cases = [("test_pdb fuzz seed 1", jsynth.make_cluster(
        np.random.default_rng(4201), 30, 8, initial_utilization=0.9,
        n_running_per_node=6, pdb_frac=0.5)[0])]
    for seed in (45, 46):
        cases.append((f"config5 48x12 seed {seed}", jsynth.config5_preemption(
            np.random.default_rng(seed), 48, 12)[0]))
    cases.append(("config5 400x100 seed 45", jsynth.config5_preemption(
        np.random.default_rng(45), 400, 100)[0]))
    jcfg = JConfig(preemption=True)
    for name, jsnap in cases:
        jeng = JEngine(jcfg)
        jres = jeng.solve(jsnap)
        jeng.close()
        tres = Engine(EngineConfig(preemption=True), device="cpu").solve(
            snapshot_from_numpy(jax.device_get(jsnap)))
        ores = Oracle(jsnap, jcfg).solve()
        ju = np.asarray(jres.final_used)
        diff_o = np.argwhere(tres.final_used != ores.final_used)
        print(f"{name}: port == JAX final_used "
              f"{np.array_equal(tres.final_used, ju)}, entries differing "
              f"from the oracle {len(diff_o)}; assignment and evicted equal "
              f"to both: "
              f"{np.array_equal(tres.assignment, ores.assignment)}, "
              f"{np.array_equal(tres.evicted, ores.evicted)}")
        for i in map(tuple, diff_o):
            print(f"  final_used{list(i)}: port {int(tres.final_used[i])}, "
                  f"JAX {int(ju[i])}, oracle {int(ores.final_used[i])}")


if __name__ == "__main__":
    if sys.argv[1] == "picks":
        _report_picks(*map(int, sys.argv[2:5]))
    else:
        _report_used()
