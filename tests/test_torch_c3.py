"""ROADMAP C3: where the port's fast rounds and the JAX fast engine part
ways on the constrained config-2 cell, on the CPU.

The test holds the port's `_deal_commit` (plain versions) to JAX's on the
same round-0 inputs (the port's feasibility and masked scores): given the
node desirability that XLA computes, the port deals and commits exactly
as JAX does. So the only f32 order in round 0 that can tell the two
apart is the desirability column sum (`tpusched/kernels/assign.py:795`),
whose order JAX leaves to XLA. Seed 2 at 2 000 x 1 000 is a case where
the two sums order two nodes differently and 11 choices differ.

Run as a script for the numbers ROADMAP C3 records (from the repository
root):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c3.py b 4000 2000
        round 0 of chip_smoke's cell (b) generator at that size: the
        choices that differ, the nodes whose order swaps with both
        desirabilities and their f64 means, and how many columns of
        XLA's sum each of a set of fixed summation orders reproduces;
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c3.py d 4000 2000
        the placed counts of the port's parity solve, the JAX fast
        engine and the port's fast solve on cell (d)'s generator at that
        size (the b report ends with the fast solves' counts too).
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import synth as jsynth
from tpusched.kernels import assign as jassign
from tpusched_torch import EngineConfig
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.snapshot import snapshot_from_numpy

# chip_smoke.py's cell (b) on top of config2_scale.
CONSTRAINED = dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.05)


def _j(x: torch.Tensor):
    return jnp.asarray(x.numpy())


def round0(P: int, N: int, seed: int) -> dict:
    """Round 0 of the fast rounds on config2_scale(rng(seed), P, N) with
    cell (b)'s constraints: the port's inputs, its deal, JAX's deal on
    the same inputs, XLA's desirability, and the port's deal with it."""
    jsnap, _ = jsynth.config2_scale(np.random.default_rng(seed), P, N,
                                    with_qos=True, **CONSTRAINED)
    snap = snapshot_from_numpy(jax.device_get(jsnap))
    cfg = EngineConfig(mode="fast")
    st = tassign.precompute_static(cfg, snap, _sat_tables(snap)[0])
    order = tassign.pop_order(cfg, snap)
    rank = torch.zeros(order.shape[0], dtype=torch.int32)
    rank[order] = torch.arange(order.shape[0], dtype=torch.int32)
    K = tassign._fallback_depth(snap.nodes.valid.shape[0])
    alloc, used = snap.nodes.allocatable, snap.nodes.used
    req = snap.pods.requests
    feasible, masked = tassign.cycle_plain(
        alloc, used, req, st.mask, st.score, st.w_lr, st.w_ba, st.w_ts,
        st.rw, pending=snap.pods.valid, masked=True)
    allowed = feasible.any(dim=1)
    topv, topi, _ = tassign.row_topk_plain(masked, K)
    args = (alloc, req, used, feasible, masked, allowed, rank, topv, topi)
    _, choice, _ = tassign._deal_commit(*args, ops=tassign.PLAIN)
    jchoice = np.asarray(jax.jit(
        jassign._deal_commit, static_argnames=("K", "rank_is_sorted"))(
        *(_j(t) for t in args[:7]), K=K)[1])
    xla_desir = torch.from_numpy(np.array(jax.jit(
        lambda f, m, a: jnp.sum(jnp.where(f & a[:, None], m, 0.0), axis=0)
        / jnp.maximum(a.sum(), 1))(_j(feasible), _j(masked), _j(allowed))))
    ops = dataclasses.replace(tassign.PLAIN,
                              desirability=lambda *a, **k: xla_desir)
    _, choice_x, _ = tassign._deal_commit(*args, ops=ops)
    return dict(snap=snap, jsnap=jsnap, rank=rank, feasible=feasible,
                masked=masked, allowed=allowed, choice=choice.numpy(),
                jchoice=jchoice, xla_desir=xla_desir.numpy(),
                choice_x=choice_x.numpy())


@pytest.mark.parametrize("P,N,seed", [(1000, 500, 0), (2000, 1000, 0),
                                      (2000, 1000, 2)])
def test_round0_deal_equals_jax_given_xla_desirability(P, N, seed):
    """With XLA's desirability in place of K7's, the port's round-0
    deal (dealing prefixes, capacity prefix sub-steps, rescue) equals
    the JAX deal on the same inputs, choice for choice."""
    r = round0(P, N, seed)
    assert r["allowed"].any()
    np.testing.assert_array_equal(r["choice_x"], r["jchoice"])


def _seq(x: np.ndarray) -> np.ndarray:
    acc = np.zeros(x.shape[1], np.float32)
    for row in x:
        acc = (acc + row).astype(np.float32)
    return acc


def _tree(x: np.ndarray) -> np.ndarray:
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
        x = (x[0::2] + x[1::2]).astype(np.float32)
    return x[0]


def _report_b(P: int, N: int, seed: int = 42) -> None:
    r = round0(P, N, seed)
    d = np.nonzero(r["choice"] != r["jchoice"])[0]
    print(f"round 0, {P}x{N} seed {seed}: {d.size} choices differ, "
          f"{int((r['choice_x'] != r['jchoice']).sum())} with XLA's "
          f"desirability; pods {d.tolist()} ranks "
          f"{r['rank'].numpy()[d].tolist()} port {r['choice'][d].tolist()} "
          f"JAX {r['jchoice'][d].tolist()}")
    # JAX's deal on its own round-0 scores (C1: XLA's FMAs move them by
    # ulps) against its deal on the port's.
    jsnap = r["jsnap"]
    from tpusched.config import EngineConfig as JConfig
    from tpusched.engine import _sat_tables as jax_sat_tables
    jst = jassign.precompute_static(JConfig(mode="fast"), jsnap,
                                    *jax_sat_tables(jsnap))
    snap = r["snap"]
    jf, js = jax.jit(jassign._cycle_nosig)(
        _j(snap.nodes.allocatable), _j(snap.nodes.used), jsnap.pods.requests,
        jst.mask, jst.score, jst.w_lr, jst.w_ba, jst.w_ts, jst.rw)
    jf = jf & jnp.asarray(snap.pods.valid.numpy())[:, None]
    jm = jnp.where(jf, js, -jnp.inf)
    own = np.asarray(jax.jit(
        jassign._deal_commit, static_argnames=("K", "rank_is_sorted"))(
        _j(snap.nodes.allocatable), jsnap.pods.requests,
        _j(snap.nodes.used), jf, jm, jf.any(axis=1), _j(r["rank"]),
        K=tassign._fallback_depth(snap.nodes.valid.shape[0]))[1])
    print(f"JAX's deal on its own scores: {int((jm != r['masked'].numpy()).sum())}"
          f" masked cells differ from the port's, "
          f"{int((own != r['jchoice']).sum())} choices differ from its deal "
          "on the port's")
    ok = (r["feasible"] & r["allowed"][:, None]).numpy()
    contrib = np.where(ok, r["masked"].numpy(), 0.0).astype(np.float32)
    k7 = tassign.desirability_plain(r["feasible"], r["masked"],
                                    r["allowed"]).numpy()
    xla = r["xla_desir"]
    fin = np.isfinite(k7)
    n_allowed = int(r["allowed"].sum())
    port_order = tassign._desc_order(torch.from_numpy(k7)).numpy()
    xla_order = np.argsort(-np.where(fin, xla, -np.inf), kind="stable")
    pos = np.nonzero(port_order != xla_order)[0]
    print(f"desirability: {int((k7[fin] != xla[fin]).sum())} of "
          f"{int(fin.sum())} columns differ; node order positions that "
          f"differ {pos.tolist()}")
    for n in sorted({int(port_order[i]) for i in pos}):
        exact = contrib[:, n].astype(np.float64).sum() / n_allowed
        print(f"  node {n}: K7 (rows in order) {k7[n]!r}, XLA {xla[n]!r}, "
              f"f64 mean {exact!r}")
    # Which fixed order gives XLA's column sum (before the division)?
    xla_sum = np.array(jax.jit(lambda x: jnp.sum(x, axis=0))(
        jnp.asarray(contrib)))
    cands = {"rows in order (K7)": _seq(contrib),
             "rows reversed": _seq(contrib[::-1]),
             "pairwise tree": _tree(contrib),
             "f64, rounded once": contrib.astype(np.float64).sum(0).astype(
                 np.float32)}
    for k in (8, 64, 512):
        parts = np.stack([_seq(contrib[i:i + k])
                          for i in range(0, contrib.shape[0], k)])
        cands[f"chunks of {k}, in order"] = _seq(parts)
        cands[f"chunks of {k}, tree"] = _tree(parts)
        strided = np.stack([_seq(contrib[i::k]) for i in range(k)])
        cands[f"{k} strided accumulators, tree"] = _tree(strided)
    for name, v in cands.items():
        print(f"  {name}: {int((v != xla_sum).sum())} of {v.shape[0]} "
              "columns differ from XLA's sum")
    _fast_counts(r["jsnap"], r["snap"])


def _fast_counts(jsnap, snap) -> None:
    """The whole fast solves: the JAX engine's and the port's placed
    counts and rounds, and how many assignments differ."""
    from tpusched import Engine as JEngine
    from tpusched import EngineConfig as JConfig
    from tpusched_torch import Engine

    jres = JEngine(JConfig(mode="fast")).solve(jsnap)
    res = Engine(EngineConfig(mode="fast"), device="cpu").solve(snap)
    print(f"fast solves: JAX placed {int((jres.assignment >= 0).sum())} in "
          f"{jres.rounds} rounds, the port {int((res.assignment >= 0).sum())}"
          f" in {res.rounds}; {int((res.assignment != jres.assignment).sum())}"
          " assignments differ")


def _report_d(P: int, N: int, seed: int = 43) -> None:
    from tpusched_torch import Engine

    jsnap, _ = jsynth.config3_pairwise(np.random.default_rng(seed), P, N)
    snap = snapshot_from_numpy(jax.device_get(jsnap))
    parity = Engine(EngineConfig(), device="cpu").solve(snap)
    print(f"config3_pairwise(rng({seed}), {P}, {N}): the port's parity solve "
          f"placed {int((parity.assignment >= 0).sum())}")
    _fast_counts(jsnap, snap)


if __name__ == "__main__":
    cell, P, N = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    {"b": _report_b, "d": _report_d}[cell](P, N)
