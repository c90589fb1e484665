"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small shapes. Exact: every kernel is built with --fmad=false and
follows its plain version's order of f32 operations (K7's column sum in
ascending rows, K8's Hillis-Steele prefix and rank-ordered adds).

These tests need a CUDA device and nvcc: without a card each one skips.
The file imports nothing of JAX, so that it runs where the port runs:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's
tests.) `chip_smoke.py` makes the same comparisons at full size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpusched_torch import Engine, EngineConfig
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import (
    _pack_solve,
    _sat_tables,
    score_core,
    score_topk_core,
    solve_core,
)
from tpusched_torch.kernels import assign as ka


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _snap(cuda, seed=0, pods=96, nodes=24, **kw):
    kw = dict(dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.1, with_qos=True), **kw)
    snap, _ = tsynth.make_cluster(np.random.default_rng(seed), pods, nodes,
                                  **kw)
    return snap.to(cuda)


def _equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _static(cfg, snap):
    return ka.precompute_static(cfg, snap, _sat_tables(snap))


def test_k1_to_k3_equal_plain(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    args = (snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
            snap.nodes.label_nums)
    _equal([ka.atom_sat(*args)], [ka.atom_sat_plain(*args)])
    sat = _sat_tables(snap)
    cells = ka._tableau_cells(snap, snap.pods, snap.nodes, sat)
    _equal(cells, ka._tableau_cells_plain(snap, snap.pods, snap.nodes, sat))
    static = _static(cfg, snap)
    w = (cells[2], cells[3], snap.nodes.valid, static.w_lr, static.w_ba)
    _equal([ka.finalize_score(*w)], [ka.finalize_score_plain(*w)])


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_equal_plain(cuda, tie_break):
    snap = _snap(cuda)
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    _equal(ka.parity_scan(cfg, snap, static, order),
           ka.parity_scan_plain(cfg, snap, static, order))


@pytest.mark.parametrize("masked", [False, True])
def test_k5_equal_plain_and_view(cuda, masked):
    snap = _snap(cuda)
    static = _static(EngineConfig(), snap)
    used = snap.nodes.used + 0.3 * snap.nodes.allocatable
    args = (snap.nodes.allocatable, used, snap.pods.requests, static.mask,
            static.score, static.w_lr, static.w_ba, static.w_ts, static.rw)
    _equal(ka.cycle(*args, masked=masked), ka.cycle_plain(*args,
                                                          masked=masked))
    rows = torch.arange(1, snap.pods.valid.shape[0], 3, dtype=torch.int32,
                        device=cuda)
    pend = torch.arange(rows.shape[0], device=cuda) % 2 == 0
    view = ka.cycle(*args, rows=rows, pending=pend, masked=masked)
    _equal(view, ka.cycle_plain(*args, rows=rows, pending=pend,
                                masked=masked))
    # Reading rows in place equals running on gathered copies.
    r = rows.long()
    gathered = (snap.nodes.allocatable, used, snap.pods.requests[r].clone(),
                static.mask[r].clone(), static.score[r].clone(),
                static.w_lr[r].clone(), static.w_ba[r].clone(),
                static.w_ts[r].clone(), static.rw)
    _equal(view, ka.cycle(*gathered, pending=pend, masked=masked))


@pytest.mark.parametrize("K", [1, 3, 8, 16])
def test_k6_equal_plain(cuda, K):
    rng = np.random.default_rng(K)
    m = rng.integers(0, 4, size=(40, 300)).astype(np.float32) * 25.0
    m[rng.random(m.shape) < 0.3] = -np.inf
    m[5] = -np.inf
    m = torch.from_numpy(m).to(cuda)
    ids = torch.arange(40, dtype=torch.int32, device=cuda).flip(0)
    _equal(ka.row_topk(m, K), ka.row_topk_plain(m, K))
    _equal(ka.row_topk(m, K, True, 99, ids),
           ka.row_topk_plain(m, K, True, 99, ids))


def test_k7_equal_plain(cuda):
    snap = _snap(cuda)
    static = _static(EngineConfig(), snap)
    f, m = ka.cycle_plain(snap.nodes.allocatable, snap.nodes.used,
                          snap.pods.requests, static.mask, static.score,
                          static.w_lr, static.w_ba, static.w_ts, static.rw,
                          masked=True)
    allowed = f.any(dim=1)
    _equal([ka.desirability(f, m, allowed)],
           [ka.desirability_plain(f, m, allowed)])


def test_k8_equal_plain(cuda):
    """Random (node, rank)-sorted candidates over a tight cluster, so
    some rows fit, some do not and some are prefix-blocked."""
    rng = np.random.default_rng(3)
    P, N, R = 500, 37, 3
    cand = rng.integers(0, N + 1, size=P)            # N = inactive
    rank = rng.permutation(P)
    perm = np.lexsort((rank, cand)).astype(np.int32)
    cand_s = cand[perm].astype(np.int32)
    req = rng.integers(1, 9, size=(P, R)).astype(np.float32) * 0.37
    alloc = np.full((N, R), 12.0, np.float32)
    used = rng.uniform(0, 6, size=(N, R)).astype(np.float32)
    choice = np.full(P, -1, np.int32)
    ptr = rng.integers(0, 3, size=P).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda)
         for a in (perm, cand_s, req, alloc, used, choice, ptr)]
    got = ka.prefix_commit(*t, 9)
    want = ka.prefix_commit_plain(*t, 9)
    _equal(got, want)
    assert (got[1] >= 0).any() and (got[2] == 0).any()


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_solve_equal_plain(cuda, tie_break):
    """The whole fast solve through the kernels equals the same solve
    through the plain versions on the same CUDA tensors, with both the
    direct rounds and (cap 16) the tranche path."""
    snap = _snap(cuda, pods=120, nodes=20, initial_utilization=0.5)
    cfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=1)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    P, N = static.mask.shape
    rank = torch.zeros(P, dtype=torch.int32, device=cuda)
    rank[order] = torch.arange(P, dtype=torch.int32, device=cuda)
    runs = [ka._solve_rounds_nosig(cfg, snap, static, rank, order,
                                   2 * P + 8, ka._fallback_depth(N), cap=16,
                                   ops=ops) for ops in (ka.KERNELS, ka.PLAIN)]
    _equal(runs[0][:4], runs[1][:4])
    assert runs[0][4] == runs[1][4]


def test_score_equal_plain(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    _equal(score_core(cfg, snap), score_core(cfg, snap, ops=ka.PLAIN))
    _equal(score_topk_core(cfg, snap, 8),
           score_topk_core(cfg, snap, 8, ops=ka.PLAIN))


def test_engine_runs_on_the_card(cuda):
    eng = Engine(EngineConfig(mode="fast"))
    try:
        assert eng.device.type == "cuda"
        snap, _ = tsynth.make_cluster(np.random.default_rng(0), 40, 12)
        res = eng.solve(snap)
        assert (res.assignment >= 0).sum() > 0 and res.host_reads > 0
    finally:
        eng.close()
