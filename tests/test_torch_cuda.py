"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small shapes. Exact: every kernel is built with --fmad=false and
follows its plain version's order of f32 operations (K7's column sum in
ascending rows, K8's Hillis-Steele prefix and rank-ordered adds; K10's
atomic adds of +-1.0 stay exact integers in any order; K12-K14 count,
compare and take minima; K15's victim prefix sums run in 16-row blocks
of each node's segment, as its plain version's do; K21's priority rounds its f64
multiply-add once, as the plain version and the numpy oracle do; K22
sums the six terms left to right, as its plain version does; K23's
prefixes take _scan_plain's Hillis-Steele order and its searches
torch.searchsorted's bisection; K24's counts are integers). The tenant
axis of K1-K18 (K4's pairwise and preemption variants included) and the
batch (`solve_many`, with signatures, gangs and preemption) are held the
same way, and each tenant against its solo kernel call and solve.

These tests need a CUDA device and nvcc: without a card each one skips.
The file imports nothing of JAX, so that it runs where the port runs:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's
tests.) `chip_smoke.py` makes the same comparisons at full size.
"""

from __future__ import annotations

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from tpusched_torch import Engine, EngineConfig, solve_many, stack_snapshots
from tpusched_torch import synth as tsynth
from tpusched_torch.config import Buckets
from tpusched_torch.engine import (
    _pack_solve,
    _sat_tables,
    score_core,
    score_topk_core,
    solve_core,
)
from tpusched_torch.kernels import assign as ka
from tpusched_torch.kernels import stack_tenants
from tpusched_torch.kernels import explain as kex
from tpusched_torch.kernels import pairwise as kp
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.kernels import queue as kq
from tpusched_torch.snapshot import SnapshotBuilder

# Pairwise mixes: config 3, and config 3 with running anti-affinity
# holders, three namespaces and key-less nodes.
PAIR_MIXES = {
    "config3": dict(spread_frac=0.5, interpod_frac=0.5),
    "anti_ns_keyless": dict(spread_frac=0.5, interpod_frac=0.5,
                            run_anti_frac=0.2, namespace_count=3,
                            keyless_node_frac=0.1),
}


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
    return ka.precompute_static(cfg, snap, _sat_tables(snap)[0])


def test_k1_to_k3_equal_plain(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    args = (snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
            snap.nodes.label_nums)
    _equal([ka.atom_sat(*args)], [ka.atom_sat_plain(*args)])
    sat = _sat_tables(snap)[0]
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


# K4's clusters: B tenants of N nodes (a bucket of exactly N: odd, so a
# multiple of no cluster size and of no CTA's threads; 3 padded nodes).
# At N = 2 101 Q = 1 and 2 run CTAs of 1 024 threads, 3 and 2 nodes a
# thread (nodes past the two a thread reads ahead at Q = 1), Q = 4 and 8
# 512 threads, 2 and 1 nodes a thread (the seeded pick walks 3, 2, 2
# and 1 tiles), and Q = 16 256; at 1 501 Q = 4 runs 512; at 37 every Q
# leaves most threads idle (N < Q x threads) and Q = 16 leaves CTAs with
# no node.
K4_CLUSTER_NODES = {1: 2101, 3: 1501, 8: 37}


def _k4_tenants(cuda, B, pair):
    """B tenants of 60 + 4 b pods on K4_CLUSTER_NODES[B] - 3 nodes under
    one floor of exactly K4_CLUSTER_NODES[B] nodes; B = 1 unstacked."""
    N = K4_CLUSTER_NODES[B]
    kw = (PAIR_MIXES["anti_ns_keyless"] if pair else
          dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
               affinity_frac=0.3, cordon_frac=0.1))

    def draw(b, **x):
        return tsynth.make_cluster(np.random.default_rng(90 + b), 60 + 4 * b,
                                   N - 3, initial_utilization=0.5, **kw, **x)

    floor = {}
    for b in range(B):
        for f, v in dataclasses.asdict(draw(b)[1].buckets).items():
            floor[f] = max(floor.get(f, 0), v)
    floor["nodes"] = N
    snaps = [draw(b, buckets=Buckets(**floor))[0] for b in range(B)]
    return (snaps[0] if B == 1 else stack_snapshots(snaps)).to(cuda)


@pytest.mark.parametrize("B", sorted(K4_CLUSTER_NODES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_every_cluster_equal_plain(cuda, tie_break, B):
    """K4 at every cluster size equals its plain version."""
    snap = _k4_tenants(cuda, B, pair=False)
    assert snap.nodes.valid.shape[-1] == K4_CLUSTER_NODES[B]
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    want = ka.parity_scan_plain(cfg, snap, static, order)
    for Q in ka.SCAN_CLUSTERS:
        _equal(ka.parity_scan(cfg, snap, static, order, cluster=Q), want)


@pytest.mark.parametrize("B", sorted(K4_CLUSTER_NODES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_pair_every_cluster_equal_plain(cuda, tie_break, B):
    """K4's pairwise variant at every cluster size equals its plain
    version, the final pair state included."""
    snap = _k4_tenants(cuda, B, pair=True)
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static, dom, st = _pair_setup(cfg, snap)
    order = ka.pop_order(cfg, snap)
    want = ka.parity_scan_pair_plain(cfg, snap, static, order, st, dom)
    for Q in ka.SCAN_CLUSTERS:
        got = ka.parity_scan_pair(cfg, snap, static, order, st, dom,
                                  cluster=Q)
        _equal(got[:3], want[:3])
        _equal(_state(got[3]), _state(want[3]))


def test_k4_seeded_walk_past_32_tiles(cuda):
    """K4's seeded pick over 34 816 nodes (a bucket of 34 000): at Q = 1 a
    CTA of 1 024 threads walks 34 tiles in groups of 32, and some pods
    take a tie past the first group's 32 768 nodes; at Q = 2, 17 tiles."""
    snap = _snap(cuda, seed=3, pods=200, nodes=34000,
                 initial_utilization=0.0)
    cfg = EngineConfig(tie_break="seeded", tie_seed=5)
    static = _static(cfg, snap)
    order = ka.pop_order(cfg, snap)
    want = ka.parity_scan_plain(cfg, snap, static, order)
    assert ka.scan_threads(static.mask.shape[-1], 1) == 1024
    assert (want[0] >= 32 * 1024).any()
    for Q in (1, 2):
        _equal(ka.parity_scan(cfg, snap, static, order, cluster=Q), want)


def test_k4_refuses_a_cluster_size(cuda):
    snap = _snap(cuda)
    cfg = EngineConfig()
    static = _static(cfg, snap)
    with pytest.raises(ValueError, match="cluster size 3"):
        ka.parity_scan(cfg, snap, static, ka.pop_order(cfg, snap), cluster=3)


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


def _k5_inputs(cuda, R, N, P=48, B=None, seed=0):
    """Random K5 inputs at R resources: zero capacity on some nodes, usage
    near capacity (so the fit cuts), one resource weight zero (BA selects
    a subset), -0.0 in the static score; K11's pairwise rows and ia_ok.
    A leading tenant axis with B. Returns (args, pair, w_ia, ia_ok)."""
    rng = np.random.default_rng(100 * seed + R)
    lead = () if B is None else (B,)
    alloc = rng.uniform(10, 100, (*lead, N, R)).astype(np.float32)
    alloc[rng.random(alloc.shape) < 0.1] = 0.0
    used = (alloc * rng.uniform(0, 1.1, alloc.shape)).astype(np.float32)
    req = rng.uniform(0, 20, (*lead, P, R)).astype(np.float32)
    mask = rng.random((*lead, P, N)) < 0.8
    sscore = rng.normal(0, 50, (*lead, P, N)).astype(np.float32)
    sscore[rng.random(sscore.shape) < 0.05] = -0.0
    w_lr, w_ba, w_ts, w_ia = (rng.uniform(0, 2, (*lead, P)).astype(np.float32)
                              for _ in range(4))
    rw = rng.uniform(0.5, 2, R).astype(np.float32)
    rw[R // 2] = 0.0
    pair_ok = rng.random((*lead, P, N)) < 0.9
    ts, ia = (rng.uniform(0, 100, (*lead, P, N)).astype(np.float32)
              for _ in range(2))
    ia_ok = rng.random((*lead, P, N)) < 0.85
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    args = tuple(t(x) for x in (alloc, used, req, mask, sscore, w_lr, w_ba,
                                w_ts, rw))
    return args, (t(pair_ok), t(ts), t(ia)), t(w_ia), t(ia_ok)


# K5 at every R its template takes past the default 3, at N = 1 003 (a
# multiple of neither 4 nor a tile: rows whose base is not 4-cell aligned
# and a ragged last tile), 1 024 (every row aligned) and 37 (one warp).
@pytest.mark.parametrize("R,N", [(1, 1003), (2, 1003), (3, 1003), (5, 1003),
                                 (8, 1003), (3, 1024), (3, 37)])
@pytest.mark.parametrize("masked", [False, True])
def test_k5_exact_r_equal_plain(cuda, monkeypatch, R, N, masked):
    """Full width, a rows view with pending, the pairwise branch and the
    relaxed output, and other tiles than cycle_tile's, each equal to the
    plain version."""
    args, pair, w_ia, ia_ok = _k5_inputs(cuda, R, N)
    P = args[3].shape[0]
    _equal(ka.cycle(*args, masked=masked),
           ka.cycle_plain(*args, masked=masked))
    rows = torch.arange(P - 1, 0, -3, dtype=torch.int32, device=cuda)
    pend = torch.arange(rows.shape[0], device=cuda) % 3 != 1
    view = dict(rows=rows, pending=pend, masked=masked)
    _equal(ka.cycle(*args, **view), ka.cycle_plain(*args, **view))
    both = dict(view, pair=pair, w_ia=w_ia, ia_ok=ia_ok)
    want = ka.cycle_plain(*args, **both)
    assert len(want) == 3
    _equal(ka.cycle(*args, **both), want)
    _equal(ka.cycle(*args, pair=pair, w_ia=w_ia, masked=masked),
           ka.cycle_plain(*args, pair=pair, w_ia=w_ia, masked=masked))
    for tile in ((1, 32), (5, 64), (32, 256)):
        monkeypatch.setattr(ka, "cycle_tile", lambda n: tile)
        _equal(ka.cycle(*args, **both), want)


def test_k5_tenants_unequal_rows_equal_plain(cuda):
    """Three tenants in one launch, each with its own pending rows (a
    different count each), without and with the pairwise rows and the
    relaxed output, in both score forms."""
    B, P, N, R = 3, 40, 1003, 3
    args, pair, w_ia, ia_ok = _k5_inputs(cuda, R, N, P=P, B=B, seed=1)
    rows = torch.stack([torch.randperm(P, device=cuda)[:24]
                        for _ in range(B)]).to(torch.int32)
    pend = torch.zeros((B, 24), dtype=torch.bool, device=cuda)
    for b, n in enumerate((24, 11, 0)):
        pend[b, :n] = True
    for masked in (False, True):
        view = dict(rows=rows, pending=pend, masked=masked)
        _equal(ka.cycle(*args, **view), ka.cycle_plain(*args, **view))
        both = dict(view, pair=pair, w_ia=w_ia, ia_ok=ia_ok)
        _equal(ka.cycle(*args, **both), ka.cycle_plain(*args, **both))
        _equal(ka.cycle(*args, masked=masked),
               ka.cycle_plain(*args, masked=masked))


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


# K6's warp kernel: every split of a row over the warps of a CTA.
K6_SPLITS = (1, 2, 4, 8)


def _k6_rows(N: int, rows: int = 40, seed: int = 0) -> torch.Tensor:
    """Tie-heavy score rows (multiples of 25, -inf 30 % of the time) and,
    first, the rows that stress the kernel: all -inf, all equal, -0.0
    and +0.0 mixed (with -inf), and a maximum tied ~N / 8 times (hundreds
    at N = 5 120, so that the pick walks past the first chunks)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 4, size=(rows, N)).astype(np.float32) * 25.0
    m[rng.random(m.shape) < 0.3] = -np.inf
    m[0] = -np.inf
    m[1] = -7.0
    m[2] = np.where(rng.random(N) < 0.5, -0.0, 0.0)
    m[3] = np.where(rng.random(N) < 0.2, -np.inf, m[2])
    m[4] = np.where(rng.random(N) < 0.125, 100.0, m[4])
    return torch.from_numpy(m)


def _k6_all(m, K, ids, **kw):
    """K6 against its plain version, exactly, seeded and not."""
    _equal(ka.row_topk_path(m, K, **kw), ka.row_topk_plain(m, K))
    _equal(ka.row_topk_path(m, K, True, 99, ids, **kw),
           ka.row_topk_plain(m, K, True, 99, ids))


@pytest.mark.parametrize("N", [1, 3, 127, 128, 129, 5120])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8, 16, 32])
def test_k6_warp_equal_plain(cuda, K, N):
    """K6's warp kernel at every split, seeded and not, exactly; N = 1, 3,
    127 and 129 take the scalar loads, N = 128 and 5 120 the float4 ones
    (K = min(K, N))."""
    K = min(K, N)
    m = _k6_rows(N, seed=K).to(cuda)
    ids = torch.arange(m.shape[0], dtype=torch.int32, device=cuda).flip(0)
    for split in K6_SPLITS:
        _k6_all(m, K, ids, split=split)


@pytest.mark.parametrize("rows", [1, 1024, 10240])
def test_k6_rows_equal_plain(cuda, rows):
    """K6 through row_topk (the split of topk_split) at K = 1, 4, 8 and 16
    on 1, 1 024 and 10 240 rows of 5 120 nodes, seeded and not, and on
    rows that start 4 bytes past an aligned address (the scalar loads),
    exactly."""
    m = _k6_rows(5120, rows=max(rows, 5)).to(cuda)[:rows].contiguous()
    flat = torch.empty(rows * 5120 + 1, device=cuda)
    shifted = flat[1:].view(rows, 5120)
    shifted.copy_(m)
    ids = torch.arange(rows, dtype=torch.int32, device=cuda)
    for K in (1, 4, 8, 16):
        for x in (m, shifted):
            _equal(ka.row_topk(x, K), ka.row_topk_plain(x, K))
            _equal(ka.row_topk(x, K, True, 5, ids),
                   ka.row_topk_plain(x, K, True, 5, ids))


def test_k6_tenants_equal_plain(cuda):
    """K6 over a tenant batch [8, 128, 300], each tenant's rows keyed by
    its own pod ids, seeded and not, exactly."""
    m = _k6_rows(300, rows=8 * 128, seed=8).to(cuda).reshape(8, 128, 300)
    ids = torch.randperm(128, generator=torch.Generator().manual_seed(8))
    ids = ids.to(torch.int32).to(cuda).expand(8, 128).contiguous()
    for K in (1, 8, 16):
        _equal(ka.row_topk(m, K), ka.row_topk_plain(m, K))
        _equal(ka.row_topk(m, K, True, 3, ids),
               ka.row_topk_plain(m, K, True, 3, ids))


@pytest.mark.parametrize("K", [33, 64, 300])
def test_k6_seeded_above_the_cap_equal_plain(cuda, K):
    """A seeded K above the warp kernel's 32: the radix select's top-K and
    the warp kernel's pick at K = 1, one launch of each, exactly."""
    m = _k6_rows(300, seed=K).to(cuda)
    ids = torch.arange(m.shape[0], dtype=torch.int32, device=cuda)
    assert ka.topk_route(K, True) == ("row_topk_radix", "row_topk")
    before = (ka.row_topk.launches, ka.row_topk.radix_launches)
    got = ka.row_topk(m, K, True, 11, ids)
    assert (ka.row_topk.launches - before[0],
            ka.row_topk.radix_launches - before[1]) == (1, 1)
    _equal(got, ka.row_topk_plain(m, K, True, 11, ids))
    with pytest.raises(ValueError):
        ka.row_topk_path(m, K, True, 11, ids)


def test_k6_radix_above_shared_memory_equal_plain(cuda):
    """The radix select above 16 384 (its pairs sorted in a scratch
    buffer in device memory), exactly."""
    m = _k6_rows(20000, rows=6, seed=3).to(cuda)
    for K in (16385, 20000):
        _equal(ka.row_topk(m, K), ka.row_topk_plain(m, K))


class K2Tree(types.SimpleNamespace):
    """A namespace of arrays or tensors that the plain versions' tenant
    loop can slice (`tenant(b)`, as a snapshot's)."""

    def tenant(self, b: int) -> "K2Tree":
        return K2Tree(**{k: v[b] for k, v in vars(self).items()})


def k2_inputs(rng, N: int, P: int = 37, T: int = 3, AT: int = 3,
              PT: int = 2, TN: int = 3, VT: int = 6, A: int = 20,
              B: int | None = None):
    """Raw K2 inputs from numpy, (snap, pods, nodes, node_sat_t) as
    namespaces of numpy arrays: atom ids -1 (unlisted) .. A - 1, taint ids
    -1 .. VT - 1 with repeats within a node, every effect (0-2 and an
    unknown 3), weights of both signs, about half of each flag set; with
    B a leading [B] axis on each."""
    lead = () if B is None else (B,)

    def flags(*shape):
        return rng.random(lead + shape) < 0.5

    def ids(lo, hi, *shape):
        return rng.integers(lo, hi, size=lead + shape).astype(np.int32)

    ns = K2Tree
    pods = ns(req_term_atoms=ids(-1, A, P, T, AT), req_term_valid=flags(P, T),
              pref_term_atoms=ids(-1, A, P, PT, AT),
              pref_term_valid=flags(P, PT),
              pref_weight=rng.uniform(-10, 100, lead + (P, PT)).astype(
                  np.float32),
              tolerated=flags(P, VT), tolerates_unsched=flags(P),
              valid=rng.random(lead + (P,)) < 0.9)
    nodes = ns(taint_ids=ids(-1, VT, N, TN), schedulable=flags(N),
               valid=rng.random(lead + (N,)) < 0.9)
    snap = ns(taint_effect=rng.integers(0, 4, lead + (VT,)).astype(np.int8))
    sat = rng.random(lead + (A, N)) < 0.7
    return snap, pods, nodes, sat


def k2_torch(inputs, dev):
    """k2_inputs' namespaces as tensors on dev."""
    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return K2Tree(**{k: conv(v) for k, v in vars(x).items()})
    return tuple(conv(x) for x in inputs)


def _k2_equal(args):
    _equal(ka._tableau_cells(*args), ka._tableau_cells_plain(*args))


@pytest.mark.parametrize("P", [1, 37])
@pytest.mark.parametrize("N", [1, 3, 5, 255, 257, 5121, 5120])
def test_k2_shapes_equal_plain(cuda, N, P):
    """K2 at node counts that are no multiple of 4 (the byte-wise path:
    1, 3, 5, 255, 257, 5 121) and are (5 120), one pod and a pod block
    past the tile's 8, exactly."""
    _k2_equal(k2_torch(k2_inputs(np.random.default_rng(N + P), N, P), cuda))


@pytest.mark.parametrize("case", ["T0", "PT0", "TN0", "all0", "wide_taints",
                                  "wide_vocab", "one_atom"])
def test_k2_tables_equal_plain(cuda, case):
    """K2 with no required terms, no preferred terms, no taint slots, none
    of the three; taint ids too many to stage (TN = 40) and verdicts too
    many to stage (VT = 3 000), both read in place; a single atom; each
    at 260 and 256 nodes, exactly."""
    kw = dict(T0=dict(T=0), PT0=dict(PT=0), TN0=dict(TN=0),
              all0=dict(T=0, PT=0, TN=0), wide_taints=dict(TN=40),
              wide_vocab=dict(VT=3000), one_atom=dict(A=1, AT=1))[case]
    for N in (260, 256):
        _k2_equal(k2_torch(k2_inputs(np.random.default_rng(N), N, 41, **kw),
                           cuda))


def test_k2_gathered_views_equal_plain(cuda):
    """K2 on refresh_tableau's gathered views: dirty pod rows (not from 0,
    with a repeat) against every node, and every pod against dirty node
    columns (3 and 8 of them), and on a node table that starts one byte
    past an aligned address (the byte-wise path), exactly."""
    snap, pods, nodes, sat = k2_torch(
        k2_inputs(np.random.default_rng(7), 300, 90), cuda)
    def rows_of(tree, idx):  # permute_rows of a namespace
        return K2Tree(**{k: v.index_select(0, idx)
                         for k, v in vars(tree).items()})

    rows = torch.tensor([5, 17, 17, 40, 89], device=cuda)
    _k2_equal((snap, rows_of(pods, rows), nodes, sat))
    for cols in ([3, 9, 130], [1, 2, 3, 5, 8, 13, 21, 299]):
        c = torch.tensor(cols, device=cuda)
        _k2_equal((snap, pods, rows_of(nodes, c),
                   sat.index_select(1, c).contiguous()))
    buf = torch.zeros(sat.numel() + 1, dtype=torch.bool, device=cuda)
    shifted = buf[1:].view(sat.shape)
    shifted.copy_(sat)
    _k2_equal((snap, pods, nodes, shifted))


@pytest.mark.parametrize("N", [256, 257])
def test_k2_tenants_equal_plain(cuda, N):
    """K2 over a tenant batch of 8, exactly."""
    _k2_equal(k2_torch(k2_inputs(np.random.default_rng(N), N, 50, B=8),
                       cuda))


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


# K7's f32 path stages 256 rows (csrc/deal.cu STAGE): row counts below a
# warp, around one, around a stage, and the full fast round's 10 240.
@pytest.mark.parametrize("rows", [1, 31, 33, 255, 257, 10240])
def test_k7_stages_equal_plain(cuda, rows):
    """K7's f32 path over three tenants and solo against its plain
    version: a column no row is feasible at, -0.0 contributions, a tenant
    with no allowed row, 77 columns (a part tile)."""
    rng = np.random.default_rng(rows)
    B, N = 3, 77
    m = (rng.normal(0.0, 50.0, (B, rows, N))
         * (rng.random((B, rows, N)) < 0.5)).astype(np.float32)
    m[rng.random(m.shape) < 0.2] = -0.0
    f = rng.random((B, rows, N)) < 0.7
    m[~f] = -np.inf
    f[:, :, 5] = False
    al = rng.random((B, rows)) < 0.8
    al[1] = False
    m, f, al = (torch.from_numpy(x).to(cuda) for x in (m, f, al))
    _equal([ka.desirability(f, m, al)], [ka.desirability_plain(f, m, al)])
    _equal([ka.desirability(f[0], m[0], al[0])],
           [ka.desirability_plain(f[0], m[0], al[0])])


def _loop_case(cuda, case):
    """K8 loop arguments (topi, topv, allowed, rank, requests, alloc,
    used) of one case: random candidate lists (a tenth -inf) over a tight
    cluster, so that rows fit, fail and are prefix-blocked, through
    several sub-steps."""
    rng = np.random.default_rng(8)
    B, P, N, R, KC = None, 500, 37, 3, 9
    ranks = None
    if case == "one_node":          # every row on one node, past 1 024
        P, N = 3000, 40
    elif case == "ragged":          # P not a multiple of 1 024
        P = 1500
    elif case in ("r1", "r8"):
        R = int(case[1])
    elif case == "tenants":
        B = 3
    elif case == "global_ranks":    # a compacted view's ranks, past P
        ranks = rng.choice(20 * P, size=P, replace=False)
    elif case == "global_scratch":  # past a CTA's shared memory
        P, N = 14000, 3000
    lead = (B,) if B else ()
    topi = rng.integers(0, N, size=(*lead, P, KC))
    if case == "one_node":
        topi[:] = 7
    topv = rng.normal(size=(*lead, P, KC)).astype(np.float32)
    topv[rng.random(topv.shape) < 0.1] = -np.inf
    allowed = rng.random((*lead, P)) < 0.9
    if case == "none_active":
        allowed[:] = False
    if case == "tenants":
        allowed[1] = False          # no allowed row beside busy tenants
    rank = (np.stack([rng.permutation(P) for _ in range(B)]) if B
            else rng.permutation(P) if ranks is None else ranks)
    req = rng.integers(1, 9, size=(*lead, P, R)).astype(np.float32) * 0.37
    alloc = np.full((*lead, N, R), 12.0 if case != "one_node" else 3000.0,
                    np.float32)
    used = rng.uniform(0, 6, size=(*lead, N, R)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        topi.astype(np.int32), topv, allowed, rank.astype(np.int32), req,
        alloc, used))


@pytest.mark.parametrize("case", ["random", "one_node", "none_active",
                                  "tenants", "ragged", "r1", "r8",
                                  "global_ranks", "global_scratch"])
def test_k8_equal_plain(cuda, case):
    """K8's loop kernel (every sub-step of a round in one launch) against
    the plain loop, exactly: used, choice and each tenant's sub-steps."""
    args = _loop_case(cuda, case)
    got = ka.prefix_commit_loop(*args)
    want = ka.prefix_commit_loop_plain(*args)
    _equal(got, want)
    if case == "none_active":
        assert (got[1] == -1).all() and (got[2] == 0).all()
        return
    assert (got[1] >= 0).any() and (got[2] >= 1).any()
    if case == "tenants":
        assert int(got[2][1]) == 0 and torch.equal(got[0][1], args[6][1])
    if case == "one_node":
        assert int((got[1] == 7).sum()) > 1024
    if case == "global_scratch":
        assert (ka.prefix_commit_loop_smem_bytes(*args[0].shape[:1],
                                                 args[5].shape[0])
                > ka.NODE_ADD_SMEM_MAX)


def _loop_calls(cfg, snap, solve=None, want=lambda site: True):
    """The arguments of the K8 loop calls of a solve whose _deal_commit
    caller's name passes `want` (cloned), in call order."""
    calls = []

    def rec(*a):
        if want(sys._getframe(2).f_code.co_name):
            calls.append(tuple(x.clone() if isinstance(x, torch.Tensor)
                               else x for x in a))
        return ka.prefix_commit_loop(*a)

    ops = dataclasses.replace(ka.KERNELS, prefix_commit_loop=rec)
    (solve or solve_core)(cfg, snap, ops=ops)
    return calls


@pytest.mark.parametrize("cell", ["b_full", "sig_compacted", "drain",
                                  "tenants8"])
def test_k8_loop_on_the_main_path_equal_plain(cuda, cell):
    """K8's loop kernel against the plain loop on the rounds the main
    path gives it: the first fast round of (b) at full width (10 000 x
    5 000), a compacted signature round (global ranks in a view), a
    preemption drain step, and a batch of 8 tenants."""
    if cell == "b_full":
        snap, _ = tsynth.config2_scale(np.random.default_rng(42), 10000,
                                       5000, with_qos=True, taint_frac=0.3,
                                       toleration_frac=0.3,
                                       selector_frac=0.3, affinity_frac=0.3,
                                       cordon_frac=0.05)
        calls = _loop_calls(EngineConfig(mode="fast"), snap.to(cuda))[:1]
    elif cell == "sig_compacted":
        # tests/test_frontier.py:63's cluster, which hands off to [16, N]
        # views at compact_cap = 16 and places in them.
        snap, _ = tsynth.make_cluster(
            np.random.default_rng(22), 48, 12, spread_frac=0.4,
            interpod_frac=0.4, run_anti_frac=0.2, namespace_count=2,
            cordon_frac=0.1, selector_frac=0.2, taint_frac=0.15,
            toleration_frac=0.2)
        snap = snap.to(cuda)
        P = snap.pods.valid.shape[0]
        calls = [a for a in _loop_calls(EngineConfig(mode="fast",
                                                     compact_cap=16), snap)
                 if a[3].shape[-1] < P]
    elif cell == "drain":
        snap = _preempt_snap(cuda, False)
        calls = _loop_calls(EngineConfig(mode="fast", preemption=True), snap,
                            want=lambda s: s == "_preempt_rounds_many")
    else:
        _, stacked = _tenant_batch(cuda, B=8)
        calls = _loop_calls(EngineConfig(mode="fast"), stacked,
                            solve=lambda c, s, ops: solve_many(
                                c, s, device=cuda, ops=ops))[:2]
        assert calls[0][0].shape[0] == 8
    assert calls
    placed = 0
    for a in calls:
        got = ka.prefix_commit_loop(*a)
        _equal(got, ka.prefix_commit_loop_plain(*a))
        placed += int((got[1] >= 0).sum())
    assert placed > 0
    if cell == "sig_compacted":
        assert max(int(a[3].max()) for a in calls) >= calls[0][3].shape[-1]


def _node_add_case(case, cuda):
    """node_add's inputs (used, node, mask, requests, rank) of one case:
    usage large against the requests, so that the order of a node's adds
    shows in its bits."""
    rng = np.random.default_rng(len(case))
    B, P, N, R = {"one_hot": (None, 4096, 64, 3),
                  "two_hot": (None, 4096, 64, 5),
                  "equal_ranks": (None, 600, 20, 1),
                  "empty": (None, 300, 20, 3),
                  "view_ranks": (None, 1024, 200, 3),
                  "scratch": (None, 30000, 500, 2),
                  "tenants": (8, 512, 40, 8)}[case]
    lead = () if B is None else (B,)
    node = rng.integers(-2, N + 2, (*lead, P)).astype(np.int32)
    mask = rng.random((*lead, P)) < 0.9
    rank = np.stack([rng.permutation(P) for _ in range(B or 1)]).astype(
        np.int32).reshape(*lead, P)
    if case == "one_hot":           # every row on one node: the CTA's sort
        node[:] = 17
        mask[:] = True
    elif case == "two_hot":         # two CTA buckets and a warp's
        u = rng.random(P)
        node[u < 0.45] = 5
        node[(u >= 0.45) & (u < 0.8)] = 40
        node[(u >= 0.8) & (u < 0.85)] = 9
    elif case == "equal_ranks":     # ties broken by the row index
        rank = ((P - np.arange(P)) // 7).astype(np.int32)
        node = rng.integers(0, 4, P).astype(np.int32)
    elif case == "empty":
        mask[:] = False
    elif case == "view_ranks":      # a compacted view's global ranks
        rank = rng.choice(10240, P, replace=False).astype(np.int32)
        rank[:5] = -rank[:5]
    elif case == "scratch":         # buckets past a CTA's shared memory
        assert ka.node_add_smem_bytes(P, N) > ka.NODE_ADD_SMEM_MAX
    used = rng.uniform(0, 1e6, (*lead, N, R)).astype(np.float32)
    req = (rng.uniform(0, 1000, (*lead, P, R))
           * rng.random((*lead, P, R))).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    out = [t(used), t(node), t(mask), t(req), t(rank)]
    if case == "tenants":           # one rank row shared by every tenant
        out[4] = torch.arange(P, dtype=torch.int32, device=cuda).expand(B, P)
        out[1][3] = 7
        out[2][5] = False
    return out


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("case", ["one_hot", "two_hot", "equal_ranks",
                                  "empty", "view_ranks", "scratch",
                                  "tenants"])
def test_node_add_equal_plain(cuda, case, sign):
    """K8's node_add in one launch on unsorted rows against its plain
    version (a stable sort, then the adds in order), bit for bit."""
    args = _node_add_case(case, cuda)
    got = ka.node_add(*args, sign)
    _equal([got], [ka.node_add_plain(*args, sign)])
    if case == "empty":
        _equal([got], [args[0]])
    else:
        assert not torch.equal(got, args[0])


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


def _pair_snap(cuda, mix, pods=120, nodes=24):
    snap, _ = tsynth.make_cluster(np.random.default_rng(43), pods, nodes,
                                  **PAIR_MIXES[mix])
    return snap.to(cuda)


def _pair_setup(cfg, snap):
    static = ka.precompute_static(cfg, snap, *_sat_tables(snap))
    dom = kp.sig_domains(snap)
    return static, dom, kp.pair_counts(static.sig_match, dom, snap.running,
                                       snap.pods)


def _state(st):
    return [st.counts, st.anti, st.match_tot]


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k9_to_k11_equal_plain(cuda, mix):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig()
    _, member_sat_t = _sat_tables(snap)
    ns = kp.merge_members(snap.running.namespace, snap.pods.namespace)
    _equal([kp.sig_match(member_sat_t, snap.sigs, ns)],
           [kp.sig_match_plain(member_sat_t, snap.sigs, ns)])
    static, dom, st = _pair_setup(cfg, snap)
    args = (static.sig_match, dom, snap.running, snap.pods)
    _equal(_state(st), _state(kp.pair_counts_plain(*args)))
    asg = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 24, size=snap.pods.valid.shape[0]).astype(np.int32)).to(cuda)
    _equal(_state(kp.pair_counts(*args, assigned=asg)),
           _state(kp.pair_counts_plain(*args, assigned=asg)))
    b = (snap, st, static.aff_ok, static.sig_match, dom)
    _equal(kp.pairwise_batch(*b), kp.pairwise_batch_plain(*b))


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_pair_equal_plain(cuda, mix, tie_break):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig(tie_break=tie_break, tie_seed=5)
    static, dom, st = _pair_setup(cfg, snap)
    order = ka.pop_order(cfg, snap)
    got = ka.parity_scan_pair(cfg, snap, static, order, st, dom)
    want = ka.parity_scan_pair_plain(cfg, snap, static, order, st, dom)
    _equal(got[:3], want[:3])
    _equal(_state(got[3]), _state(want[3]))
    # The final state is K10's recount at the final assignment.
    _equal(_state(got[3]), _state(kp.pair_counts(
        static.sig_match, dom, snap.running, snap.pods, assigned=got[0])))


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_pairwise_solve_and_score_equal_plain(cuda, mix):
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig()
    assert torch.equal(_pack_solve(solve_core(cfg, snap)),
                       _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN)))
    _equal(score_core(cfg, snap), score_core(cfg, snap, ops=ka.PLAIN))
    _equal(score_topk_core(cfg, snap, 8),
           score_topk_core(cfg, snap, 8, ops=ka.PLAIN))


def _round_inputs(cfg, snap, cuda):
    """A fast pairwise round's inputs: the state with a third of the pods
    committed at random nodes, every valid pod pending."""
    static, dom, st = _pair_setup(cfg, snap)
    rng = np.random.default_rng(2)
    P = snap.pods.valid.shape[0]
    choice = torch.from_numpy(rng.integers(0, 24, size=P).astype(
        np.int32)).to(cuda)
    kept = (torch.from_numpy(rng.random(P) < 0.6).to(cuda)
            & snap.pods.valid)
    st = kp.pair_commit_plain(snap, st, static.sig_match, dom, choice, kept)
    order = ka.pop_order(cfg, snap)
    rank = torch.zeros(P, dtype=torch.int32, device=cuda)
    rank[order] = torch.arange(P, dtype=torch.int32, device=cuda)
    return static, dom, st, choice, kept, rank


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k12_to_k14_and_entry_points_equal_plain(cuda, mix):
    """K12-K14 and the fast pairwise entry points of K5, K7, K8, K10 and
    K11 against their plain versions."""
    snap = _pair_snap(cuda, mix)
    cfg = EngineConfig(mode="fast")
    static, dom, st, choice, kept, rank = _round_inputs(cfg, snap, cuda)
    used = snap.nodes.used
    pend = snap.pods.valid
    kw = dict(pair_st=st, pending=pend, return_relaxed=True)
    got = ka.batched_cycle(cfg, snap, static, used, ops=ka.KERNELS, **kw)
    want = ka.batched_cycle(cfg, snap, static, used, ops=ka.PLAIN, **kw)
    _equal(got, want)
    feasible, score, relaxed = got
    masked = torch.where(feasible, score, float("-inf"))
    allowed = feasible.any(dim=1)
    _equal([ka.desirability(feasible, masked, allowed, fixed=True)],
           [ka.desirability_plain(feasible, masked, allowed, fixed=True)])
    K = ka._fallback_depth(snap.nodes.valid.shape[0])
    wf = (snap, st, used, relaxed, score, relaxed.any(dim=1), rank, K, dom)
    deal = ka._spread_waterfill_deal(*wf, ka.KERNELS)
    _equal(deal, ka._spread_waterfill_deal(*wf, ka.PLAIN))
    assert deal[2].any()
    for sign in (1.0, -1.0):
        a = (static.sig_match, dom, choice, kept, sign)
        _equal(_state(kp.pair_commit(snap, kp.copy_state(st), *a)),
               _state(kp.pair_commit_plain(snap, kp.copy_state(st), *a)))
        n = (used, choice, kept, snap.pods.requests, rank, sign)
        _equal([ka.node_add(*n)], [ka.node_add_plain(*n)])
    esn = torch.where(kept, choice, -1)
    ia = (snap, st, static.sig_match, dom, choice, esn)
    _equal([kp.ia_ok_at_choice(*ia)], [kp.ia_ok_at_choice_plain(*ia)])
    ex = (snap, static.aff_ok, rank, choice, kept, st, dom)
    _equal([ka._spread_excess_mask(*ex, ka.KERNELS)],
           [ka._spread_excess_mask(*ex, ka.PLAIN)])


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_pairwise_solve_equal_plain(cuda, mix, tie_break):
    """A fast solve with signatures equals its plain-version solve (host
    reads included), and compacted rounds equal full-width ones."""
    snap = _pair_snap(cuda, mix)
    outs = []
    for cap, ops in ((-1, ka.KERNELS), (-1, ka.PLAIN), (8, ka.KERNELS),
                     (0, ka.KERNELS)):
        cfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=5,
                           compact_cap=cap)
        stats = ka.RoundStats()
        outs.append((_pack_solve(solve_core(cfg, snap, ops=ops,
                                            stats=stats)),
                     stats.host_reads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert torch.equal(outs[2][0], outs[3][0])


# -- gangs and preemption ---------------------------------------------------


def _victim_case(case):
    """Victim tables for K15: ties (identical victims on identical
    nodes), all-inf (no victim is eligible), exhausted budgets (every
    victim under a budget with nothing left), one huge segment (one node
    holding more victims than the CTA has threads), spilled segments
    (nodes with more victims than K15's planes hold, their tails read in
    the sorted order) and many budgets (20 budgets, more than K15 counts
    in registers on a node, so that some victims count their segment
    again). (snapshot, preemptor priority, requests [cpu, memory,
    pods])."""
    b = SnapshotBuilder(EngineConfig(preemption=True))
    mem = 64 << 30
    if case == "six_resources":
        return _six_resource_cluster(6), 500.0, [2500.0, float(1 << 30),
                                                 1.0, 1.0, 2.0, 1.0]
    if case in ("spilled", "many_budgets"):
        per = kpre.PLANE_CAP + 9 if case == "spilled" else 24
        for n in range(5):
            b.add_node(f"n{n}", {"cpu": 100 * per, "memory": mem,
                                 "pods": 200})
            for j in range(per):
                g = (n + j) % (20 if case == "many_budgets" else 3)
                b.add_running_pod(
                    f"n{n}", {"cpu": 100, "memory": 1 << 20},
                    priority=(j * 7) % 11, slack=(j % 5) / 20.0,
                    pdb_group=f"g{g}" if j % 4 != 1 else None,
                    pdb_disruptions_allowed=(n + j) % 3)
        return b.build()[0], 500.0, [100.0 * (per - 3), 1 << 22, 1.0]
    if case == "huge_segment":
        b.add_node("big", {"cpu": 3000 * 10, "memory": mem, "pods": 5000})
        for i in range(3000):
            b.add_running_pod("big", {"cpu": 10, "memory": 1 << 20},
                              priority=i % 7, slack=(i % 13) / 40.0,
                              pdb_group=f"b{i % 3}" if i % 4 == 0 else None,
                              pdb_disruptions_allowed=i % 3)
        return b.build()[0], 500.0, [400.0, 1 << 28, 1.0]
    for n in range(6):
        b.add_node(f"n{n}", {"cpu": 4000, "memory": mem})
        for j in range(4):
            kw = {}
            if case == "exhausted_budgets":
                kw = dict(pdb_group=f"g{(n + j) % 3}",
                          pdb_disruptions_allowed=0)
            prio, slack = ((10.0, 0.1) if case == "ties"
                           else (10.0 + j, 0.05 * j))
            b.add_running_pod(f"n{n}", {"cpu": 1000, "memory": 1 << 30},
                              priority=prio, slack=slack, **kw)
    p_prio = 1.0 if case == "all_inf" else 500.0
    return b.build()[0], p_prio, [2500.0, float(1 << 30), 1.0]


# Three extended resources beside cpu, memory and pods: R = 6, past the
# four requests K15 sums in registers.
SIX = EngineConfig().resources + ("gpu", "fpga", "nic")


def _six_resource_cluster(n_nodes, pending=0):
    """Nodes full of running pods that hold every one of six resources,
    a third under budgets, and `pending` pods that fit only by
    preemption."""
    b = SnapshotBuilder(EngineConfig(preemption=True, resources=SIX))
    full = {"cpu": 4000, "memory": 64 << 30, "pods": 110, "gpu": 8,
            "fpga": 8, "nic": 4}
    for n in range(n_nodes):
        b.add_node(f"n{n}", full)
        for j in range(4):
            b.add_running_pod(
                f"n{n}", {"cpu": 1000, "memory": 16 << 30, "gpu": 2,
                          "fpga": 2, "nic": 1},
                priority=10.0 + (n + j) % 5, slack=0.05 * j,
                pdb_group=f"g{(n + j) % 3}" if j % 3 == 0 else None,
                pdb_disruptions_allowed=n % 2)
    for p in range(pending):
        b.add_pod(f"p{p}", {"cpu": 1500, "memory": 8 << 30, "gpu": 3,
                            "fpga": 1, "nic": 1}, priority=400.0 + p)
    return b.build()[0]


@pytest.mark.parametrize("case", ["ties", "all_inf", "exhausted_budgets",
                                  "huge_segment", "spilled",
                                  "many_budgets", "six_resources"])
def test_k15_equal_plain(cuda, case):
    snap, p_prio, req = _victim_case(case)
    snap = snap.to(cuda)
    cfg = EngineConfig(preemption=True)
    ctx = kpre.precompute(cfg, snap)
    M = ctx.perm.shape[0]
    N = snap.nodes.valid.shape[0]
    rng = np.random.default_rng(0)
    req_t = torch.tensor(req, dtype=torch.float32, device=cuda)
    prio = torch.tensor(p_prio, dtype=torch.float32, device=cuda)
    found = 0
    for trial in range(6):
        ev = torch.from_numpy(rng.random(M) < 0.15 * (trial % 3)).to(cuda)
        ev &= snap.running.valid
        allowed = torch.from_numpy(rng.random(N) < 0.9).to(cuda)
        allowed[0] = True
        used = snap.nodes.used * torch.from_numpy(rng.uniform(
            0.9, 1.0, size=(N, 1)).astype(np.float32)).to(cuda)
        a = (cfg, snap, ctx, prio, req_t, allowed, used, ev)
        got, want = kpre.preempt_step(*a), kpre.preempt_step_plain(*a)
        _equal(got, want)
        found += bool(got[1])
    assert found == 0 if case == "all_inf" else found > 0


def _preempt_snap(cuda, pair, seed=45):
    kw = dict(spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2) \
        if pair else {}
    snap, _ = tsynth.config5_preemption(np.random.default_rng(seed), 96, 16,
                                        **kw)
    return snap.to(cuda)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_k4_preempt_equal_plain(cuda, pair, tie_break):
    """K4's preemption variants against their plain versions: assignment,
    chosen, used, evictions (and the final pair state with signatures,
    which is K10's recount at the assignment less the evicted pods)."""
    snap = _preempt_snap(cuda, pair)
    cfg = EngineConfig(preemption=True, tie_break=tie_break, tie_seed=3)
    ctx = kpre.precompute(cfg, snap)
    order = ka.pop_order(cfg, snap)
    if not pair:
        static = _static(cfg, snap)
        got = ka.parity_scan_preempt(cfg, snap, static, order, ctx)
        want = ka.parity_scan_preempt_plain(cfg, snap, static, order, ctx)
        _equal(got, want)
        assert got[3].any()
        return
    static, dom, st = _pair_setup(cfg, snap)
    assert dom.shape[0] > 0
    got = ka.parity_scan_pair_preempt(cfg, snap, static, order, st, dom, ctx)
    want = ka.parity_scan_pair_preempt_plain(cfg, snap, static, order, st,
                                             dom, ctx)
    _equal(got[:3], want[:3])
    _equal(_state(got[3]), _state(want[3]))
    _equal([got[4]], [want[4]])
    assert got[4].any()
    rec = kp.pair_counts(static.sig_match, dom, snap.running, snap.pods,
                         assigned=got[0])
    left = kp.pair_state_evict(snap, rec, static.sig_match, dom, got[4])
    _equal(_state(got[3]), _state(left))


def test_k4_preempt_six_resources_equal_plain(cuda):
    """K4's preemption variant with six resources (K15's sums in local
    memory) against its plain version: assignment, chosen, used and
    evictions."""
    snap = _six_resource_cluster(8, pending=12).to(cuda)
    cfg = EngineConfig(preemption=True, resources=SIX)
    ctx = kpre.precompute(cfg, snap)
    order = ka.pop_order(cfg, snap)
    static = _static(cfg, snap)
    got = ka.parity_scan_preempt(cfg, snap, static, order, ctx)
    _equal(got, ka.parity_scan_preempt_plain(cfg, snap, static, order, ctx))
    assert got[3].any()


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("pair", [False, True])
def test_gang_solve_equal_plain(cuda, mode, pair):
    """Gang snapshots through the four solve paths (K4 and its pairwise
    variant, fast rounds with and without signatures) with the gang gate
    (K8's node_add and K10's pair_commit, sign -1) equal their plain
    solves, and no group is left partial."""
    kw = dict(spread_frac=0.4, interpod_frac=0.4) if pair else {}
    snap, _ = tsynth.config4_gangs(np.random.default_rng(44), n_groups=24,
                                   gang_size=4, n_nodes=10, **kw)
    snap = snap.to(cuda)
    cfg = EngineConfig(mode=mode)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)
    res = Engine.unpack(snap, got.cpu().numpy())
    group = snap.pods.group.cpu().numpy()
    gmin = snap.group_min_member.cpu().numpy()
    for g in range(gmin.shape[0]):
        n = int(((group == g) & (res.assignment >= 0)).sum())
        assert n == 0 or n >= gmin[g]
    assert ((group >= 0) & (res.assignment < 0)).any()


@pytest.mark.parametrize("pair", [False, True])
def test_preempt_solve_equal_plain(cuda, pair):
    snap = _preempt_snap(cuda, pair, seed=7)
    cfg = EngineConfig(preemption=True)
    got = _pack_solve(solve_core(cfg, snap))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN))
    assert torch.equal(got, want)


# -- the fast preemption auction: K16-K18 and K6 at K = 256 -------------------


def _auction_args(cuda, P, N, seed=45, C=None, pair=False):
    """A config-5 snapshot on the card, its node-major victim table and a
    random mid-solve auction state: (cfg, snap, ctx, evicted, used,
    bidders' rows, priorities, requests, plain claimants, their nodes,
    ranks)."""
    kw = dict(spread_frac=0.3, interpod_frac=0.3) if pair else {}
    snap, _ = tsynth.config5_preemption(np.random.default_rng(seed), P, N,
                                        **kw)
    snap = snap.to(cuda)
    cfg = EngineConfig(mode="fast", preemption=True)
    ctx = kpre.precompute_nv(cfg, snap, ka._PREEMPT_VICTIM_CAP)
    M = snap.running.valid.shape[0]
    Pb, Nb = snap.pods.valid.shape[0], snap.nodes.valid.shape[0]
    C = C or min(Pb, ka._PREEMPT_BATCH)
    g = torch.Generator(device="cpu").manual_seed(seed)
    ev = (torch.rand(M, generator=g) < 0.1).to(cuda) & snap.running.valid
    used = snap.nodes.used * (0.95 + 0.1 * torch.rand(Nb, 1, generator=g)).to(
        cuda)
    rows = torch.randperm(Pb, generator=g)[:C].to(torch.int32).to(cuda)
    prio = ka.effective_priority(cfg, snap.pods.base_priority,
                                 snap.pods.slo_target,
                                 snap.pods.observed_avail)[rows.long()]
    req = snap.pods.requests[rows.long()].contiguous()
    can_plain = (torch.rand(C, generator=g) < 0.1).to(cuda)
    n_plain = torch.randint(0, Nb, (C,), generator=g).to(torch.int32).to(cuda)
    rank = torch.randperm(C, generator=g).to(torch.int32).to(cuda)
    return cfg, snap, ctx, ev, used, rows, prio, req, can_plain, n_plain, rank


@pytest.mark.parametrize("size", ["small", "full"])
def test_k16_to_k18_equal_plain(cuda, size):
    """Each auction kernel against its plain version on the same CUDA
    tensors, exactly, on the arguments the auction gives it: K17's
    auction_ok, K16 on the thresholds of the active bidders, K17's
    ranking, K6 at K = 256 on the bids, K18 on K6's candidates; at a small
    size and at config 5's 10 000 x 5 000 (C = 1 024 bidders)."""
    P, N = (96, 16) if size == "small" else (10000, 5000)
    (cfg, snap, ctx, ev, used, rows, prio, req, can_plain, n_plain,
     rank) = _auction_args(cuda, P, N)
    C = rows.shape[0]
    Nb = snap.nodes.valid.shape[0]
    pre = ~can_plain
    mask = ka.precompute_static(cfg, snap, _sat_tables(snap)[0]).mask
    got_ok = kpre.auction_ok(mask, rows, None, pre, snap.nodes.valid)
    want_ok = kpre.auction_ok_plain(mask, rows, None, pre, snap.nodes.valid)
    _equal(got_ok, want_ok)
    pair_ok = torch.rand(C, Nb, device=cuda) < 0.8
    _equal(kpre.auction_ok(mask[rows.long()].contiguous(), None, pair_ok,
                           pre, snap.nodes.valid),
           kpre.auction_ok_plain(mask[rows.long()], None, pair_ok, pre,
                                 snap.nodes.valid))
    ok, any_ok = got_ok
    thr = kpre.prio_thresholds(prio, any_ok & pre)
    lanes = torch.cat([thr, torch.full((1,), float("inf"), device=cuda)])
    rem = kpre.pdb_remaining(snap, ev).contiguous()
    tabs = kpre.auction_tables(ctx, ev, lanes, rem, 0.0)
    _equal(tabs, kpre.auction_tables_plain(ctx, ev, lanes, rem, 0.0))
    lane = kpre.bucket_of(thr, prio)
    args = (*tabs, lane, ok, used, snap.nodes.allocatable, req)
    bid, could = kpre.auction_rank(*args)
    _equal((bid, could), kpre.auction_rank_plain(*args))
    assert torch.isfinite(bid).any()
    K = min(256, Nb)
    topv, topi, _ = ka.row_topk(bid, K)
    _equal((topv, topi), ka.row_topk_plain(bid, K)[:2])
    cargs = (topv, topi, can_plain, n_plain, rank, ctx, ev, prio, req,
             used, snap.nodes.allocatable, could, 0.0,
             snap.pdb_allowed.shape[0])
    got = kpre.auction_claim(*cargs)
    _equal(got, kpre.auction_claim_plain(*cargs))
    assert got[2].any()


def _claim_args(cuda, case, draw=0):
    """K18's arguments of one case over a config-5 state of 600 pods on
    60 nodes: each bidder's K = min(256, N) candidates distinct nodes with
    descending finite bids, a random tail of each row -inf, a tenth of
    the bidders plain claimants; `draw` seeds the candidates, ranks and
    flags."""
    seed = 45
    C = {"c1": 1, "c45": 45}.get(case, 200)
    (cfg, snap, ctx, ev, used, rows, prio, req, can_plain, n_plain,
     rank) = _auction_args(cuda, 600, 60, seed=seed, C=C)
    N = snap.nodes.valid.shape[0]
    alloc = snap.nodes.allocatable
    if case == "n_ragged":          # N not a multiple of the cluster
        N -= 5
        ctx = type(ctx)(*(getattr(ctx, f.name)[:N]
                          for f in dataclasses.fields(ctx)))
        used, alloc = used[:N].contiguous(), alloc[:N].contiguous()
        n_plain = n_plain.clamp(max=N - 1)
    K = min(256, N)
    g = torch.Generator(device="cpu").manual_seed(seed + draw)
    if draw:
        rank = rank[torch.randperm(C, generator=g).to(rank.device)]
    topi = torch.stack([torch.randperm(N, generator=g)[:K]
                        for _ in range(C)]).to(torch.int32)
    topv = -torch.sort(torch.rand(C, K, generator=g), dim=1).values
    topv[torch.arange(K)[None, :] > (0.8 * K * torch.rand(C, 1,
                                                          generator=g))] = \
        float("-inf")
    if case == "nonfinite":
        topv[:] = float("-inf")
    if case == "one_node":
        topi[:] = 3
    if case == "all_plain":
        can_plain = torch.ones_like(can_plain)
    could = torch.rand(C, generator=g) < 0.7
    return (topv.to(cuda), topi.to(cuda), can_plain, n_plain, rank, ctx,
            ev, prio, req, used, alloc, could.to(cuda), 0.0,
            snap.pdb_allowed.shape[0])


@pytest.mark.parametrize("Q", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["random", "c1", "c45", "nonfinite",
                                  "all_plain", "one_node", "n_ragged",
                                  "tenants8"])
def test_k18_cases_equal_plain(cuda, case, Q):
    """K18 over a cluster of Q CTAs, a warp a bidder, against its plain
    version, exactly, at every Q: one bidder, 45 (not a multiple of 32),
    no finite candidate, only plain claimants, every bidder naming one
    node, N not a multiple of Q, and a batch of 8 tenants (each tenant
    also equal to its own launch)."""
    if case == "tenants8":
        per = [_claim_args(cuda, "random", draw=b) for b in range(8)]
        a = tuple(stack_tenants([p[i] for p in per])
                  if isinstance(per[0][i], torch.Tensor)
                  or dataclasses.is_dataclass(per[0][i]) else per[0][i]
                  for i in range(len(per[0])))
    else:
        a = _claim_args(cuda, case)
    got = kpre.auction_claim(*a, cluster=Q)
    _equal(got, kpre.auction_claim_plain(*a))
    if case == "tenants8":
        for t in range(8):
            _equal([g[t] for g in got],
                   kpre.auction_claim(*(_tenant_of(x, t) for x in a),
                                      cluster=Q))
    claimed = got[1]
    if case == "nonfinite":
        assert not (claimed & ~a[2]).any()
    elif case == "one_node":
        assert int((claimed & ~a[2]).sum()) <= 1
    elif case != "c1":
        assert claimed.any()


def _rank_args(cuda, C, N, V, R, lead=(), seed=0, ties=False, L=3):
    """K17's arguments on seeded numpy draws: lane tables as prefixes of
    small non-negative steps (the optimistic lane L - 1 frees 8 more a
    victim), half the bidders in each bucket lane, 70 % of the cells
    allowed; row 0 allows no node, and row 1 asks for more than any
    bucket lane frees but less than the optimistic lane does, so that
    only its fallback is feasible. ties: no violation and every victim
    costing the same, so the minimum ties on every feasible node."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    inc = g.choice([0.0, 0.5, 1.0, 2.0], size=(*lead, L, N, V, R))
    inc[..., L - 1, :, :, :] += 8.0
    cum_req = np.cumsum(inc.astype(f32), axis=-2, dtype=f32)
    cost = g.choice([0.0, 1.0, 2.0, 3.0], size=(*lead, L, N, V))
    viol = g.random((*lead, L, N, V)) < 0.2
    if ties:
        cost[:] = 1.0
        viol[:] = False
    cum_cost = np.cumsum(cost.astype(f32), axis=-1, dtype=f32)
    cum_viol = np.cumsum(viol, axis=-1).astype(np.int32)
    lane = g.integers(0, L - 1, size=(*lead, C)).astype(np.int32)
    ok = g.random((*lead, C, N)) < 0.7
    alloc = g.uniform(2.0, 8.0, size=(*lead, N, R)).astype(f32)
    used = (alloc * g.uniform(0.5, 1.1, size=(*lead, N, R))).astype(f32)
    p_req = g.choice([0.0, 0.5, 1.0, 3.0, 8.0],
                     size=(*lead, C, R)).astype(f32)
    ok[..., 0, :] = False
    if C > 1:
        ok[..., 1, :] = True
        p_req[..., 1, :] = 2.0 * V + 5.0
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in (
        cum_req, cum_cost, cum_viol, lane, ok, used, alloc, p_req))


def _rank_check(a, C):
    """K17 at the policy's cluster size and at every cluster size equal
    to its plain version; the two edge rows as _rank_args made them."""
    want = kpre.auction_rank_plain(*a)
    for Q in (None, *kpre.RANK_CLUSTERS):
        _equal(kpre.auction_rank(*a, cluster=Q), want)
    bid, could = want
    assert not torch.isfinite(bid[..., 0, :]).any() and not could[..., 0].any()
    if C > 1:
        assert could[..., 1].all()
        assert torch.isfinite(bid[..., 1, :]).any(dim=-1).all()
    return bid


@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("V", [1, 7, 16, 32])
def test_k17_shapes_equal_plain(cuda, V, R):
    """K17 (a tile of 32 bidders a cluster, chunks of 64 nodes) against
    its plain version, exactly, at V victims and R resources, with C = 45
    bidders and N = 300 nodes (neither a multiple of its tile): a bidder
    with no allowed node and one that only its optimistic lane serves."""
    bid = _rank_check(_rank_args(cuda, 45, 300, V, R, seed=V * 10 + R), 45)
    assert torch.isfinite(bid).any()


@pytest.mark.parametrize("case", ["ties", "one", "tiles", "lanes6",
                                  "tenants1", "tenants8"])
def test_k17_cases_equal_plain(cuda, case):
    """K17 against its plain version, exactly: the violation minimum and
    the costs tied on every node, one bidder on one node, C and N whole
    tiles and chunks, six lanes (more than the kernel orders bidders by:
    tiles in index order), and the tenant axis at B = 1 and B = 8 (each
    tenant also equal to its own launch)."""
    C, N, lead = {"ties": (70, 200, ()), "one": (1, 1, ()),
                  "tiles": (64, 128, ()), "lanes6": (45, 300, ()),
                  "tenants1": (45, 300, (1,)),
                  "tenants8": (45, 300, (8,))}[case]
    a = _rank_args(cuda, C, N, 16, 3, lead=lead, seed=3,
                   ties=case == "ties", L=6 if case == "lanes6" else 3)
    bid = _rank_check(a, C)
    if case == "ties":
        row = bid[2:]
        fin = torch.isfinite(row)
        assert (fin.sum(dim=-1) > 1).any()
    if lead:
        got = kpre.auction_rank(*a)
        for t in range(lead[0]):
            _equal([x[t] for x in got],
                   kpre.auction_rank(*(x[t] for x in a)))


def _k11_args(cuda, C, N, case="random", seed=0):
    """K11's arguments: a config-3 snapshot's pods with C spread slots
    and their terms redrawn (seeded numpy), on N nodes with random
    domains (10 % key-less) and integer counts; all nodes invalid
    ("invalid"), or one count everywhere with every node keyed, so that
    every penalty and every raw score of a row is equal ("equal")."""
    snap, _ = tsynth.make_cluster(np.random.default_rng(43 + seed), 40, 8,
                                  spread_frac=0.5, interpod_frac=0.5)
    P, M = snap.pods.valid.shape[0], snap.running.valid.shape[0]
    IT = snap.pods.ia_sig.shape[1]
    S = 6
    g = np.random.default_rng(seed)
    D = max(1, N // 3)
    dom = g.integers(0, D, size=(S, N))
    dom[g.random((S, N)) < 0.1] = -1
    counts = g.integers(0, 6, size=(S, N)).astype(np.float32)
    nvalid = g.random(N) < 0.9
    if case == "invalid":
        nvalid[:] = False
    elif case == "equal":
        dom = np.abs(dom)
        counts[:] = 2.0
    anti = (g.random((S, N)) < 0.05).astype(np.float32)
    match_tot = counts.sum(axis=1)
    match_tot[0] = 0.0
    t = lambda x, dt=None: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x if dt is None else x.astype(dt))).to(cuda)
    pods = dataclasses.replace(
        snap.pods.to(cuda), ts_key=t(np.zeros((P, C), np.int32)),
        ts_sig=t(g.integers(0, S, size=(P, C)), np.int32),
        ts_valid=t(g.random((P, C)) < 0.7),
        ts_when=t(g.integers(0, 2, size=(P, C)), np.int8),
        ts_max_skew=t(g.integers(1, 4, size=(P, C)), np.float32),
        ia_sig=t(g.integers(0, S, size=(P, IT)), np.int32),
        ia_valid=t(g.random((P, IT)) < 0.8),
        ia_anti=t(g.random((P, IT)) < 0.4),
        ia_required=t(g.random((P, IT)) < 0.5),
        ia_weight=t(g.integers(1, 100, size=(P, IT)), np.float32))
    snap = dataclasses.replace(snap.to(cuda), pods=pods, nodes=dataclasses.replace(
        snap.nodes.to(cuda), valid=t(nvalid)))
    st = kp.PairState(counts=t(counts), anti=t(anti), match_tot=t(match_tot))
    return (snap, st, t(g.random((P, N)) < 0.8),
            t(g.random((S, M + P)) < 0.3), t(dom, np.int32))


@pytest.mark.parametrize("case", ["c0", "c1", "c16", "invalid", "equal",
                                  "n1", "n8300", "n24576", "n24577",
                                  "tenants8"])
def test_k11_cases_equal_plain(cuda, case):
    """K11 (a row's raw cells held on chip, each output written once, the
    spread slots reduced together) against its plain version, exactly,
    with and without ia_ok: 0, 1 and 16 spread slots on N = 300 nodes
    (not a multiple of the CTA), all nodes invalid, a row of equal
    penalties and raw scores (the 100 and 0 branches), one node, rows
    whose raw cells are staged in shared memory (8 300 nodes, and 24 576,
    the widest at 8 bytes a node within 192 KB) or held in the output
    rows (24 577), and eight tenants in one launch (each also equal to
    its own launch)."""
    C = {"c0": 0, "c1": 1, "c16": 16}.get(case, 2)
    N = {"n1": 1, "n8300": 8300, "n24576": 24576,
         "n24577": 24577}.get(case, 300)
    if case == "tenants8":
        per = [_k11_args(cuda, C, N, seed=b) for b in range(8)]
        a = tuple(stack_tenants([p[i] for p in per]) for i in range(5))
    else:
        a = _k11_args(cuda, C, N, case)
    for with_ia_ok in (False, True):
        got = kp.pairwise_batch(*a, with_ia_ok=with_ia_ok)
        _equal(got, kp.pairwise_batch_plain(*a, with_ia_ok=with_ia_ok))
        if case == "tenants8":
            for b in range(8):
                _equal([x[b] for x in got],
                       kp.pairwise_batch(*per[b], with_ia_ok=with_ia_ok))
    if case == "equal":
        assert (got[1] == 100.0).all() and (got[2] == 0.0).all()
    elif case == "invalid":
        assert (got[1] == 100.0).all()


def _tie_rows(n, seed):
    """Rows that stress K6's ties: all -inf, all equal, -0.0 and +0.0
    mixed (with -inf), three values (a wide tie at the K-th), and
    bid-like rows (negated integer costs, -inf half the time)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pm0 = torch.where(torch.rand(n, generator=g) < 0.5, torch.tensor(-0.0),
                      torch.tensor(0.0))
    rows = [torch.full((n,), float("-inf")), torch.full((n,), -7.0), pm0,
            torch.where(torch.rand(n, generator=g) < 0.2,
                        torch.tensor(float("-inf")), pm0),
            -torch.randint(1, 4, (n,), generator=g).to(torch.float32)]
    bids = -torch.randint(1, 50, (11, n), generator=g).to(torch.float32)
    bids[torch.rand(11, n, generator=g) < 0.5] = float("-inf")
    return torch.cat([torch.stack(rows), bids])


@pytest.mark.parametrize("N", [300, 1000, 2048])
@pytest.mark.parametrize("K", [17, 64, 256, "N"])
def test_k6_radix_equal_plain(cuda, N, K):
    """K6's radix path (csrc/topk.cu row_topk_radix_kernel) against its
    plain version, exactly, on tie rows, solo [rows, N] and as a
    [B, C, N] batch; N = 300 and 1000 are not multiples of 256. Then
    row_topk's route for K, seeded and not (above 32 seeded: the radix
    select's top-K and the warp kernel's pick)."""
    K = N if K == "N" else min(K, N)
    m = _tie_rows(N, N + K).to(cuda)
    for x in (m, m.reshape(2, 8, N)):
        _equal(ka.row_topk_path(x, K, radix=True), ka.row_topk_plain(x, K))
        _equal(ka.row_topk(x, K), ka.row_topk_plain(x, K))
        ids = torch.arange(x.shape[-2], dtype=torch.int32,
                           device=cuda).expand(x.shape[:-1]).contiguous()
        _equal(ka.row_topk(x, K, True, 5, ids),
               ka.row_topk_plain(x, K, True, 5, ids))


@pytest.mark.parametrize("N", [300, 5120])
def test_k6_k256_equal_plain(cuda, N):
    """K6 at the auction's K = 256 on a bid-like block (negated costs
    with ties, -inf where no bid) against its plain version, exactly."""
    g = torch.Generator(device="cpu").manual_seed(N)
    m = -torch.randint(1, 50, (64, N), generator=g).to(torch.float32)
    m[torch.rand(64, N, generator=g) < 0.5] = float("-inf")
    m[:2] = float("-inf")
    m = m.to(cuda)
    _equal(ka.row_topk(m, 256)[:2], ka.row_topk_plain(m, 256)[:2])


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_preempt_solve_equal_plain(cuda, pair, tie_break):
    """A fast solve with preemption (the auction rounds; with signatures
    the pairwise-involved claimants and the validation fixpoint) equals
    its plain solve on the same CUDA tensors, evictions and host reads
    included, and evicts."""
    snap = _preempt_snap(cuda, pair, seed=9)
    cfg = EngineConfig(mode="fast", preemption=True, tie_break=tie_break,
                       tie_seed=5)
    s1, s2 = ka.RoundStats(), ka.RoundStats()
    got = _pack_solve(solve_core(cfg, snap, stats=s1))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN, stats=s2))
    assert torch.equal(got, want)
    assert s1.host_reads == s2.host_reads
    res = Engine.unpack(snap, got.cpu().numpy())
    assert res.evicted.any()


@pytest.mark.parametrize("P,N", [(300, 40), (10240, 5120)])
def test_k19_equal_plain(cuda, P, N):
    """K19 (the carried capacity prefix) against its plain version on
    config-5-like magnitudes, exactly: both sum each node's rows from
    0.0 in rank order."""
    g = np.random.default_rng(P)
    alloc = np.stack([g.choice([4000.0, 8000.0, 16000.0], N),
                      g.choice([16.0, 64.0, 128.0], N) * float(1 << 30),
                      np.full(N, 110.0)], axis=1).astype(np.float32)
    used = np.floor(alloc * g.uniform(0.5, 0.9, (N, 3))).astype(np.float32)
    req = np.stack([g.integers(100, 4000, P), g.integers(1 << 28, 8 << 30, P),
                    np.ones(P)], axis=1).astype(np.float32)
    node = g.integers(-1, N, P).astype(np.int32)
    rank = g.permutation(P).astype(np.int32)
    active = (node >= 0) & (g.random(P) < 0.9)
    args = [torch.from_numpy(a).to(cuda)
            for a in (alloc, used, req, node, rank, active)]
    got = ka.capacity_prefix_keep(*args)
    _equal((got,), (ka.capacity_prefix_keep_plain(*args),))
    assert got.any() and (args[5] & ~got).any()


@pytest.mark.parametrize("S,dirty", [(0, False), (4, True), (32, True)])
def test_k20_equal_plain(cuda, S, dirty):
    """K20 (the frontier closure and static revalidation) against its
    plain version, exactly."""
    g = np.random.default_rng(S)
    P, N = 2000, 300
    invol = (g.random((P, S)) < 0.02) if S else None
    valid = g.random(P) < 0.9
    carry = np.where(valid, g.integers(-1, N, P), -1).astype(np.int32)
    arrs = (invol, g.random(P) < 0.02, valid, carry,
            (g.random(N) < 0.05) if dirty else None, g.random((P, N)) < 0.8)
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in arrs]
    got = ka.frontier_closure(*args)
    _equal(got, ka.frontier_closure_plain(*args))
    assert got[0].any() and got[1].any()


@pytest.mark.parametrize("pair", [False, True])
def test_warm_and_incremental_on_the_card(cuda, pair):
    """A lineage on the card: each warm solve equals a cold solve
    bitwise, the incremental solve keeps a zero audit, and both equal
    the same solves through the plain versions on the same tensors."""
    from tpusched_torch.device_state import DeviceSnapshot

    kw = dict(spread_frac=0.4, interpod_frac=0.4) if pair else {}
    nodes, pods, running = tsynth.make_cluster(
        np.random.default_rng(3), 200, 40, as_records=True, **kw)
    nodes, pods, running = list(nodes), list(pods), list(running)
    eng = Engine(EngineConfig(mode="fast"))
    ds = DeviceSnapshot(eng.config)
    ds.full_load(nodes, pods, running)
    assert ds.snap.pods.valid.is_cuda
    eng.solve_warm(ds)
    rng = np.random.default_rng(4)
    for cyc, delta in enumerate(tsynth.warm_churn_stream(
            rng, nodes, pods, running, 4, churn_frac=0.05,
            structural_every=2)):
        ds.apply(**delta)
        res = eng.solve_warm(ds, incremental=cyc % 2 == 1)
        if cyc % 2:
            assert res.inc_info["audit_violations"] == 0, res.inc_info
        else:
            cold = eng.solve(ds.snap)
            np.testing.assert_array_equal(res.assignment, cold.assignment)
            np.testing.assert_array_equal(res.chosen_score,
                                          cold.chosen_score)
        assert res.h2d_bytes < ds.full_bytes
    assert ds.warm_solves == 2 and ds.incremental_solves == 2
    tab = ds.warm_state.tableau  # tpl: disable=TPL011(read right after its refresh)
    P = ds.snap.pods.valid.shape[0]
    carry = torch.full((P,), -1, dtype=torch.int32, device=cuda)
    carry[:P // 2] = torch.arange(P // 2, device=cuda,
                                  dtype=torch.int32) % 40
    chosen = torch.zeros(P, device=cuda)
    fr = torch.zeros(P, dtype=torch.bool, device=cuda)
    fr[::7] = True
    dn = torch.zeros(ds.snap.nodes.valid.shape[0], dtype=torch.bool,
                     device=cuda)
    dn[3] = True
    outs = [ka.solve_incremental(eng.config, ds.snap, tab, carry, chosen, fr,
                                 dn, 64, ops=ops)
            for ops in (ka.KERNELS, ka.PLAIN)]
    for got, want in zip(*outs):
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    eng.close()


def test_async_forms_on_the_card(cuda):
    """solve_async, score_async and score_topk_async equal their
    synchronous forms on the card; result() waits on the copy's event."""
    snap = _snap(cuda)
    for mode in ("parity", "fast"):
        eng = Engine(EngineConfig(mode=mode))
        a = eng.solve_async(snap).result(timeout=60.0)
        b = eng.solve(snap)
        for f in ("assignment", "chosen_score", "order", "commit_key",
                  "final_used", "evicted", "rounds"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if mode == "parity":
            eng.close()
    s1, s2 = eng.score_async(snap).result(), eng.score(snap)
    np.testing.assert_array_equal(s1.scores, s2.scores)
    np.testing.assert_array_equal(s1.feasible, s2.feasible)
    t1, t2 = eng.score_topk_async(snap, 4).result(), eng.score_topk(snap, 4)
    np.testing.assert_array_equal(t1[0], t2[0])
    np.testing.assert_array_equal(t1[1], t2[1])
    eng.close()


# -- the device queue (K21) ---------------------------------------------------


def _queue_table(rng, q, fill=0.9, now=60.0):
    """A random pending table with priority ties (integer bases, shared
    SLO buckets), parked, never-observed and empty slots, unique arrival
    stamps (some above 2**31)."""
    t = kq.empty_table(q)
    n = int(q * fill)
    slots = rng.choice(q, size=n, replace=False)
    t.valid[slots] = True
    t.base_priority[slots] = rng.integers(0, 6, n).astype(np.float32)
    t.slo_target[slots] = rng.choice(np.float32([0.0, 0.9, 0.99]), size=n)
    t.submitted[slots] = rng.uniform(0.0, now, n).astype(np.float32)
    t.submitted[slots[:3]] = np.float32(now)
    t.run_seconds[slots] = rng.uniform(0.0, 30.0, n).astype(np.float32)
    parked = slots[rng.random(n) < 0.25]
    t.parked_until[parked] = rng.uniform(0.0, 2 * now,
                                         parked.size).astype(np.float32)
    t.seq[slots] = (rng.permutation(n) + (2**31 - n // 2)).astype(np.uint32)
    return t


@pytest.mark.parametrize("q", [5, 64, 1000, 16384])
def test_k21_equal_plain_and_reference(cuda, q):
    """K21 against its plain version and the numpy oracle, bit for bit:
    the full order, every priority's bits, both counts; the window at
    kb = 1024 (or Q) is the order's prefix with its priorities."""
    t = _queue_table(np.random.default_rng(q), q)
    dt = kq.to_device(t, cuda)
    got = kq.rank_full(dt, 60.0, 1000.0)
    want = kq.queue_rank_plain(dt, 60.0, 1000.0)
    _equal(got, want)
    order, prio, ne, dep = kq.rank_reference(t, 60.0, 1000.0)
    assert np.array_equal(got[0].cpu().numpy(), order)
    assert np.array_equal(got[1].cpu().numpy().view(np.uint32),
                          prio.view(np.uint32))
    assert (int(got[2]), int(got[3])) == (ne, dep)
    kb = min(1024, q)
    win = kq.window_select(dt, 60.0, 1000.0, kb)
    _equal(win, kq.queue_rank_plain(dt, 60.0, 1000.0, kb))
    assert torch.equal(win[0], got[0][:kb])


def test_device_queue_on_the_card(cuda):
    """The queue's windows on the card equal the oracle over its mirror
    under churn, growth included."""
    from tpusched_torch.device_state import DeviceQueue

    rng = np.random.default_rng(5)
    dq = DeviceQueue(capacity=16)
    assert dq.device.type == "cuda"
    t = 0.0
    for _ in range(6):
        t += 5.0
        for _ in range(12):
            dq.upsert(f"p{int(rng.integers(0, 48)):02d}",
                      base_priority=float(rng.integers(0, 6)),
                      slo_target=float(rng.choice([0.0, 0.9])),
                      submitted=t - float(rng.uniform(0, 9)),
                      run_seconds=float(rng.uniform(0, 4)))
        dq.remove([f"p{int(rng.integers(0, 48)):02d}" for _ in range(3)])
        names, ne, dep = dq.window(t, 8)
        order, _, ne_h, dep_h = kq.rank_reference(dq._host, t - dq._epoch,
                                                  dq.qos_gain)
        assert (ne, dep) == (ne_h, dep_h)
        assert names == [dq._names[int(s)] for s in order[:min(8, ne_h)]]


# -- decision provenance (K22, K4's explain outputs) --------------------------


@pytest.mark.parametrize("case", ["config5", "config3"])
def test_k22_equal_plain(cuda, case):
    """K22's two entry points against their plain versions, exactly:
    tallies, feasible counts, the masked totals, and the six terms at K6's
    chosen cells; the whole probe buffer equal through both tables."""
    from tpusched_torch.engine import probe_core

    gen = tsynth.config5_preemption if case == "config5" else \
        tsynth.config3_pairwise
    snap, _ = gen(np.random.default_rng(45), 160, 40)
    snap = snap.to(cuda)
    cfg = EngineConfig(preemption=case == "config5")
    node_sat_t, member_sat_t = _sat_tables(snap)
    tab = ka.build_tableau(cfg, snap, node_sat_t, member_sat_t)
    q = kex.probe_inputs(cfg, snap, tab, kp.pair_counts)
    got = kex.explain_cells(q)
    want = kex.explain_cells_plain(q)
    _equal(got[:3], want[:3])
    assert (got[1] > 0).any() and (got[0] > 0).any()
    topv, topi, _ = ka.row_topk(got[2], 4)
    _equal([kex.explain_terms(q, got[3], topv, topi)],
           [kex.explain_terms_plain(q, None, topv, topi)])
    assert torch.equal(probe_core(cfg, snap, 4),
                       probe_core(cfg, snap, 4, ka.PLAIN))


@pytest.mark.parametrize("pair", [False, True])
def test_k4_explain_outputs_equal_plain(cuda, pair):
    """K4's preemption variants with the explain outputs against the
    plain scans (evictor, evict_pos and every other output), and the
    same scan without them unchanged."""
    if pair:
        snap = _preempt_snap(cuda, True)
    else:
        snap, _ = tsynth.config5_preemption(np.random.default_rng(45), 2000,
                                            1000)
        snap = snap.to(cuda)
    cfg = EngineConfig(preemption=True)
    ctx = kpre.precompute(cfg, snap)
    order = ka.pop_order(cfg, snap)
    if not pair:
        static = _static(cfg, snap)
        got = ka.parity_scan_preempt(cfg, snap, static, order, ctx,
                                     explain=True)
        want = ka.parity_scan_preempt_plain(cfg, snap, static, order, ctx,
                                            explain=True)
        _equal(got, want)
        _equal(got[:4], ka.parity_scan_preempt(cfg, snap, static, order,
                                               ctx))
        assert torch.equal(got[4] >= 0, got[3])
        return
    static, dom, st = _pair_setup(cfg, snap)
    got = ka.parity_scan_pair_preempt(cfg, snap, static, order, st, dom, ctx,
                                      explain=True)
    want = ka.parity_scan_pair_preempt_plain(cfg, snap, static, order, st,
                                             dom, ctx, explain=True)
    _equal(got[:3] + got[4:], want[:3] + want[4:])
    assert torch.equal(got[5] >= 0, got[4]) and got[4].any()


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_explained_solve_on_the_card(cuda, mode):
    """The explained solve on the card equals its plain-version twin and
    the unexplained solve, host reads included."""
    snap = _preempt_snap(cuda, False, seed=9)
    cfg = EngineConfig(mode=mode, preemption=True)
    s1, s2, s3 = ka.RoundStats(), ka.RoundStats(), ka.RoundStats()
    got = _pack_solve(solve_core(cfg, snap, stats=s1, explain=True))
    want = _pack_solve(solve_core(cfg, snap, ops=ka.PLAIN, stats=s2,
                                  explain=True))
    assert torch.equal(got, want)
    plain = _pack_solve(solve_core(cfg, snap, stats=s3))
    assert torch.equal(got[:plain.shape[0]], plain)
    assert s1.host_reads == s2.host_reads == s3.host_reads
    eng = Engine(cfg)
    res, exd, probe = eng.solve_explained(snap, k=3)
    eng.close()
    assert res.evicted.any() and (exd.evictor[res.evicted] >= 0).all()
    assert probe.topk_idx.shape[1] == 3


# -- the tenant axis (tenants.solve_many) ---------------------------------


def _tenant_batch(cuda, B=3):
    """B contended tenants of different sizes under one bucket floor
    without signatures: (their snapshots, the stack on the card)."""
    kw = dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
              affinity_frac=0.3, cordon_frac=0.1, initial_utilization=0.5)

    def draw(b, **x):
        return tsynth.make_cluster(np.random.default_rng(30 + b), 40 + 8 * b,
                                   12 + 2 * b, **kw, **x)

    floor = {}
    for b in range(B):
        for f, v in dataclasses.asdict(draw(b)[1].buckets).items():
            floor[f] = max(floor.get(f, 0), v)
    floor["signatures"] = 0
    snaps = [draw(b, buckets=Buckets(**floor))[0] for b in range(B)]
    return snaps, stack_snapshots(snaps).to(cuda)


class _Fields(types.SimpleNamespace):
    """The snapshot fields K10's commit reads, sliced by tenant as a
    snapshot is."""

    def tenant(self, b):
        return _Fields(**{k: v.tenant(b) if isinstance(v, _Fields) else v[b]
                          for k, v in vars(self).items()})


def _commit_inputs(cuda, B, P, S, N, M, IT, hot, seed):
    """K10's commit arguments: B tenants of P pods, S signatures over N
    nodes; hot: every pod at node 0 in one domain (every add of a
    signature on one address)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    dom = rng.integers(-1, min(3 if hot else 40, N), (B, S, N)).astype(
        np.int32)
    if hot:
        dom[..., 0] = 0
    ia_sig = t(rng.integers(-1, S, (B, P, IT)).astype(np.int32))
    snap = _Fields(
        pods=_Fields(ia_sig=ia_sig, ia_key=ia_sig,
                     ia_valid=t(rng.random((B, P, IT)) < 0.8),
                     ia_anti=t(rng.random((B, P, IT)) < 0.6),
                     ia_required=t(rng.random((B, P, IT)) < 0.7)),
        running=_Fields(valid=t(np.ones((B, M), bool))))
    st = kp.PairState(
        counts=t(rng.integers(0, 50, (B, S, N)).astype(np.float32)),
        anti=t(rng.integers(0, 50, (B, S, N)).astype(np.float32)),
        match_tot=t(rng.integers(0, 99, (B, S)).astype(np.float32)))
    match = t(rng.random((B, S, M + P)) < (0.9 if hot else 0.5))
    choice = (np.zeros((B, P)) if hot else rng.integers(-1, N, (B, P)))
    kept = t(rng.random((B, P)) < 0.85)
    return snap, st, match, t(dom), t(choice.astype(np.int32)), kept


@pytest.mark.parametrize("B,P,S,N,hot", [
    (1, 1, 1, 1, False), (1, 33, 4, 7, True), (1, 1025, 32, 300, False),
    (1, 10_240, 4, 5_120, True), (1, 10_240, 4, 5_120, False),
    (8, 3_072, 4, 2_048, True), (8, 3_072, 16, 2_048, False)])
def test_k10_commit_grouped_adds_equal_plain(cuda, B, P, S, N, hot):
    """K10's commit (a warp's adds grouped by address) into the state it
    is handed, against its plain version, adding and taking back: one
    pod, ragged warps, 32 signatures, every pod on one address (hot),
    eight tenants; each tenant of a batch equals its solo call."""
    snap, st, match, dom, choice, kept = _commit_inputs(
        cuda, B, P, S, N, M=17, IT=3, hot=hot, seed=P + S)
    for sign in (1.0, -1.0):
        given = kp.copy_state(st)
        got = kp.pair_commit(snap, given, match, dom, choice, kept, sign)
        assert got.counts is given.counts and got.anti is given.anti
        want = kp.pair_commit_plain(snap, kp.copy_state(st), match, dom,
                                    choice, kept, sign)
        _equal(_state(got), _state(want))
        if B > 1:
            solo = kp.pair_commit(snap.tenant(1), kp.copy_state(st.tenant(1)),
                                  match[1], dom[1], choice[1], kept[1], sign)
            _equal(_state(solo), _state(want.tenant(1)))


def _handoff_inputs(cuda, B, V, N, R, K, mode, seeded, seed):
    """deal_lists' arguments for B tenants: ties, -0.0 and -inf
    desirabilities, all-infeasible rows; mode "scatter" (rank a
    permutation), "sorted" (rank-sorted rows) or "width" (global ranks in
    a 2V-row demand, with K12's override)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    desir = rng.choice(np.float32([-3.5, -0.0, 0.0, 1.25, 2.5, 7.0,
                                   -np.inf]), (B, N))
    alloc = rng.integers(0, 64, (B, N, R)).astype(np.float32) * 0.37 + 3
    used = rng.integers(0, 64, (B, N, R)).astype(np.float32) * 0.37
    req = rng.integers(0, 12, (B, V, R)).astype(np.float32) * 0.11
    feasible = rng.random((B, V, N)) < 0.6
    feasible[:, :3] = False
    score = rng.choice(np.float32([10.0, 20.0, 20.5, 33.0]), (B, V, N))
    masked = t(np.where(feasible, score, -np.inf).astype(np.float32))
    allowed = feasible.any(axis=-1) & (rng.random((B, V)) < 0.9)
    if mode == "sorted":
        rank = np.stack([np.sort(rng.choice(3 * V, V, replace=False))
                         for _ in range(B)])
    elif mode == "width":
        rank = np.stack([rng.choice(2 * V, V, replace=False)
                         for _ in range(B)])
    else:
        rank = np.stack([rng.permutation(V) for _ in range(B)])
    topv, topi, _ = ka.row_topk_plain(masked, K)
    pick = None
    if seeded:
        pick = ka.pick_node_batch(
            EngineConfig(tie_break="seeded", tie_seed=seed), masked,
            torch.arange(V, dtype=torch.int32, device=cuda)
            .expand(B, V).contiguous())
    override = None
    if mode == "width":
        override = (t(rng.integers(0, N, (B, V, K + 1)).astype(np.int32)),
                    t(rng.choice(np.float32([5.0, -np.inf]), (B, V, K + 1))),
                    t(rng.random((B, V)) < 0.3))
    return (t(desir), t(alloc), t(used), t(req), t(allowed),
            t(rank.astype(np.int32)), t(feasible), masked, topv, topi,
            pick, override, mode == "sorted",
            2 * V if mode == "width" else None)


@pytest.mark.parametrize("B,V,N", [
    (1, 1, 1), (1, 40, 23), (3, 300, 77), (8, 3_072, 2_048),
    (1, 6_000, 300), (1, 10_240, 5_120), (1, 14_000, 64),
    (1, 100, 17_000)])
@pytest.mark.parametrize("mode", ["scatter", "sorted", "width"])
@pytest.mark.parametrize("seeded", [False, True])
def test_k23_deal_lists_equals_plain(cuda, B, V, N, mode, seeded):
    """K23's hand-off (the node sort, both prefixes in _scan_plain's
    order, the search and the lists) against its plain version bit for
    bit, at every scan path (rows up to 4 096, 8 192, 16 384 and past
    it: the compacted rows' demand spans 2V), node counts from 1 to past
    16 384, no tenant axis and B = 1, 3, 8."""
    a = _handoff_inputs(cuda, B, V, N, 3, min(4, N), mode, seeded, V + N)
    got = ka.deal_lists(*a)
    _equal(got, ka.deal_lists_plain(*a))
    solo = tuple(None if x is None else
                 tuple(y[0] for y in x) if isinstance(x, tuple)
                 else x[0] if isinstance(x, torch.Tensor) else x for x in a)
    _equal(ka.deal_lists(*solo), [g[0] for g in got])


@pytest.mark.parametrize("B", [1, 3])
def test_k23_k24_equal_plain(cuda, B):
    """K23 (with and without the rank gather) and K24 against their
    plain versions at one and three tenants, and in the solo shapes: the
    dealing on demand and capacity with ties, zero rows, -0.0 and +inf."""
    rng = np.random.default_rng(B)
    L, N, R = 300, 77, 3
    dem = rng.integers(0, 5, (B, L, R)).astype(np.float32) * 0.37
    dem[:, 5] = -0.0
    rem = rng.integers(0, 9, (B, N, R)).astype(np.float32) * 0.37
    rem[:, 3:9] = 0.0
    rem[:, -1, 1] = np.inf
    gather = np.stack([rng.permutation(L) for _ in range(B)])
    dem, rem, gather = (torch.from_numpy(a).to(cuda)
                        for a in (dem, rem, gather))
    for g in (None, gather):
        _equal([ka.deal(dem, rem, g)], [ka.deal_plain(dem, rem, g)])
    _equal([ka.deal(dem[0], rem[0], gather[0])],
           [ka.deal_plain(dem[0], rem[0], gather[0])])
    P = 300
    pend = torch.from_numpy(rng.random((B, P)) < 0.3).to(cuda)
    order = torch.from_numpy(np.stack([rng.permutation(P)
                                       for _ in range(B)])).to(cuda)
    for C in (1, 64, P):
        _equal(ka.top_by_rank(pend, order, C),
               ka.top_by_rank_plain(pend, order, C))
    _equal(ka.top_by_rank(pend[0], order[0], 64),
           ka.top_by_rank_plain(pend[0], order[0], 64))


def test_k1_to_k8_tenant_axis_equal_plain(cuda):
    """K1-K8 over three tenants in one launch each against their plain
    versions, which go tenant by tenant."""
    _, snap = _tenant_batch(cuda)
    cfg = EngineConfig(mode="fast")
    args = (snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
            snap.nodes.label_nums)
    _equal([ka.atom_sat(*args)], [ka.atom_sat_plain(*args)])
    sat = _sat_tables(snap)[0]
    cells = ka._tableau_cells(snap, snap.pods, snap.nodes, sat)
    _equal(cells, ka._tableau_cells_plain(snap, snap.pods, snap.nodes, sat))
    static = _static(cfg, snap)
    w = (cells[2], cells[3], snap.nodes.valid, static.w_lr, static.w_ba)
    _equal([ka.finalize_score(*w)], [ka.finalize_score_plain(*w)])
    for tie_break in ("first", "seeded"):
        c4 = EngineConfig(tie_break=tie_break, tie_seed=5)
        order = ka.pop_order(c4, snap)
        _equal(ka.parity_scan(c4, snap, static, order),
               ka.parity_scan_plain(c4, snap, static, order))
    used = snap.nodes.used + 0.3 * snap.nodes.allocatable
    c_args = (snap.nodes.allocatable, used, snap.pods.requests, static.mask,
              static.score, static.w_lr, static.w_ba, static.w_ts, static.rw)
    _equal(ka.cycle(*c_args), ka.cycle_plain(*c_args))
    B, P = snap.pods.valid.shape
    rows = torch.stack([torch.randperm(P, device=cuda)[:16]
                        for _ in range(B)]).to(torch.int32)
    pend = torch.rand((B, 16), device=cuda) < 0.7
    _equal(ka.cycle(*c_args, rows=rows, pending=pend, masked=True),
           ka.cycle_plain(*c_args, rows=rows, pending=pend, masked=True))
    f, m = ka.cycle_plain(*c_args, pending=snap.pods.valid, masked=True)
    ids = torch.arange(P, dtype=torch.int32, device=cuda).expand(B, P)
    _equal(ka.row_topk(m, 8, True, 5, ids),
           ka.row_topk_plain(m, 8, True, 5, ids))
    allowed = f.any(dim=-1)
    for fixed in (False, True):
        _equal([ka.desirability(f, m, allowed, fixed)],
               [ka.desirability_plain(f, m, allowed, fixed)])
    calls = []

    def record(*a):
        calls.append(a)
        return ka.prefix_commit_loop(*a)

    solve_many(cfg, snap, ops=dataclasses.replace(ka.KERNELS,
                                                  prefix_commit_loop=record))
    assert calls and calls[0][0].shape[0] == B
    for a in calls[:3]:
        _equal(ka.prefix_commit_loop(*a), ka.prefix_commit_loop_plain(*a))


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_solve_many_on_the_card(cuda, mode, tie_break):
    """The batch on the card equals its plain-version twin (host reads
    included) and, tenant by tenant, the solo solve on the card; with a
    tranche cap of 16 the batched rounds equal their plain twin too."""
    snaps, stacked = _tenant_batch(cuda)
    cfg = EngineConfig(mode=mode, tie_break=tie_break, tie_seed=7)
    s1, s2 = ka.RoundStats(), ka.RoundStats()
    got = solve_many(cfg, stacked, stats=s1)
    _equal(got, solve_many(cfg, stacked, ops=ka.PLAIN, stats=s2))
    assert s1.host_reads == s2.host_reads
    eng = Engine(cfg)
    for b, snap in enumerate(snaps):
        res = eng.solve(snap)
        a, c, u, o, rounds, ev = (t[b].cpu().numpy() for t in got)
        np.testing.assert_array_equal(a, res.assignment)
        np.testing.assert_array_equal(c, res.chosen_score)
        np.testing.assert_array_equal(u, res.final_used)
        np.testing.assert_array_equal(o, res.order)
        np.testing.assert_array_equal(ev, res.evicted)
        assert int(rounds) == res.rounds
    eng.close()
    if mode == "parity":
        return
    static = _static(cfg, stacked)
    order = ka.pop_order(cfg, stacked)
    rank = ka._rank_of(order)
    B, P, N = static.mask.shape
    runs = [ka._solve_rounds_nosig(cfg, stacked, static, rank, order,
                                   2 * P + 8, ka._fallback_depth(N), cap=16,
                                   ops=ops) for ops in (ka.KERNELS, ka.PLAIN)]
    _equal(runs[0], runs[1])


# -- the tenant axis with signatures and gangs (configs 3-4) ----------------


def _floored(draw, B):
    """B tenants drawn under the elementwise max of their own buckets
    (signatures included): their snapshots and the stack on the card."""
    floor = {}
    for b in range(B):
        for f, v in dataclasses.asdict(draw(b)[1].buckets).items():
            floor[f] = max(floor.get(f, 0), v)
    snaps = [draw(b, buckets=Buckets(**floor))[0] for b in range(B)]
    return snaps, stack_snapshots(snaps)


def _pair_tenants(cuda, B=3):
    """B config-3 tenants of different sizes, with running anti-affinity
    holders, namespace scopes and key-less nodes."""
    snaps, stacked = _floored(lambda b, **x: tsynth.make_cluster(
        np.random.default_rng(50 + b), 100 + 10 * b, 20 + 2 * b,
        **PAIR_MIXES["anti_ns_keyless"], **x), B)
    return snaps, stacked.to(cuda)


def _gang_tenants(cuda, pair: bool, B=3):
    """B config-4 tenants, the later ones tight enough to roll back."""
    kw = PAIR_MIXES["config3"] if pair else {}
    snaps, stacked = _floored(lambda b, **x: tsynth.config4_gangs(
        np.random.default_rng(60 + b), n_groups=12 + 2 * b, gang_size=4,
        n_nodes=24 - 8 * b, **kw, **x), B)
    return snaps, stacked.to(cuda)


@pytest.mark.parametrize("B", [1, 3])
def test_pairwise_tenant_axis_equal_plain(cuda, B):
    """K4's pairwise variant, K9-K14, K10's pair_commit and K8's node_add
    over B tenants in one launch each, against their plain versions
    (tenant by tenant), on a fast round's inputs: the pair state with
    part of each tenant's pods committed at random nodes."""
    _, snap = _pair_tenants(cuda, B)
    cfg = EngineConfig(mode="fast")
    member_sat_t = _sat_tables(snap)[1]
    ns = kp.member_ns(snap)
    assert member_sat_t.shape[0] == B
    _equal([kp.sig_match(member_sat_t, snap.sigs, ns)],
           [kp.sig_match_plain(member_sat_t, snap.sigs, ns)])
    static, dom, st = _pair_setup(cfg, snap)
    args = (static.sig_match, dom, snap.running, snap.pods)
    _equal(_state(st), _state(kp.pair_counts_plain(*args)))
    _, P = snap.pods.valid.shape
    N = snap.nodes.valid.shape[1]
    rng = np.random.default_rng(B)
    choice = torch.from_numpy(rng.integers(0, N, size=(B, P)).astype(
        np.int32)).to(cuda)
    kept = (torch.from_numpy(rng.random((B, P)) < 0.6).to(cuda)
            & snap.pods.valid)
    _equal(_state(kp.pair_counts(*args, assigned=choice)),
           _state(kp.pair_counts_plain(*args, assigned=choice)))
    for tie_break in ("first", "seeded"):
        c4 = EngineConfig(tie_break=tie_break, tie_seed=5)
        order = ka.pop_order(c4, snap)
        got = ka.parity_scan_pair(c4, snap, static, order, st, dom)
        want = ka.parity_scan_pair_plain(c4, snap, static, order, st, dom)
        _equal(got[:3], want[:3])
        _equal(_state(got[3]), _state(want[3]))
    st = kp.pair_commit_plain(snap, st, static.sig_match, dom, choice, kept)
    for with_ia_ok in (False, True):
        b = (snap, st, static.aff_ok, static.sig_match, dom, with_ia_ok)
        _equal(kp.pairwise_batch(*b), kp.pairwise_batch_plain(*b))
    rank = ka._rank_of(ka.pop_order(cfg, snap))
    feasible, score, relaxed = ka.batched_cycle(
        cfg, snap, static, snap.nodes.used, ops=ka.PLAIN, pair_st=st,
        pending=snap.pods.valid, return_relaxed=True)
    K = ka._fallback_depth(N)
    wf = (snap, st, snap.nodes.used, relaxed, score, relaxed.any(dim=-1),
          rank, K, dom)
    deal = ka._spread_waterfill_deal(*wf, ka.KERNELS)
    _equal(deal, ka._spread_waterfill_deal(*wf, ka.PLAIN))
    assert deal[2].any()
    for sign in (1.0, -1.0):
        a = (static.sig_match, dom, choice, kept, sign)
        _equal(_state(kp.pair_commit(snap, kp.copy_state(st), *a)),
               _state(kp.pair_commit_plain(snap, kp.copy_state(st), *a)))
        n = (snap.nodes.used, choice, kept, snap.pods.requests, rank, sign)
        _equal([ka.node_add(*n)], [ka.node_add_plain(*n)])
    esn = torch.where(kept, choice, -1)
    ia = (snap, st, static.sig_match, dom, choice, esn)
    _equal([kp.ia_ok_at_choice(*ia)], [kp.ia_ok_at_choice_plain(*ia)])
    ex = (snap, static.aff_ok, rank, choice, kept, st, dom)
    bad = ka._spread_excess_mask(*ex, ka.KERNELS)
    _equal([bad], [ka._spread_excess_mask(*ex, ka.PLAIN)])
    # Each tenant's slice of the batch is the kernels' solo call on it.
    for t in range(B):
        one = snap.tenant(t)
        _equal([bad[t]], [ka._spread_excess_mask(
            one, static.aff_ok[t], rank[t], choice[t], kept[t],
            st.tenant(t), dom[t], ka.KERNELS)])


@pytest.mark.parametrize("kind", ["pairwise", "gangs", "pairwise_gangs"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_solve_many_signatures_gangs_on_the_card(cuda, mode, kind):
    """The batch with signatures and gangs on the card equals its
    plain-version twin (host reads included) and, tenant by tenant, the
    solo solve on the card; fast mode once more at compact_cap 16, where
    tenants hand off to compacted rounds."""
    if kind == "pairwise":
        snaps, stacked = _pair_tenants(cuda)
    else:
        snaps, stacked = _gang_tenants(cuda, kind == "pairwise_gangs")
    caps = (-1, 16) if mode == "fast" else (-1,)
    for cap in caps:
        cfg = EngineConfig(mode=mode, compact_cap=cap)
        s1, s2 = ka.RoundStats(), ka.RoundStats()
        got = solve_many(cfg, stacked, stats=s1)
        _equal(got, solve_many(cfg, stacked, ops=ka.PLAIN, stats=s2))
        assert s1.host_reads == s2.host_reads
        eng = Engine(cfg)
        for b, snap in enumerate(snaps):
            res = eng.solve(snap)
            a, c, u, o, rounds, ev = (t[b].cpu().numpy() for t in got)
            np.testing.assert_array_equal(a, res.assignment)
            np.testing.assert_array_equal(c, res.chosen_score)
            np.testing.assert_array_equal(u, res.final_used)
            np.testing.assert_array_equal(o, res.order)
            np.testing.assert_array_equal(ev, res.evicted)
            assert int(rounds) == res.rounds
        eng.close()


# -- the tenant axis with preemption (config 5) -------------------------------


def _pre_tenants(cuda, pair: bool, B=3, **kw):
    """B config-5 tenants of different sizes (with spread and inter-pod
    terms when pair; `kw` to the generator) under one floor."""
    if pair:
        kw.update(spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2)
    snaps, stacked = _floored(lambda b, **x: tsynth.config5_preemption(
        np.random.default_rng(45 + b), 96 - 8 * b, 16 - 2 * b, **kw, **x), B)
    return snaps, stacked.to(cuda)


def _first_auction(cfg, snap):
    """The arguments of the first call of K17's two entry points, K16 and
    K18 in a fast solve (K6 ranks the rows K17 wrote)."""
    calls = {}

    def rec(name):
        fn = getattr(ka.KERNELS, name)

        def wrapped(*a):
            calls.setdefault(name, tuple(x.clone() if isinstance(
                x, torch.Tensor) else x for x in a))
            return fn(*a)
        return wrapped

    names = ("auction_ok", "auction_tables", "auction_rank", "auction_claim")
    ops = dataclasses.replace(ka.KERNELS, **{n: rec(n) for n in names})
    solve_core(cfg, snap, ops=ops)
    return calls


def _tenant_of(x, t):
    if isinstance(x, torch.Tensor):
        return x[t]
    return x.tenant(t) if hasattr(x, "tenant") else x


@pytest.mark.parametrize("B", [1, 3])
def test_preempt_tenant_axis_equal_plain(cuda, B):
    """K4's two preemption variants (K15 inside), K16, K17's two entry
    points and K18 over B tenants in one launch each, against their plain
    versions (tenant by tenant), on the arguments the batch gives them;
    each tenant's slice equals the solo kernel call on that tenant."""
    for pair in (False, True):
        snaps, snap = _pre_tenants(cuda, pair, B)
        cfg = EngineConfig(preemption=True)
        ctx = kpre.precompute(cfg, snap)
        order = ka.pop_order(cfg, snap)
        if pair:
            static, dom, st = _pair_setup(cfg, snap)
            args = (cfg, snap, static, order, st, dom, ctx)
            fn, plain = ka.parity_scan_pair_preempt, \
                ka.parity_scan_pair_preempt_plain
            flat = lambda r: [*r[:3], *_state(r[3]), r[4]]  # noqa: E731
        else:
            static = _static(cfg, snap)
            args = (cfg, snap, static, order, ctx)
            fn, plain = ka.parity_scan_preempt, ka.parity_scan_preempt_plain
            flat = list
        got = flat(fn(*args))
        _equal(got, flat(plain(*args)))
        assert got[-1].any(dim=-1).all()
        for t in range(B):
            one = flat(fn(*(_tenant_of(a, t) for a in args)))
            _equal([g[t] for g in got], one)
        fcfg = EngineConfig(mode="fast", preemption=True)
        calls = _first_auction(fcfg, snap)
        plains = {"auction_ok": kpre.auction_ok_plain,
                  "auction_tables": kpre.auction_tables_plain,
                  "auction_rank": kpre.auction_rank_plain,
                  "auction_claim": kpre.auction_claim_plain}
        for name, a in calls.items():
            fn = getattr(kpre, name)
            got = fn(*a)
            _equal(got, plains[name](*a))
            for t in range(B):
                _equal([g[t] for g in got],
                       fn(*(_tenant_of(x, t) for x in a)))
        assert calls["auction_claim"][0].shape[0] == B


@pytest.mark.parametrize("kind", ["plain", "pairwise", "gangs_seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_solve_many_preemption_on_the_card(cuda, mode, kind):
    """The batch with preemption (S = 0; with signatures; with gangs of 3
    under the seeded tie-break) on the card equals its plain-version
    twin, host reads included, and each tenant its solo solve on the
    card; every tenant evicts."""
    gangs = kind == "gangs_seeded"
    snaps, stacked = _pre_tenants(
        cuda, kind == "pairwise",
        **(dict(gang_frac=0.5, gang_size=3) if gangs else {}))
    cfg = EngineConfig(mode=mode, preemption=True,
                       tie_break="seeded" if gangs else "first", tie_seed=5)
    s1, s2 = ka.RoundStats(), ka.RoundStats()
    got = solve_many(cfg, stacked, stats=s1)
    _equal(got, solve_many(cfg, stacked, ops=ka.PLAIN, stats=s2))
    assert s1.host_reads == s2.host_reads
    assert got[5].any(dim=-1).all()
    eng = Engine(cfg)
    for b, snap in enumerate(snaps):
        res = eng.solve(snap)
        a, c, u, o, rounds, ev = (t[b].cpu().numpy() for t in got)
        np.testing.assert_array_equal(a, res.assignment)
        np.testing.assert_array_equal(c, res.chosen_score)
        np.testing.assert_array_equal(u, res.final_used)
        np.testing.assert_array_equal(o, res.order)
        np.testing.assert_array_equal(ev, res.evicted)
        assert int(rounds) == res.rounds
    eng.close()


# -- K25: the ring hop -----------------------------------------------------------


def _hop_args(cuda, case, seed=0):
    """Random arguments of one hop (counts holding earlier adds): a
    signature block against a member block, with padding ids, invalid
    rows, key-less nodes and unsatisfied atoms; `case` picks the edge."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    A, mblk, sblk, AT, NS, N, TK = {
        "base": (6, 1000, 7, 3, 2, 50, 3), "invalid": (6, 1000, 7, 3, 2, 50, 3),
        "hot": (6, 4000, 5, 2, 1, 50, 2), "a0": (0, 700, 5, 2, 2, 40, 2),
        "a0_at0": (0, 700, 5, 0, 0, 40, 2), "n1": (4, 500, 3, 2, 1, 1, 1),
        "wide": (8, 51200, 5, 3, 2, 5120, 4)}[case]

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(cuda)

    def bools(p, *shape):
        return (torch.rand(*shape, generator=g) < p).to(cuda)

    counts = torch.randint(0, 5, (sblk, N), generator=g).to(
        torch.float32).to(cuda)
    msat = bools(0.6, A, mblk)
    mnode, mvalid, mns = ints(-1, N, mblk), bools(0.9, mblk), ints(-1, 3, mblk)
    skey = ints(-1, TK, sblk)
    satoms = ints(-1, A, sblk, AT) if A else torch.full(
        (sblk, AT), -1, dtype=torch.int32, device=cuda)
    sns, snsall, svalid = ints(-1, 3, sblk, NS), bools(0.5, sblk), bools(
        0.9, sblk)
    ndom = ints(-1, N, N, TK)
    if case == "invalid":
        mvalid = torch.zeros_like(mvalid)
    if case == "n1":  # the one node has the key: its domain is 0
        ndom, skey = torch.zeros_like(ndom), skey.clamp(min=0)
    if case == "hot":
        ndom = torch.zeros_like(ndom)
        mnode, mvalid = mnode.clamp(min=0), torch.ones_like(mvalid)
        snsall, svalid = torch.ones_like(snsall), torch.ones_like(svalid)
        skey = skey.clamp(min=0)
    return (counts, msat, mnode, mvalid, mns, skey, satoms, sns, snsall,
            svalid, ndom)


@pytest.mark.parametrize("case", ["base", "invalid", "hot", "a0", "a0_at0",
                                  "n1", "wide"])
def test_k25_hop_equal_plain(cuda, case):
    """K25 adds into its counts exactly what its plain version adds, on
    random blocks and at the edges: an all-invalid member block (nothing
    added), one hot domain (every match on one count cell), no atoms
    (with and without term atom slots), one node, and a wide (h)-sized
    member block."""
    args = _hop_args(cuda, case)
    before = args[0].clone()
    want = kp.ring_hop_plain(args[0].clone(), *args[1:])
    n = kp.ring_hop.launches
    got = kp.ring_hop(*args)
    assert got is args[0] and kp.ring_hop.launches == n + 1
    _equal([got], [want])
    added = float((got - before).sum())
    if case == "invalid":
        assert added == 0
    else:
        assert added > 0
    if case == "hot":
        assert float((got - before)[:, 0].sum()) == added


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k25_rotated_ring_equal_dense(cuda, mix, ndev):
    """The blocks of an ndev-rank ring rotated through K25 on one card
    (S not a multiple of ndev at 3 and 8: the padded signatures add
    nothing) equal the plain hop's rotation and K10's dense counts."""
    snap = _snap(cuda, seed=5, **PAIR_MIXES[mix])
    from tpusched_torch.ring import ring_sig_counts_rotated

    _, msat = _sat_tables(snap)
    P = snap.pods.valid.shape[0]
    a = torch.full((P,), -1, dtype=torch.int32, device=cuda)
    got = ring_sig_counts_rotated(snap, msat, a, ndev)
    plain = ring_sig_counts_rotated(snap, msat, a, ndev,
                                    hop=kp.ring_hop_plain)
    dense = kp.pair_counts(kp.sig_match(msat, snap.sigs, kp.member_ns(snap)),
                           kp.sig_domains(snap), snap.running,
                           snap.pods).counts
    _equal([got, plain], [dense, dense])
    assert dense.sum() > 0


@pytest.mark.parametrize("mix", sorted(PAIR_MIXES))
def test_k25_k10_takes_the_rings_counts(cuda, mix):
    """K10 given the ring's counts skips its count scatter: the state
    carries the given tensor, and its anti and match_tot equal the plain
    version's and K10's whole state's."""
    snap = _pair_snap(cuda, mix)
    static, dom, whole = _pair_setup(EngineConfig(), snap)
    args = (static.sig_match, dom, snap.running, snap.pods)
    marked = torch.full_like(whole.counts, 7.0)
    st = kp.pair_counts(*args, counts=marked)
    assert st.counts is marked
    assert torch.equal(marked, torch.full_like(marked, 7.0))
    plain = kp.pair_counts_plain(*args, counts=marked)
    _equal([st.anti, st.match_tot], [plain.anti, plain.match_tot])
    _equal([st.anti, st.match_tot], [whole.anti, whole.match_tot])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_k25_ring_engine_equal_dense(cuda, mode):
    """Engine(ring_counts=True) on a one-rank mesh (no process group: the
    default card) equals the dense engine on the card, bit for bit, and
    launches K25 once a solve."""
    from tpusched_torch.mesh import make_mesh

    snap = _snap(cuda, seed=7, **PAIR_MIXES["anti_ns_keyless"])
    mesh = make_mesh()
    ring = Engine(EngineConfig(mode=mode, ring_counts=True), mesh=mesh)
    dense = Engine(EngineConfig(mode=mode))
    n = kp.ring_hop.launches
    got, want = ring.solve(snap), dense.solve(snap)
    assert kp.ring_hop.launches == n + 1
    for f in ("assignment", "order", "commit_key", "chosen_score",
              "final_used", "rounds", "host_reads"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    ring.close()
    dense.close()


# -- K26: the exact auction tableau ----------------------------------------------


def _nv_args(cuda, C, N, V, R, M, GP, seed=0, nothing=False):
    """A random node-major victim table and auction state of C bidders
    (fractional requests, usage near capacity, budgets when GP > 0):
    (cfg, snap-like, ctx, prio, req, used, evicted)."""
    from types import SimpleNamespace

    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g).to(cuda)

    used = rand(N, R) * 10.0
    alloc = used + rand(N, R) * 4.0
    ctx = kpre.PreemptCtxNV(
        vreq=rand(N, V, R) * 3.7, vcost=rand(N, V) * 5.0 + 1.0,
        vprio=rand(N, V) * 100.0,
        vpdb=torch.randint(-1, max(GP, 0), (N, V), generator=g,
                           dtype=torch.int32).to(cuda),
        vvalid=rand(N, V) < 0.85,
        vidx=torch.randint(0, M + 1, (N, V), generator=g,
                           dtype=torch.int32).to(cuda))
    snap = SimpleNamespace(
        nodes=SimpleNamespace(allocatable=alloc),
        running=SimpleNamespace(
            pdb_group=torch.randint(-1, max(GP, 0), (M,), generator=g,
                                    dtype=torch.int32).to(cuda),
            valid=torch.ones(M, dtype=torch.bool, device=cuda)),
        pdb_allowed=torch.randint(0, 3, (GP,), generator=g).to(
            torch.float32).to(cuda))
    prio = (torch.full((C,), -1e9, device=cuda) if nothing
            else rand(C) * 120.0)
    req = rand(C, R) * 3.0
    ev = rand(M) < 0.2
    return EngineConfig(), snap, ctx, prio, req, used, ev


@pytest.mark.parametrize("case", ["v1", "gp0", "nothing", "r1", "r2", "r3",
                                  "r4", "r5", "r6", "r7", "r8", "v32"])
def test_k26_equal_plain(cuda, case):
    """K26's six outputs against the plain version, exactly: one victim a
    node, no budgets, no eligible victim (every minimum +inf), R = 1 to 8
    resources, V = 32."""
    V = {"v1": 1, "v32": 32}.get(case, 16)
    R = int(case[1]) if case.startswith("r") else 3
    GP = 0 if case == "gp0" else 4
    args = _nv_args(cuda, 37, 70, V, R, 300, GP,
                    nothing=case == "nothing")
    n = kpre._tableau_nv.launches
    got = kpre._tableau_nv(*args)
    assert kpre._tableau_nv.launches == n + 1
    want = kpre._tableau_nv_plain(*args)
    _equal(got, want)
    if case == "nothing":
        assert not got[0].any() and torch.isinf(got[4]).all()
    else:
        assert got[3].any() and torch.isfinite(got[4]).any()
    if GP and case != "nothing":
        assert (got[2] > 0).any()


@pytest.mark.parametrize("B", [1, 8])
def test_k26_auction_state_equal_plain(cuda, B):
    """K26 on the fast auction's own state of config-5 snapshots (the
    node-major victim table, C = 1 024 bidders at 10 000 x 5 000 for
    B = 1; eight tenants of 600 x 300 in one launch for B = 8) against
    the plain version, exactly."""
    if B == 1:
        cfg, snap, ctx, ev, used, rows, prio, req = _auction_args(
            cuda, 10000, 5000)[:8]
    else:
        snaps, snap = _floored(lambda b, **x: tsynth.config5_preemption(
            np.random.default_rng(45 + b), 600, 300, **x), B)
        snap = snap.to(cuda)
        cfg = EngineConfig(mode="fast", preemption=True)
        ctx = kpre.precompute_nv(cfg, snap, ka._PREEMPT_VICTIM_CAP)
        g = torch.Generator(device="cpu").manual_seed(B)
        M = snap.running.valid.shape[1]
        ev = (torch.rand(B, M, generator=g) < 0.1).to(cuda) \
            & snap.running.valid
        used = snap.nodes.used.clone()
        prio = (torch.rand(B, 256, generator=g) * 600).to(cuda)
        req = snap.pods.requests[:, :256].contiguous()
    args = (cfg, snap, ctx, prio, req, used, ev)
    got = kpre._tableau_nv(*args)
    _equal(got, kpre._tableau_nv_plain(*args))
    assert got[3].any()


# -- K12 and K13 as redesigned for Hopper (a warp a row) ----------------------


def k13_inputs(rng, P: int, N: int, S: int, C: int, B: int = 0,
               one_domain: bool = False, dense: bool = False) -> dict:
    """K13's inputs (numpy; [B, ...] where B > 0): signature domains with
    key-less nodes (-1), or one domain holding every node; counts; a tenth
    of the nodes invalid; aff_ok with every seventh row all False (min 0);
    C spread slots (padded, ScheduleAnyway and DoNotSchedule); choices
    (over three nodes when dense, so that groups run past 32 rows and
    across warps); kept rows and a rank permutation."""
    lead = (B,) if B else ()
    D = 1 if one_domain else max(1, N // 4)
    dom = rng.integers(0, D, (*lead, S, N)).astype(np.int32)
    if not one_domain:
        dom[rng.random(dom.shape) < 0.1] = -1
    aff_ok = rng.random((*lead, P, N)) < 0.8
    aff_ok[..., ::7, :] = False
    rank = np.stack([rng.permutation(P) for _ in range(max(B, 1))])
    return dict(
        dom=dom,
        counts=rng.integers(0, 40, (*lead, S, N)).astype(np.float32),
        node_valid=rng.random((*lead, N)) < 0.9,
        aff_ok=aff_ok,
        ts_sig=rng.integers(-1, S, (*lead, P, C)).astype(np.int32),
        ts_valid=rng.random((*lead, P, C)) < 0.85,
        ts_when=rng.integers(0, 2, (*lead, P, C)).astype(np.int8),
        ts_skew=rng.integers(1, 4, (*lead, P, C)).astype(np.float32),
        choice=rng.integers(-1, min(N, 3) if dense else N,
                            (*lead, P)).astype(np.int32),
        kept=rng.random((*lead, P)) < 0.8,
        rank=(rank if B else rank[0]).astype(np.int32))


def k13_pipeline(x: dict, keys=ka.excess_keys, pass_=ka.excess_min,
                 walk=ka.excess_walk):
    """_spread_excess_mask's steps on k13_inputs' tensors: (key table,
    the pass's four outputs, the sorted keys and rows, bad)."""
    key = keys(x["dom"], x["counts"], x["node_valid"])
    out = pass_(key, x["aff_ok"], x["ts_sig"], x["ts_valid"], x["ts_when"],
                x["ts_skew"], x["choice"], x["kept"], x["rank"], x["dom"],
                x["counts"])
    key_s, perm = torch.sort(out[2], dim=-1)
    return key, out, (key_s, perm), walk(key_s, perm, out[0], out[1],
                                         out[3])


def k12_inputs(rng, P: int, N: int, S: int, B: int = 0,
               one_domain: bool = False) -> dict:
    """K12's inputs (numpy): signature domains as k13_inputs', the first
    signature with no keyed node (every level a sentinel) where S > 1;
    each pod's signature, member rows and their 0-based positions q in a
    random rank order (-1 for the rest, some past the last level);
    relaxed rows with every fifth all False (n_feas = 0); a cap order;
    scores."""
    lead = (B,) if B else ()
    D = 1 if one_domain else max(1, N // 4)
    dom = rng.integers(0, D, (*lead, S, N)).astype(np.int32)
    if not one_domain:
        dom[rng.random(dom.shape) < 0.1] = -1
        if S > 1:
            dom[..., 0, :] = -1
    s_p = rng.integers(0, S, (*lead, P)).astype(np.int32)
    member = rng.random((*lead, P)) < 0.7
    q = np.full((*lead, P), -1.0, dtype=np.float32)
    for b in np.ndindex(*lead):
        seen = np.zeros(S, dtype=np.float32)
        for p in rng.permutation(P):
            if member[b + (p,)]:
                q[b + (p,)] = seen[s_p[b + (p,)]]
                seen[s_p[b + (p,)]] += 1
    relaxed = rng.random((*lead, P, N)) < 0.6
    relaxed[..., ::5, :] = False
    cap = np.stack([rng.permutation(N) for _ in range(max(B, 1))])
    return dict(
        dom=dom, counts=rng.integers(0, 6, (*lead, S, N)).astype(np.float32),
        s_p=s_p, q=q, member=member, relaxed=relaxed,
        cap_order=(cap if B else cap[0]).astype(np.int32),
        score=rng.normal(0.0, 10.0, (*lead, P, N)).astype(np.float32))


def fill_levels(counts, dom):
    """K12's fill levels and domain order from domain counts and the
    signatures' domains, by the plain versions."""
    return ka.waterfill_fill_plain(*torch.sort(
        ka.waterfill_cnt_plain(dom, counts), dim=-1, stable=True))


def k12_args(x: dict, K1: int) -> tuple:
    """waterfill's arguments from k12_inputs' tensors."""
    fill, ord_dom = fill_levels(x["counts"], x["dom"])
    return (fill, ord_dom, x["dom"], x["s_p"], x["q"], x["relaxed"],
            x["cap_order"], x["score"], x["member"], K1)


def _on(x: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


# (B, P, N, S, C, one domain, dense choices): N of 1, 31, 33 and 5 121 (the
# byte path) and 2 048 / 5 120 (16-byte rows); P of 1, 1 024 and past a
# CTA's rows (8 a CTA in the pass, 256 sorted rows in the walk); S of 1, 4
# and 32; C of 1-3; a domain holding every node; B = 8.
K13_CASES = [(0, 1, 1, 1, 1, False, False), (0, 1024, 31, 4, 1, False, True),
             (0, 1025, 33, 32, 2, False, False),
             (0, 37, 5121, 4, 1, False, True),
             (0, 1024, 5120, 4, 2, False, True),
             (0, 300, 64, 1, 1, True, True), (8, 257, 2048, 4, 1, False, True),
             (8, 64, 33, 32, 3, False, False)]


@pytest.mark.parametrize("case", K13_CASES)
def test_k13_warp_kernels_equal_plain(cuda, case):
    """K13's key table, its pass over every slot, its walk (and the walk's
    one-slot form on slot 0) against their plain versions, bit for bit."""
    B, P, N, S, C, one, dense = case
    x = _on(k13_inputs(np.random.default_rng(P + N + S), P, N, S, C, B, one,
                       dense), cuda)
    got = k13_pipeline(x)
    want = k13_pipeline(x, ka.excess_keys_plain, ka.excess_min_plain,
                        ka.excess_walk_plain)
    _equal([got[0], *got[1], *got[2], got[3]],
           [want[0], *want[1], *want[2], want[3]])
    if dense and P > 256 and not one:
        assert got[3].any()
    walk = (*got[2], got[1][0], got[1][1], got[1][3])
    one_slot = ka.excess_survive_args(*walk, 0)
    _equal([ka.excess_survive(*one_slot)],
           [ka.excess_survive_plain(*one_slot)])
    if C == 1:
        _equal([ka.excess_survive(*one_slot)], [got[3]])


# (B, P, N, S, K1, one domain)
K12_CASES = [(0, 1, 1, 1, 1, False), (0, 1024, 31, 4, 9, False),
             (0, 1025, 33, 32, 32, False), (0, 40, 5121, 4, 9, False),
             (0, 300, 64, 1, 9, True), (8, 257, 2048, 4, 9, False),
             (8, 64, 33, 32, 5, True)]


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_tables_equal_plain(cuda, case):
    """K12's four table kernels (members, rank positions, domain counts,
    fill levels) against their plain versions, bit for bit, on C = 3
    spread slots a pod and k12_inputs' domains."""
    B, P, N, S, K1, one = case
    rng = np.random.default_rng(P + N + S + 1)
    x = _on(k12_inputs(rng, P, N, S, B, one), cuda)
    sl = _on(k13_inputs(rng, P, N, S, 3, B), cuda)
    allowed = x["member"]
    rank = sl["rank"]
    m = (sl["ts_sig"], sl["ts_valid"], sl["ts_when"], allowed, rank, S)
    got = ka.waterfill_members(*m)
    _equal(got, ka.waterfill_members_plain(*m))
    key_s, perm = torch.sort(got[2], dim=-1)
    _equal([ka.waterfill_q(key_s, perm, S)],
           [ka.waterfill_q_plain(key_s, perm, S)])
    dsort, _ = ka.waterfill_lists(x["dom"], x["cap_order"])
    cnt = ka.waterfill_cnt(dsort, x["counts"])
    _equal([cnt], [ka.waterfill_cnt_plain(dsort, x["counts"])])
    srt = torch.sort(cnt, dim=-1, stable=True)
    _equal(ka.waterfill_fill(*srt), ka.waterfill_fill_plain(*srt))


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_warp_kernel_equal_plain(cuda, case):
    """K12 (its node lists, the fill-level search, the two walks of the
    chosen domain) against its plain version, bit for bit."""
    B, P, N, S, K1, one = case
    x = _on(k12_inputs(np.random.default_rng(P + N + S), P, N, S, B, one),
            cuda)
    args = k12_args(x, K1)
    got = ka.waterfill(*args)
    _equal(got, ka.waterfill_plain(*args))
    assert got[2].any() or P == 1


@pytest.mark.parametrize("N,C,Q,K", [(1, 1, 1, 1), (5_120, 1_024, 16, 32),
                                     (20_000, 1_024, 1, 32),
                                     (20_000, 1_024, 4, 256),
                                     (33, 7, 2, 9)])
def test_card_limits_equal_compiled(cuda, N, C, Q, K):
    """limits.py's copies of the kernels' limits (MAX_R, MAX_C, K18's
    shared-memory cap and its bytes a CTA) equal the compiled ones."""
    import ctypes

    from tpusched_torch import _build, limits

    claim = (ctypes.c_longlong * 3)()
    shape = (ctypes.c_int * 2)()
    _build.launch("tpusched_claim_limits", N, C, Q, K, claim)
    _build.launch("tpusched_shape_limits", shape)
    assert list(claim) == [limits.MAX_R, limits.CLAIM_SMEM,
                           limits.claim_smem_bytes(N, C, Q, K)]
    assert list(shape) == [limits.MAX_R, limits.MAX_C]
    assert limits.MAX_C == kp.MAX_C
