"""K6's routing and K2's plain version at the edge shapes of their Hopper
kernels, on the CPU.

K6 has two kernels (the warp kernel, K <= 32, and the radix select);
which of them `row_topk` launches is a pure function of (K, seeded),
`kernels.assign.topk_route`, held here for every K a caller passes and
at the cuts. K2's kernel tiles 4 nodes a thread by 8 pods: its plain
version, which the card tests hold the kernel to bit for bit, is held
here against JAX's `_tableau_cells` at node and pod counts that are no
multiple of the tile, with no terms or taint slots, on refresh_tableau's
gathered views and over a tenant batch. Exact: the tables are bools and
sums of weights in term order."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import K2Tree, k2_inputs
from tpusched.kernels import assign as jassign
from tpusched_torch.kernels import assign as ka

# Every K a caller passes (1: score_top1 and the plain evaluation; 4:
# the explained solve's kb; 8 and 16: the fast rounds; 256: the auction)
# and the cuts around the warp kernel's cap and the radix select's
# shared memory.
ROUTE_KS = (1, 2, 3, 4, 8, 16, 17, 31, 32, 33, 64, 256, 16384, 16385)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("K", ROUTE_KS)
def test_topk_route(K, seeded):
    """Each (K, seeded) goes to named kernels that take it: the warp
    kernel up to its cap (every seeded pick at K <= 32, and the unseeded
    calls below RADIX_MIN_K), the radix select above (any K), and a
    seeded K above the cap to both (the radix select's top-K, the warp
    kernel's pick at K = 1); the plain version answers every one."""
    route = ka.topk_route(K, seeded)
    assert route == ka.topk_route(K, seeded)
    if K <= ka.WARP_MAX_K and (seeded or K < ka.RADIX_MIN_K):
        assert route == ("row_topk",)
    elif seeded:
        assert route == ("row_topk_radix", "row_topk")
    else:
        assert route == ("row_topk_radix",)
    N = max(K, 40)
    m = torch.from_numpy(np.random.default_rng(K).integers(
        0, 3, (3, N)).astype(np.float32))
    ids = torch.arange(3, dtype=torch.int32)
    topv, topi, pick = ka.row_topk(m, K, seeded, 7, ids)
    assert topv.shape == topi.shape == (3, K)
    assert (pick is not None) == seeded


@pytest.mark.parametrize("rows,split", [(1, 8), (255, 8), (256, 8),
                                        (512, 4), (1024, 2), (2048, 1),
                                        (10240, 1)])
def test_topk_split(rows, split):
    """The warp kernel's warps a row: some 2 048 warps a call, at most 8
    a row (one CTA)."""
    assert ka.topk_split(rows) == split


def _jax(ns):
    if isinstance(ns, np.ndarray):
        return jnp.asarray(ns)
    return K2Tree(**{k: _jax(v) for k, v in vars(ns).items()})


def _torch(ns):
    if isinstance(ns, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(ns))
    return K2Tree(**{k: _torch(v) for k, v in vars(ns).items()})


def _rows(ns, idx):
    """The namespace's leaves with their rows gathered (permute_rows)."""
    return K2Tree(**{k: v[idx] for k, v in vars(ns).items()})


def _held(snap, pods, nodes, sat):
    """The port's plain K2 against JAX's _tableau_cells, exactly."""
    got = ka._tableau_cells(*(_torch(x) for x in (snap, pods, nodes, sat)))
    want = jassign._tableau_cells(*(_jax(x) for x in (snap, pods, nodes,
                                                        sat)))
    for field, g, w in zip(("mask", "aff_ok", "na_raw", "tt_count"), got,
                           want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


@pytest.mark.parametrize("P", [1, 37])
@pytest.mark.parametrize("N", [1, 3, 5, 255, 257])
def test_tableau_cells_plain_edge_shapes_equal_jax(N, P):
    """Node counts that are no multiple of the kernel's quads and tiles,
    one pod and a pod block past the tile's 8."""
    _held(*k2_inputs(np.random.default_rng(N + P), N, P))


@pytest.mark.parametrize("case", ["T0", "PT0", "TN0", "all0", "wide_taints",
                                  "wide_vocab"])
def test_tableau_cells_plain_empty_tables_equal_jax(case):
    """No required terms, no preferred terms, no taint slots, none of the
    three; more taint slots and ids than the kernel stages."""
    kw = dict(T0=dict(T=0), PT0=dict(PT=0), TN0=dict(TN=0),
              all0=dict(T=0, PT=0, TN=0), wide_taints=dict(TN=40),
              wide_vocab=dict(VT=3000))[case]
    _held(*k2_inputs(np.random.default_rng(len(case)), 130, 41, **kw))


@pytest.mark.parametrize("view", ["pods", "nodes3", "nodes8"])
def test_tableau_cells_plain_gathered_views_equal_jax(view):
    """refresh_tableau's gathered views: dirty pod rows that do not start
    at 0 (one repeated) against every node, every pod against 3 and 8
    dirty node columns."""
    snap, pods, nodes, sat = k2_inputs(np.random.default_rng(9), 300, 90)
    if view == "pods":
        pods = _rows(pods, np.array([5, 17, 17, 40, 89]))
    else:
        cols = (np.array([3, 9, 130]) if view == "nodes3"
                else np.array([1, 2, 3, 5, 8, 13, 21, 299]))
        nodes, sat = _rows(nodes, cols), np.ascontiguousarray(sat[:, cols])
    _held(snap, pods, nodes, sat)


def test_tableau_cells_plain_tenants_equal_jax():
    """A tenant batch [3, P, N]: each tenant's plain tables equal JAX's
    for that tenant alone."""
    snap, pods, nodes, sat = k2_inputs(np.random.default_rng(3), 130, 21,
                                       B=3)
    got = ka._tableau_cells(*(_torch(x) for x in (snap, pods, nodes, sat)))
    for b in range(3):
        want = jassign._tableau_cells(
            *(_jax(x) for x in (snap.tenant(b), pods.tenant(b),
                                nodes.tenant(b), sat[b])))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
