"""Each kernel's plain PyTorch version (what the kernel wrapper runs on a
CPU tensor) against the JAX function it ports, on the same numpy inputs.

Tolerances: the boolean tables and the cell-local f32 tables are exact
(integer-valued sums). The finalised static score is held at rtol 1e-6:
jnp's row max is exact, but XLA on the CPU may contract
`w_na*na + w_tt*tt` into a fused multiply-add, which eager torch never
does (the port matches the numpy oracle's rounding instead). The same
reason holds for the per-pod dynamic score and the batched one (K5).
The per-row top-K and seeded pick (K6) are exact. The desirability
column mean (K7) is bitwise equal to an f32 sum in ascending row order
and within rtol 1e-6 of the JAX lines, whose column sum XLA orders
itself. Usage after commits (K8, a whole `_deal_commit`) is held at
rtol 1e-6: JAX adds the committed requests with a duplicate-index
scatter-add of unspecified order."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched.kernels.atoms import atom_sat as jax_atom_sat
from tpusched.qos import tie_hash as jax_tie_hash
from tpusched.snapshot import (
    MatchExpression as JExpr,
    NodeSelectorTerm as JTerm,
    PreferredTerm as JPref,
    SnapshotBuilder as JBuilder,
)
from tpusched_torch.config import EngineConfig
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.kernels import score as kscore
from tpusched_torch.kernels.atoms import atom_sat, atom_sat_plain
from tpusched_torch.qos import tie_hash
from tpusched_torch.snapshot import snapshot_from_numpy


def _numeric_cluster():
    """Nodes with numeric and non-numeric labels, pods using every
    operator, so every branch of atom_sat has work."""
    b = JBuilder(JConfig())
    for i in range(10):
        b.add_node(f"n{i}", {"cpu": 8000.0, "memory": float(16 << 30)},
                   labels={"gen": str(i), "name": f"x{i}",
                           "ssd": "true" if i % 2 else "false",
                           **({"gpu": "1.5"} if i % 3 == 0 else {})})
    ops = [JExpr("gen", "Gt", ("4",)), JExpr("gen", "Lt", ("3",)),
           JExpr("gpu", "Gt", ("1",)), JExpr("name", "Gt", ("1",)),
           JExpr("ssd", "In", ("true",)), JExpr("ssd", "NotIn", ("true",)),
           JExpr("gpu", "Exists"), JExpr("gpu", "DoesNotExist"),
           JExpr("gen", "In", ("1", "2", "7"))]
    for i, e in enumerate(ops):
        b.add_pod(f"p{i}", {"cpu": 100.0}, required_terms=[JTerm((e,))],
                  preferred_terms=[JPref(float(i + 1), JTerm((ops[-1 - i],)))])
    return b.build()[0]


SNAPSHOTS = {
    "numeric_ops": _numeric_cluster,
    "taints": lambda: jsynth.make_cluster(
        np.random.default_rng(3), 40, 12, taint_frac=0.6,
        toleration_frac=0.5, cordon_frac=0.2)[0],
    "selectors_affinity": lambda: jsynth.make_cluster(
        np.random.default_rng(4), 40, 12, selector_frac=0.5,
        affinity_frac=0.5)[0],
    "mixed_qos": lambda: jsynth.make_cluster(
        np.random.default_rng(5), 48, 16, taint_frac=0.4,
        toleration_frac=0.3, selector_frac=0.3, affinity_frac=0.4,
        cordon_frac=0.1, with_qos=True)[0],
}


def _pair(name):
    jsnap = jax.device_put(SNAPSHOTS[name]())
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap))


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
@pytest.mark.parametrize("numeric", [True, False])
def test_atom_sat_plain_equals_jax(name, numeric):
    jsnap, tsnap = _pair(name)
    jn, tn = ((jsnap.nodes.label_nums, tsnap.nodes.label_nums) if numeric
              else (None, None))
    want = np.asarray(jax_atom_sat(jsnap.atoms, jsnap.nodes.label_pairs,
                                   jsnap.nodes.label_keys, jn))
    got = atom_sat(tsnap.atoms, tsnap.nodes.label_pairs,
                   tsnap.nodes.label_keys, tn)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper on a CPU tensor is exactly the plain version.
    assert torch.equal(got, atom_sat_plain(
        tsnap.atoms, tsnap.nodes.label_pairs, tsnap.nodes.label_keys, tn))


def test_atom_sat_covers_every_operator():
    jsnap, _ = _pair("numeric_ops")
    ops = set(np.asarray(jsnap.atoms.op)[np.asarray(jsnap.atoms.valid)])
    assert ops == {0, 1, 2, 3, 4, 5}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_tableau_cells_plain_equals_jax(name):
    jsnap, tsnap = _pair(name)
    jsat, _ = jax_sat_tables(jsnap)
    want = jassign._tableau_cells(jsnap, jsnap.pods, jsnap.nodes, jsat)
    tsat = _sat_tables(tsnap)[0]
    got = tassign._tableau_cells(tsnap, tsnap.pods, tsnap.nodes, tsat)
    for field, g, w in zip(("mask", "aff_ok", "na_raw", "tt_count"), got,
                           want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_finalize_static_plain_matches_jax(name):
    jsnap, tsnap = _pair(name)
    jcfg, tcfg = JConfig(), EngineConfig()
    jsat, jmem = jax_sat_tables(jsnap)
    want = jassign.precompute_static(jcfg, jsnap, jsat, jmem)
    tsat = _sat_tables(tsnap)[0]
    got = tassign.precompute_static(tcfg, tsnap, tsat)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.aff_ok.numpy(), np.asarray(want.aff_ok))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-6, atol=0)
    for w in ("w_lr", "w_ba", "w_ts", "w_ia"):
        np.testing.assert_allclose(getattr(got, w).numpy(),
                                   np.asarray(getattr(want, w)), rtol=1e-6)
    np.testing.assert_array_equal(got.rw.numpy(), np.asarray(want.rw))


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_tie_hash_bit_equal(seed):
    idx = np.arange(10_000)
    want = np.asarray(jax_tie_hash(seed, jnp.asarray(idx, jnp.int32)))
    got = tie_hash(seed, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    host = np.array([tie_hash(seed, int(i)) for i in idx[::97]])
    np.testing.assert_array_equal(host, want[::97].astype(np.int64))


@pytest.mark.parametrize("name", ["mixed_qos", "taints"])
def test_pop_order_equals_jax(name):
    jsnap, tsnap = _pair(name)
    want = np.asarray(jassign.pop_order(JConfig(), jsnap))
    got = tassign.pop_order(EngineConfig(), tsnap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_pod_cycle_plain_matches_jax(name):
    """The scan body (K4's plain version) for every pod against the
    snapshot's initial usage: feasibility and the allowed row (what the
    preemption branch searches over) exact, score to f32."""
    jsnap, tsnap = _pair(name)
    jcfg, tcfg = JConfig(), EngineConfig()
    jsat, jmem = jax_sat_tables(jsnap)
    jstatic = jassign.precompute_static(jcfg, jsnap, jsat, jmem)
    jst = jassign.kpair.pair_state_init(jsnap, jstatic.sig_match)
    tstatic = tassign.precompute_static(tcfg, tsnap, _sat_tables(tsnap)[0])
    for p in range(int(np.asarray(jsnap.pods.valid).sum())):
        jf, js, ja = jassign.pod_cycle(jcfg, jsnap, jstatic, p,
                                       jsnap.nodes.used, jst)
        tf, ts, ta = tassign.pod_cycle(tcfg, tsnap, tstatic, p,
                                       tsnap.nodes.used)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


# -- the fast-mode and ScoreBatch kernels' plain versions (K5-K8) ------------


# Extended resources through EngineConfig(resources=...) on both sides:
# R = 1 (cpu alone) and R = 5 (gpus and NICs beside the three defaults,
# on a part of the nodes and pods; a node without one has no capacity of
# it, so LR and BA take their `alloc > 0` branches).
EXT_RESOURCES = {
    "ext_r1": (("cpu",), {"cpu": 1.0}),
    "ext_r5": (("cpu", "memory", "pods", "gpu", "nic"),
               {"cpu": 1.0, "memory": 1.0, "gpu": 2.0, "nic": 0.5}),
}


def _ext_pair(name):
    res, w = EXT_RESOURCES[name]
    rng = np.random.default_rng(len(res))
    b = JBuilder(JConfig(resources=res, score_resource_weights=w))
    for i in range(14):
        alloc = {"cpu": float(rng.integers(2, 17) * 1000),
                 "memory": float(rng.integers(4, 65) << 30)}
        if rng.random() < 0.6:
            alloc["gpu"] = float(rng.integers(1, 9))
        if rng.random() < 0.5:
            alloc["nic"] = float(rng.integers(1, 5))
        b.add_node(f"n{i}", alloc, used={
            k: float(v * rng.uniform(0, 0.6)) for k, v in alloc.items()})
    for p in range(40):
        req = {"cpu": float(rng.integers(1, 40) * 100),
               "memory": float(rng.integers(1, 16) << 28)}
        if rng.random() < 0.4:
            req["gpu"] = float(rng.integers(1, 4))
        if rng.random() < 0.3:
            req["nic"] = 1.0
        b.add_pod(f"p{p}", req, priority=float(rng.integers(0, 5)))
    jsnap = jax.device_put(b.build()[0])
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap))


def _round_inputs(name, used_frac=0.3):
    """One fast round's inputs on both sides: the snapshot, the static
    context, and a `used` raised by used_frac of allocatable (so the
    resource filter cuts)."""
    if name in EXT_RESOURCES:
        res, w = EXT_RESOURCES[name]
        jsnap, tsnap = _ext_pair(name)
        jcfg = JConfig(mode="fast", resources=res, score_resource_weights=w)
        tcfg = EngineConfig(mode="fast", resources=res,
                            score_resource_weights=w)
    else:
        jsnap, tsnap = _pair(name)
        jcfg, tcfg = JConfig(mode="fast"), EngineConfig(mode="fast")
    jsat, jmem = jax_sat_tables(jsnap)
    jstatic = jassign.precompute_static(jcfg, jsnap, jsat, jmem)
    tstatic = tassign.precompute_static(tcfg, tsnap, _sat_tables(tsnap)[0])
    used = (np.asarray(jsnap.nodes.used)
            + np.float32(used_frac) * np.asarray(jsnap.nodes.allocatable))
    used = used.astype(np.float32)
    return jsnap, tsnap, jstatic, tstatic, used


def _t_cycle(tsnap, tstatic, used, **kw):
    return tassign.cycle_plain(
        tsnap.nodes.allocatable, torch.from_numpy(used), tsnap.pods.requests,
        tstatic.mask, tstatic.score, tstatic.w_lr, tstatic.w_ba,
        tstatic.w_ts, tstatic.rw, **kw)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS) + sorted(EXT_RESOURCES))
def test_cycle_plain_matches_batched_cycle(name):
    """K5's plain version against batched_cycle (full width) and
    _cycle_nosig on a gathered view: feasibility exact, score to f32
    (rtol 1e-6: XLA's FMA contraction, ROADMAP C1)."""
    jsnap, tsnap, jstatic, tstatic, used = _round_inputs(name)
    st0 = jassign.kpair.pair_state_init(jsnap, jstatic.sig_match)
    jf, js = jassign.batched_cycle(JConfig(), jsnap, jstatic,
                                   jnp.asarray(used), st0)
    tf, ts = _t_cycle(tsnap, tstatic, used)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # A view of every other pod, pending cut to the even ones of it.
    P = tf.shape[0]
    sel = np.arange(1, P, 2, dtype=np.int32)
    pend = np.arange(sel.shape[0]) % 2 == 0
    p = jsnap.pods
    vf, vs = jassign._cycle_nosig(
        jsnap.nodes.allocatable, jnp.asarray(used), p.requests[sel],
        jstatic.mask[sel], jstatic.score[sel], jstatic.w_lr[sel],
        jstatic.w_ba[sel], jstatic.w_ts[sel], jstatic.rw)
    vf = np.asarray(vf) & pend[:, None]
    gf, gm = _t_cycle(tsnap, tstatic, used, rows=torch.from_numpy(sel),
                      pending=torch.from_numpy(pend), masked=True)
    np.testing.assert_array_equal(gf.numpy(), vf)
    want = np.where(vf, np.asarray(vs), -np.inf)
    np.testing.assert_allclose(gm.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(np.isneginf(gm.numpy()), ~vf)


# K5's tile at the widths the paths give it: (b)'s 5 120 nodes, a tenant
# batch's 2 048, a 1 500-node and a 1 003-node cluster, a narrow one of
# 300, one warp's 37 nodes, a single node.
@pytest.mark.parametrize("N,want", [
    (5120, (16, 128)), (2048, (16, 128)), (1500, (16, 128)),
    (1003, (16, 128)), (300, (16, 96)), (37, (16, 32)), (1, (16, 32))])
def test_cycle_tile_choice(N, want):
    tr, threads = tassign.cycle_tile(N)
    assert (tr, threads) == want
    assert 1 <= tr <= 32 and 32 <= threads <= 256 and threads % 32 == 0
    # A tile covers N where one CTA's threads can: 4 nodes a thread.
    assert threads * 4 >= min(N, tassign.CYCLE_THREADS * 4)


# node_add's buckets: in shared memory up to a CTA's 227 KB (P = 10 240
# at N = 5 120, the headline; a tenant's 3 072 rows), in global scratch
# past it.
@pytest.mark.parametrize("P,N,shared", [(10240, 5120, True),
                                        (3072, 2048, True),
                                        (30000, 500, False)])
def test_node_add_bucket_memory(P, N, shared):
    b = tassign.node_add_smem_bytes(P, N)
    assert b == 8 * P + 4 * (N + P // 32 + 2)
    assert (b <= tassign.NODE_ADD_SMEM_MAX) == shared


def test_node_add_row_arguments():
    """node_add's row arguments as its kernel reads them: int32 or bool
    with unit stride along the pods, the tenant stride returned (0 for
    one rank row every tenant shares); anything else refused."""
    cpu = torch.device("cpu")
    rank = torch.arange(6, dtype=torch.int32).expand(3, 6)
    assert tassign._rows_stride("node_add", cpu, rank, torch.int32,
                                (3,), 6) == 0
    node = torch.arange(18, dtype=torch.int32).reshape(3, 6)
    assert tassign._rows_stride("node_add", cpu, node, torch.int32,
                                (3,), 6) == 6
    assert tassign._rows_stride("node_add", cpu, node[0], torch.int32,
                                (), 6) == 0
    with pytest.raises(TypeError):
        tassign._rows_stride("node_add", cpu, node.long(), torch.int32,
                             (3,), 6)
    for bad, lead in ((node.T.contiguous().T, (3,)), (node, (2,))):
        with pytest.raises(ValueError):
            tassign._rows_stride("node_add", cpu, bad, torch.int32, lead, 6)


def _tie_heavy(seed=0, rows=24, N=16):
    """Scores on a coarse grid (many ties), -inf holes, one -inf row."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 4, size=(rows, N)).astype(np.float32) * 25.0
    m[rng.random((rows, N)) < 0.3] = -np.inf
    m[3] = -np.inf
    return m


def _masked(name):
    """A round's masked score block of a snapshot, or the tie-heavy one."""
    if name == "tie_heavy":
        return _tie_heavy()
    _, tsnap, _, tstatic, used = _round_inputs(name)
    return _t_cycle(tsnap, tstatic, used, masked=True)[1].numpy()


@pytest.mark.parametrize("name", ["tie_heavy"] + sorted(SNAPSHOTS))
@pytest.mark.parametrize("K", [1, 3, 8])
def test_row_topk_plain_matches_lax_top_k(name, K):
    """K6's plain version against lax.top_k and pick_node_batch on the
    same f32 matrix: exact (values, indices, tie order, seeded pick)."""
    m = _masked(name)
    K = min(K, m.shape[1])
    jv, ji = jax.lax.top_k(jnp.asarray(m), K)
    ids = np.arange(m.shape[0], dtype=np.int32)[::-1].copy()
    tv, ti, tp = tassign.row_topk_plain(torch.from_numpy(m), K, True, 77,
                                        torch.from_numpy(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jp = jassign.pick_node_batch(JConfig(tie_break="seeded", tie_seed=77),
                                 jnp.asarray(m), jnp.asarray(ids))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    got = tassign.pick_node_batch(
        EngineConfig(tie_break="seeded", tie_seed=77), torch.from_numpy(m),
        torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp))


def _jax_desirability(feasible, masked, allowed):
    """_deal_commit's desirability lines (tpusched/kernels/assign.py
    :793-814, cum_width=None), as jnp."""
    ok = jnp.asarray(feasible) & jnp.asarray(allowed)[:, None]
    n_allowed = jnp.maximum(jnp.asarray(allowed).sum(), 1)
    desir = jnp.sum(jnp.where(ok, jnp.asarray(masked), 0.0),
                    axis=0) / n_allowed
    return np.asarray(jnp.where(jnp.any(ok, axis=0), desir, -jnp.inf))


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_desirability_plain(name):
    """K7's plain version: bitwise equal to an f32 sum in ascending row
    order (the order the kernel fixes), and to the JAX lines at rtol
    1e-6 (XLA sums the column in an order of its own)."""
    _, tsnap, _, tstatic, used = _round_inputs(name)
    f, m = _t_cycle(tsnap, tstatic, used, masked=True)
    allowed = f.any(dim=1)
    got = tassign.desirability_plain(f, m, allowed).numpy()
    fn, mn, an = f.numpy(), m.numpy(), allowed.numpy()
    acc = np.zeros(fn.shape[1], np.float32)
    for p in range(fn.shape[0]):
        acc = acc + np.where(fn[p] & an[p], mn[p], np.float32(0))
    ok = (fn & an[:, None]).any(axis=0)
    want = np.where(ok, acc / np.float32(max(an.sum(), 1)), -np.inf)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_allclose(got, _jax_desirability(fn, mn, an), rtol=1e-6)


def _candidates(tsnap, f, m, allowed, rank, K):
    """Round inputs of the first sub-step: each pod's candidate list
    (the dealt node, then its top-K), through the port's _deal_commit
    with a prefix_commit that records its first call."""
    calls = []

    def record(*args):
        calls.append(args)
        return tassign.prefix_commit_plain(*args)

    topv, topi, _ = tassign.row_topk_plain(m, K)
    ops = dataclasses.replace(tassign.PLAIN, prefix_commit=record)
    out = tassign._deal_commit(
        tsnap.nodes.allocatable, tsnap.pods.requests, tsnap.nodes.used, f,
        m, allowed, rank, topv, topi, ops=ops)
    return calls, out


def _np_substep(perm, cand_s, req, alloc, used, choice, ptr, KC):
    """The JAX sub-step (tpusched/kernels/assign.py:900-957) in numpy, with
    exact (float64) request prefixes and ascending-rank `used` adds."""
    P, N = perm.shape[0], alloc.shape[0]
    act = cand_s < N
    req_s = np.where(act[:, None], req[perm], 0.0).astype(np.float64)
    used = used.copy()
    choice, ptr = choice.copy(), ptr.copy()
    i = 0
    while i < P:
        j = i
        while j < P and cand_s[j] == cand_s[i]:
            j += 1
        if act[i]:
            n = cand_s[i]
            within = np.cumsum(req_s[i:j], axis=0)
            fits = (used[n].astype(np.float64) + within
                    <= alloc[n].astype(np.float64)).all(axis=1)
            ok = np.cumprod(fits).astype(bool)
            for t in range(i, j):
                q = perm[t]
                if ok[t - i]:
                    choice[q], ptr[q] = n, KC
                    used[n] = used[n] + req[q]
                elif not fits[t - i]:
                    ptr[q] += 1
        i = j
    return used, choice, ptr


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_prefix_commit_plain_first_substep(name):
    """K8's plain version on the first sub-step of a full-width round:
    the same commits, pointers and usage as the JAX sub-step's formulas
    (usage to rtol 1e-6: the f32 adds are the same, in rank order, but
    the check sums the prefixes exactly)."""
    _, tsnap, _, tstatic, _ = _round_inputs(name, used_frac=0.0)
    used0 = tsnap.nodes.used.numpy()
    f, m = _t_cycle(tsnap, tstatic, used0, masked=True)
    allowed = f.any(dim=1)
    order = tassign.pop_order(EngineConfig(), tsnap)
    P = order.shape[0]
    rank = torch.zeros(P, dtype=torch.int32)
    rank[order] = torch.arange(P, dtype=torch.int32)
    K = tassign._fallback_depth(m.shape[1])
    calls, _ = _candidates(tsnap, f, m, allowed, rank, K)
    assert calls, "no sub-step ran"
    perm, cand_s, req, alloc, used, choice, ptr, KC = calls[0]
    # The sort: (node, rank) ascending, inactive rows (node N) last.
    N = alloc.shape[0]
    key = cand_s.long() * P + rank[perm.long()].long()
    assert (key[1:] > key[:-1]).all()
    got = tassign.prefix_commit_plain(*calls[0])
    want = _np_substep(perm.numpy(), cand_s.numpy(), req.numpy(),
                       alloc.numpy(), used.numpy(), choice.numpy(),
                       ptr.numpy(), KC)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
    assert (got[1].numpy() >= 0).any()
    assert (cand_s.numpy() < N).any()


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_deal_commit_plain_matches_jax(name, tie_break):
    """A whole round's dealing + sub-steps + rescue (K6, K7, K8 plain)
    against the JAX _deal_commit on the same feasible/masked inputs:
    the same commits and chosen scores, usage to rtol 1e-6 (JAX's
    duplicate-index scatter-add and column sum round in orders of their
    own)."""
    jsnap, tsnap, _, tstatic, _ = _round_inputs(name, used_frac=0.0)
    used0 = tsnap.nodes.used.numpy()
    f, m = _t_cycle(tsnap, tstatic, used0, masked=True)
    allowed = f.any(dim=1)
    tcfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=3)
    jcfg = JConfig(mode="fast", tie_break=tie_break, tie_seed=3)
    order = tassign.pop_order(tcfg, tsnap)
    P, N = m.shape
    rank = torch.zeros(P, dtype=torch.int32)
    rank[order] = torch.arange(P, dtype=torch.int32)
    K = tassign._fallback_depth(N)
    ids = torch.arange(P, dtype=torch.int32)
    topv, topi, pick = tassign.row_topk_plain(m, K, tie_break == "seeded",
                                              3, ids)
    used2, choice, chosen = tassign._deal_commit(
        tsnap.nodes.allocatable, tsnap.pods.requests, tsnap.nodes.used, f, m,
        allowed, rank, topv, topi, tie_pick=pick, ops=tassign.PLAIN)
    jm = jnp.asarray(m.numpy())
    jused2, jchoice, jchosen = jassign._deal_commit(
        jsnap.nodes.allocatable, jsnap.pods.requests, jsnap.nodes.used,
        jnp.asarray(f.numpy()), jm, jnp.asarray(allowed.numpy()),
        jnp.asarray(rank.numpy()), K,
        tie_pick=jassign.pick_node_batch(jcfg, jm, jnp.asarray(ids.numpy())))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    np.testing.assert_allclose(used2.numpy(), np.asarray(jused2), rtol=1e-6)


def test_balanced_allocation_root_correctly_rounded():
    """The plain balanced-allocation score takes the correctly rounded
    f32 square root (numpy's, CUDA sqrtf's), bitwise equal to the
    oracle's op order (tpusched/oracle.py score_balanced), on 393 216
    random cells: PyTorch's f32 sqrt on AVX-512 CPUs is 1 ulp off on
    some of them."""
    rng = np.random.default_rng(5)
    P, N, R = 256, 512, 3
    alloc = rng.uniform(1.0, 64.0, (N, R)).astype(np.float32)
    alloc[rng.random((N, R)) < 0.05] = 0.0
    used = (alloc * rng.uniform(0.0, 0.9, (N, R))).astype(np.float32)
    req = rng.uniform(0.0, 8.0, (P, R)).astype(np.float32)
    rw = np.array([1.0, 1.0, 0.0], np.float32)
    got = kscore.balanced_allocation(*(torch.from_numpy(x) for x in (
        alloc, used, req, rw))).numpy()
    sel = (rw > 0).astype(np.float32)
    k = np.float32(max(sel.sum(), 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(alloc > 0, (used[None] + req[:, None]) / alloc,
                        np.float32(1.0))
    frac = np.clip(frac, 0.0, 1.0).astype(np.float32)
    acc = np.zeros((P, N), np.float32)
    for r in range(R):
        acc = acc + frac[..., r] * sel[r]
    mean = acc[..., None] / k
    d = frac - mean
    var = np.zeros((P, N), np.float32)
    for r in range(R):
        var = var + (d[..., r] * d[..., r]) * sel[r]
    var = var / k
    want = ((np.float32(1.0) - np.sqrt(var)) * np.float32(100.0)).astype(
        np.float32)
    np.testing.assert_array_equal(got, want)


def test_segment_prefix_fixed_order():
    """K15's segment sums, pinned: each segment in blocks of 16 rows, a
    block summed left to right from 0.0, the block totals added left to
    right, a row's sum the totals before its block plus its block's sum
    up to the row; written out here row by row, on values whose f32 sums
    depend on the order, short segments and one of 500 rows. It is not
    the JAX association (a prefix over all rows minus its value at the
    segment's start), whose cancellation the segments avoid: its largest
    error against the f64 sums is over ten times the segment sums', on
    the segments of up to eight rows (config 5's eight running pods a
    node) and on the 500-row one alike."""
    r = np.random.default_rng(0)
    M = 2053
    x = (r.uniform(0, 1, (M, 2)) * 10.0 ** r.integers(6, 10, (M, 1)))
    x = torch.from_numpy(x.astype(np.float32))
    lengths = r.integers(1, 9, M)
    lengths[100] = 500                      # a segment of many blocks
    start = np.zeros(M, bool)
    start[np.cumsum(np.concatenate([[0], lengths]))[:-1]
          [np.cumsum(np.concatenate([[0], lengths]))[:-1] < M]] = True
    got = kpre.segment_prefix(x, torch.from_numpy(start))
    want = torch.empty_like(x)
    j = 0
    for i in range(M):
        j = 0 if start[i] or i == 0 else j + 1
        if j == 0:
            tot = torch.zeros(2)
        elif j % 16 == 0:
            tot = tot + blk
        blk = (torch.zeros(2) if j % 16 == 0 else blk) + x[i]
        want[i] = tot + blk
    assert torch.equal(got, want)
    seg = np.maximum.accumulate(np.where(start, np.arange(M), 0))
    exact = np.zeros((M, 2))
    for i in range(M):
        exact[i] = x[seg[i]:i + 1].double().sum(0).numpy()
    cum = np.cumsum(x.numpy(), axis=0, dtype=np.float32)
    jax_like = cum - np.where((seg > 0)[:, None], cum[np.maximum(seg - 1, 0)],
                              0)
    err_seg = np.abs(got.numpy() - exact).max(axis=1)
    err_jax = np.abs(jax_like - exact).max(axis=1)
    seg_id = np.cumsum(start) - 1
    short = np.bincount(seg_id)[seg_id] <= 8
    assert not short.all()
    assert err_seg.max() * 10 < err_jax.max()
    assert err_seg[short].max() * 10 < err_jax[short].max()
    assert err_seg[~short].max() * 10 < err_jax[~short].max()


# -- the fast preemption auction (K16, K17, K6 at K = 256) -------------------


def _auction_inputs(seed: int, C: int = 24):
    """A config-5 snapshot (JAX-built), its node-major victim table in
    both packages, and a random auction state: evicted victims, usage,
    lane thresholds with ties at victim priorities, bidders' lanes,
    allowed nodes and requests."""
    from tpusched.kernels import preempt as jpre

    jsnap, _ = jsynth.config5_preemption(np.random.default_rng(seed), 40, 12,
                                         pdb_frac=0.6)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jctx = jpre.precompute_nv(JConfig(), jsnap, 16)
    tctx = kpre.precompute_nv(EngineConfig(), tsnap, 16)
    r = np.random.default_rng(seed)
    M = tsnap.running.valid.shape[0]
    N = tsnap.nodes.valid.shape[0]
    ev = (r.random(M) < 0.2) & np.asarray(jsnap.running.valid)
    vp = np.asarray(jctx.vprio)
    thr = np.array([vp[np.isfinite(vp)].min(), float(np.median(
        vp[np.isfinite(vp)])), np.inf], np.float32)
    used = (np.asarray(jsnap.nodes.used)
            * r.uniform(0.9, 1.05, (N, 1))).astype(np.float32)
    reqs = np.asarray(jsnap.pods.requests)
    req = reqs[r.integers(0, reqs.shape[0], C)]
    ok = r.random((C, N)) < 0.7
    lane = r.integers(0, 2, C).astype(np.int32)
    return jsnap, tsnap, jctx, tctx, ev, thr, used, req, ok, lane


def _jax_lane_tables(jsnap, jctx, ev, thr_b):
    """preempt_auction's node_rank tables (tpusched/kernels/preempt.py
    :491-506), as jnp."""
    M = ev.shape[0]
    V = jctx.vvalid.shape[1]
    ev_nv = jnp.asarray(ev)[jnp.clip(jctx.vidx, 0, M - 1)] & jctx.vvalid
    elig = jctx.vvalid & ~ev_nv & (jctx.vprio + 0.0 < thr_b)
    cum_req = jnp.cumsum(jnp.where(elig[..., None], jctx.vreq, 0.0), axis=1)
    cum_cost = jnp.cumsum(jnp.where(elig, jctx.vcost, 0.0), axis=1)
    run_pdb = jsnap.running.pdb_group
    consumed = jnp.zeros(jsnap.pdb_allowed.shape[0], jnp.float32).at[
        jnp.clip(run_pdb, 0, None)].add(
        (jnp.asarray(ev) & (run_pdb >= 0) & jsnap.running.valid).astype(
            jnp.float32))
    remaining = jsnap.pdb_allowed - consumed
    has = jctx.vpdb >= 0
    tri = jnp.arange(V)[:, None] >= jnp.arange(V)[None, :]
    same = ((jctx.vpdb[:, :, None] == jctx.vpdb[:, None, :])
            & has[:, :, None] & tri[None]).astype(jnp.float32)
    wcnt = jnp.einsum("nvw,nw->nv", same, (elig & has).astype(jnp.float32))
    viol = elig & has & (wcnt > remaining[jnp.clip(jctx.vpdb, 0, None)])
    cum_viol = jnp.cumsum(viol.astype(jnp.float32), axis=1)
    return cum_req, cum_cost, cum_viol, remaining


@pytest.mark.parametrize("seed", range(3))
def test_auction_tables_and_rank_plain_match_jax(seed):
    """K16's plain lane tables against preempt_auction's jnp lines
    (requests and cost at 1 ulp: XLA orders its V-long cumsum itself;
    the violation counts exact), and K17's plain ranking against the
    jnp ranking of the same tables (first-feasible position, fallback
    lane, fewest violations, bids) exactly."""
    jsnap, tsnap, jctx, tctx, ev, thr, used, req, ok, lane = \
        _auction_inputs(seed)
    jt = [_jax_lane_tables(jsnap, jctx, ev, t) for t in thr]
    remaining = torch.from_numpy(np.asarray(jt[0][3]))
    cum_req, cum_cost, cum_viol = kpre.auction_tables_plain(
        tctx, torch.from_numpy(ev), torch.from_numpy(thr), remaining, 0.0)
    for l in range(3):
        np.testing.assert_array_max_ulp(cum_req[l].numpy(),
                                        np.asarray(jt[l][0]), maxulp=1)
        np.testing.assert_array_max_ulp(cum_cost[l].numpy(),
                                        np.asarray(jt[l][1]), maxulp=1)
        np.testing.assert_array_equal(cum_viol[l].numpy(),
                                      np.asarray(jt[l][2]).astype(np.int32))
    assert int(cum_viol[-1, :, -1].sum()) > 0
    bid, could = kpre.auction_rank_plain(
        cum_req, cum_cost, cum_viol, torch.from_numpy(lane),
        torch.from_numpy(ok), torch.from_numpy(used),
        tsnap.nodes.allocatable, torch.from_numpy(req))
    # The jnp ranking (:486, :510-562) on the port's tables.
    tabs = [(jnp.asarray(cum_req[l].numpy()), jnp.asarray(cum_cost[l].numpy()),
             jnp.asarray(cum_viol[l].numpy().astype(np.float32)))
            for l in range(3)]
    need = (jnp.asarray(used)[None] + jnp.asarray(req)[:, None, :]
            - jsnap.nodes.allocatable[None])
    C, N = ok.shape
    V = cum_req.shape[2]

    def rank_j(cr, cc, cv):
        pos = jnp.zeros((C, N), jnp.int32)
        for r in range(need.shape[2]):
            pos = jnp.maximum(pos, jnp.sum(
                (cr[None, :, :, r] < need[:, :, None, r]).astype(jnp.int32),
                axis=2))
        feas = jnp.all(need <= cr[None, :, V - 1, :], axis=-1)
        posc = jnp.clip(pos, 0, V - 1)
        return (feas, cc[jnp.arange(N)[None, :], posc],
                cv[jnp.arange(N)[None, :], posc])

    lanes = [rank_j(*t) for t in tabs]
    pick = lambda i: jnp.take_along_axis(jnp.stack(
        [lanes[0][i], lanes[1][i]]), jnp.asarray(lane)[None, :, None],
        axis=0)[0]
    okj = jnp.asarray(ok)
    feas_o, cost_o, viol_o = lanes[2]
    use_fb = (~jnp.any(okj & pick(0), axis=1)
              & jnp.any(okj & feas_o, axis=1))[:, None]
    feas = jnp.where(use_fb, feas_o, pick(0))
    cost = jnp.where(use_fb, cost_o, pick(1))
    viol = jnp.where(use_fb, viol_o, pick(2))
    vt = jnp.where(okj & feas, viol, jnp.inf)
    total = jnp.where(okj & feas & (vt == jnp.min(vt, axis=1,
                                                  keepdims=True)),
                      cost, jnp.inf)
    np.testing.assert_array_equal(bid.numpy(), np.asarray(-total))
    np.testing.assert_array_equal(could.numpy(),
                                  np.asarray(jnp.any(okj & feas_o, axis=1)))
    assert np.isfinite(bid.numpy()).any()


def test_row_topk_plain_signed_zero_ties():
    """K6's plain version ranks -0.0 with +0.0, ties to the lower index
    (as csrc/cell.cuh `beats` compares them), and returns +0.0 for
    either: the same on the CPU as on CUDA, whose float sort would put
    -0.0 after +0.0. Held against a stable numpy ranking by value."""
    r = np.random.default_rng(1)
    m = np.where(r.random((6, 300)) < 0.5, np.float32(-0.0),
                 np.float32(0.0)).astype(np.float32)
    m[r.random(m.shape) < 0.2] = -1.0
    m[r.random(m.shape) < 0.1] = -np.inf
    for K in (17, 256):
        tv, ti, _ = tassign.row_topk_plain(torch.from_numpy(m), K)
        want = np.argsort(-(m + np.float32(0.0)), axis=1, kind="stable")
        np.testing.assert_array_equal(ti.numpy(), want[:, :K])
        v = tv.numpy()
        assert not np.signbit(v[v == 0]).any()


def test_row_topk_plain_k256_matches_lax_top_k():
    """K6's plain version at the auction's K = 256 on a bid-like block
    (negated costs with many ties, -inf where a node is not a bid)
    against lax.top_k(-total, 256): exact, ties to the lower index."""
    r = np.random.default_rng(0)
    m = -r.integers(1, 40, size=(48, 700)).astype(np.float32)
    m[r.random(m.shape) < 0.5] = -np.inf
    m[:3] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(m), 256)
    tv, ti, _ = tassign.row_topk_plain(torch.from_numpy(m), 256)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
