"""The port's ring path on a device mesh (`tpusched_torch.mesh`,
`tpusched_torch.ring`, `Engine(mesh=...)`, `solve_many(mesh=...)`) and
the exact auction tableau `_tableau_nv`, on the CPU, where every kernel
wrapper runs its plain version, against the JAX package.

  * The hop (K25's plain version), rotated over 1, 2, 4 and 8 blocks in
    one process as an ndev-rank ring rotates them, gives counts EQUAL to
    JAX's `ring_sig_counts` on a (ndev, 1) mesh of 8 virtual CPU devices
    and to JAX's dense `sig_counts` (integers in f32: exact in any
    order), with no pod placed and with half of them placed, with three
    namespaces against JAX's (4, 2) mesh, and on an atom-less snapshot.
    Every JAX computation on a mesh of more than one device (its
    collectives) runs in a process of its own,
    tests/jax_ring_reference.py, never in the test's.
  * Real exchange: gloo rings of 2 and 4 processes and a (2, 2) mesh
    (tests/torch_ring_worker.py, a FileStore under tmp_path, a time
    limit a process). Each rank's counts are EQUAL to JAX's ring on the
    same mesh shape; each rank's ring engine, parity and fast, gives
    assignment, order and commit_key EQUAL to JAX's ring engine on that
    mesh shape (run beside the ranks), chosen_score at rtol 1e-4 / atol
    1e-3 and final_used at rtol 1e-5, the JAX package's own parity
    tolerances (XLA contracts multiply-adds on the CPU, ROADMAP C1).
    `solve_many` over a 2-rank mesh equals the unsplit batch bit for bit
    and JAX's tenant-sharded `solve_many` in assignment, order and
    rounds (used at rtol 1e-6, chosen at 1e-5: the commit adds' order,
    ROADMAP C6, and C1).
  * The one-rank mesh engine: parity, fast, `score_topk`,
    `solve_explained` and the warm rungs bit for bit equal to the port's
    dense engine, and to JAX's `Engine(..., mesh=make_mesh((1, 1)))` as
    above; incremental warm solves and ring_counts without a mesh raise.
  * `_tableau_nv`'s plain version against JAX's on the same inputs: all
    six outputs EQUAL (every prefix is V = 16 long and summed left to
    right from 0.0 in both; wviol is the port's int32 count of JAX's f32
    one).
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import snapshot as jsnapshot
from tpusched import synth as jsynth
from tpusched import tenants as jtenants
from tpusched.config import Buckets as JBuckets
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import pairwise as jpair
from tpusched.kernels import preempt as jpre
from tpusched.mesh import make_mesh as jmake_mesh
from tpusched_torch import Engine, EngineConfig, solve_many, stack_snapshots
from tpusched_torch import snapshot as tsnapshot
from tpusched_torch.device_state import DeviceSnapshot
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels import preempt as tpre
from tpusched_torch.mesh import Mesh, make_mesh
from tpusched_torch.ring import ring_sig_counts, ring_sig_counts_rotated
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_fastpreempt import _auction_state, _jax_and_port

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_ring_worker.py"
sys.path.insert(0, str(WORKER.parent))
import torch_ring_worker as worker  # noqa: E402


def _jsnap(seed: int, **kw):
    """tests/test_ring.py's snapshot, built by the JAX package."""
    return jsynth.make_cluster(np.random.default_rng(seed), 48, 16,
                               **dict(worker.RING_MIX, **kw))[0]


MESHES = [(2, 1), (4, 1), (2, 2)]
# JAX's ring counts that the tests below hold the port to, each computed
# on its mesh in one process of its own (tests/jax_ring_reference.py
# `counts`): name -> [seed (None: torch_ring_worker.atomless),
# namespace_count, half placed, mesh shape].
RING_REFS = {
    **{f"rotated {ndev} {half}": [100 + ndev, 0, half, (ndev, 1)]
       for ndev in (1, 2, 4, 8) for half in (False, True)},
    "namespaces (4, 2)": [321, 3, False, (4, 2)],
    **{f"atomless {ndev}": [None, 0, False, (ndev, 1)] for ndev in (1, 2)},
    **{f"gloo {name} {shape}": [seed, ns, half, shape]
       for shape in MESHES for name, seed, ns, half in worker.COUNT_CASES},
}


def _jax_dense(jsnap, assigned):
    """JAX's dense sig_counts (one device: computed here)."""
    _, msat = jax_sat_tables(jsnap)
    sm = jax.jit(jpair.sig_member_match)(jsnap, msat)
    return np.asarray(jax.jit(jpair.sig_counts)(jsnap, sm, assigned))


def _unplaced(snap) -> np.ndarray:
    return np.full(np.asarray(snap.pods.valid).shape[0], -1, np.int32)


def _rotated(jsnap, assigned, ndev):
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    _, msat = _sat_tables(tsnap)
    return tsnap, msat, ring_sig_counts_rotated(
        tsnap, msat, torch.from_numpy(assigned), ndev,
        hop=kpair.ring_hop_plain)


# -- the hop, rotated in one process ------------------------------------------


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("assign_some", [False, True])
def test_rotated_hop_equals_jax_ring(jax_refs, ndev, assign_some):
    """The hop over ndev rotating blocks (sblk = S / ndev signatures
    against mblk = (M + P) / ndev members, both padded as JAX pads them)
    equals JAX's ring on a (ndev, 1) mesh and JAX's dense counts, and
    the port's dense counts (K10's plain version)."""
    jsnap = _jsnap(100 + ndev)
    a = worker.assigned_half(jsnap) if assign_some else _unplaced(jsnap)
    ring = jax_refs[f"rotated {ndev} {assign_some}"]
    dense = _jax_dense(jsnap, a)
    tsnap, msat, got = _rotated(jsnap, a, ndev)
    np.testing.assert_array_equal(ring, dense)
    np.testing.assert_array_equal(got.numpy(), ring)
    st = kpair.pair_counts(kpair.sig_match(msat, tsnap.sigs,
                                           kpair.member_ns(tsnap)),
                           kpair.sig_domains(tsnap), tsnap.running,
                           tsnap.pods, assigned=torch.from_numpy(a))
    assert torch.equal(got, st.counts)
    assert got.sum() > 0


@pytest.mark.parametrize("assign_some", [False, True])
def test_pair_counts_takes_the_rings_counts(assign_some):
    """K10 (its plain version) given the ring's counts, as JAX's
    pair_state_init(counts=) is given them, carries them as they are and
    counts anti and match_tot alone: those EQUAL the state it counts
    whole, and JAX's pair_state_init(counts=) with no pod placed."""
    jsnap = _jsnap(140)
    a = worker.assigned_half(jsnap) if assign_some else _unplaced(jsnap)
    tsnap, msat, ring = _rotated(jsnap, a, 2)
    args = (kpair.sig_match(msat, tsnap.sigs, kpair.member_ns(tsnap)),
            kpair.sig_domains(tsnap), tsnap.running, tsnap.pods)
    kw = dict(assigned=None if not assign_some else torch.from_numpy(a))
    whole = kpair.pair_counts(*args, **kw)
    assert torch.equal(ring, whole.counts)
    marked = torch.full_like(ring, 7.0)
    st = kpair.pair_counts(*args, counts=marked, **kw)
    assert st.counts is marked
    assert torch.equal(st.anti, whole.anti)
    assert torch.equal(st.match_tot, whole.match_tot)
    if not assign_some:
        _, jmsat = jax_sat_tables(jsnap)
        jst = jpair.pair_state_init(
            jsnap, jax.jit(jpair.sig_member_match)(jsnap, jmsat),
            counts=jnp.asarray(ring.numpy()))
        np.testing.assert_array_equal(np.asarray(jst.counts), ring.numpy())
        np.testing.assert_array_equal(np.asarray(jst.anti), st.anti.numpy())
        np.testing.assert_array_equal(np.asarray(jst.match_tot),
                                      st.match_tot.numpy())


def test_rotated_hop_namespaces_on_a_2d_mesh(jax_refs):
    """Namespace-scoped signatures: the hop rotated over the p axis of a
    (4, 2) mesh equals JAX's ring there (each n column runs the same
    ring, tests/test_ring.py:59) and the dense counts."""
    jsnap = _jsnap(321, namespace_count=3)
    a = _unplaced(jsnap)
    ring = jax_refs["namespaces (4, 2)"]
    np.testing.assert_array_equal(ring, _jax_dense(jsnap, a))
    np.testing.assert_array_equal(_rotated(jsnap, a, 4)[2].numpy(), ring)


@pytest.mark.parametrize("ndev", [1, 2])
def test_rotated_hop_atomless(jax_refs, ndev):
    """A = 0: the hop gives what JAX's ring gives (every member matches
    an atom-less selector), which is the dense count."""
    jsnap = worker.atomless(jsnapshot, JConfig())
    assert np.asarray(jsnap.atoms.key).shape[0] == 0
    a = _unplaced(jsnap)
    ring, dense = jax_refs[f"atomless {ndev}"], _jax_dense(jsnap, a)
    tsnap, msat, got = _rotated(jsnap, a, ndev)
    assert msat.shape[0] == 0
    np.testing.assert_array_equal(ring, dense)
    np.testing.assert_array_equal(got.numpy(), ring)
    assert got.sum() == 3
    # The port's SnapshotBuilder gives the same snapshot and counts.
    tsnap2 = worker.atomless(tsnapshot, EngineConfig())
    mesh = make_mesh(devices="cpu")
    assert torch.equal(ring_sig_counts(tsnap2, _sat_tables(tsnap2)[1],
                                       torch.from_numpy(a), mesh), got)


# -- real exchange: gloo rings of processes -----------------------------------


# A rank (and the JAX reference) may take this long under a loaded host;
# the ranks' gloo timeout (tests/torch_ring_worker.py) stays below it, so a
# hung rank fails its own test.
RANK_LIMIT_S = 240
REFERENCE = REPO / "tests" / "jax_ring_reference.py"


def _run(cmds, names, outs) -> list:
    """Run each command (a script and its arguments) as a subprocess of
    this test, all started together; none may take over RANK_LIMIT_S.
    Load each one's outputs (`outs`, .npz files)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_LIMIT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p, log in zip(names, procs, logs):
        assert p.returncode == 0, f"{name}: exit {p.returncode}\n{log}"
    return [dict(np.load(o)) for o in outs]


def _run_ranks(tmp_path, shape, what, reference=False) -> list:
    """Run every rank of a (p, n) gloo mesh (and, with `reference`, JAX's
    ring engine on a (p, n) mesh, tests/jax_ring_reference.py `engine`)
    through _run; each rank's outputs (the reference's last)."""
    world = shape[0] * shape[1]
    store = tmp_path / "store"
    cmds = [[str(WORKER), str(store), str(world), str(r), str(shape[0]),
             str(shape[1]), what, str(tmp_path / f"r{r}.npz")]
            for r in range(world)]
    outs = [tmp_path / f"r{r}.npz" for r in range(world)]
    if reference:
        cmds.append([str(REFERENCE), "engine", str(shape[0]), str(shape[1]),
                     str(tmp_path / "jax.npz")])
        outs.append(tmp_path / "jax.npz")
    names = [f"rank {r}" for r in range(world)] + ["JAX reference"] * reference
    return _run(cmds, names, outs)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """RING_REFS's counts, by name, and JAX's sharded solve_many on the
    eight tenants (keys `tenants_<field>`): tests/jax_ring_reference.py
    `counts`, one process for the whole file."""
    out = tmp_path_factory.mktemp("jax_refs") / "refs.npz"
    return _run([[str(REFERENCE), "counts", json.dumps(RING_REFS),
                  str(out)]], ["JAX reference"], [out])[0]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_gloo_ring_counts_equal_jax(tmp_path, jax_refs, shape):
    """Every rank's ring counts (signature blocks and their counts sent
    around the p ring, then gathered) equal JAX's ring on the same mesh
    shape and the dense counts: no pod placed, half placed, three
    namespaces."""
    outs = _run_ranks(tmp_path, shape, "counts")
    for name, seed, ns, half in worker.COUNT_CASES:
        jsnap = _jsnap(seed, **(dict(namespace_count=ns) if ns else {}))
        a = worker.assigned_half(jsnap) if half else _unplaced(jsnap)
        ring = jax_refs[f"gloo {name} {shape}"]
        dense = _jax_dense(jsnap, a)
        np.testing.assert_array_equal(ring, dense)
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[name], ring,
                                          err_msg=f"{name}, rank {r}")
    assert sorted(tuple(o["coords"]) for o in outs) == sorted(
        (p, n) for p in range(shape[0]) for n in range(shape[1]))


FIELDS = ("assignment", "order", "commit_key", "chosen_score", "final_used")


@functools.lru_cache(maxsize=None)
def _jax_ring_engine(shape, mode) -> dict:
    """JAX's ring engine on `shape` in this process (the one-device
    mesh: no cross-device collective)."""
    mesh = jmake_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    eng = JEngine(JConfig(mode=mode, ring_counts=True), mesh=mesh)
    try:
        res = eng.solve(_jsnap(77))
    finally:
        eng.close()
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _assert_like_jax(got: dict, want: dict, what: str) -> None:
    for f in ("assignment", "order", "commit_key"):
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{what} {f}")
    np.testing.assert_allclose(
        np.nan_to_num(got["chosen_score"], neginf=-1.0),
        np.nan_to_num(want["chosen_score"], neginf=-1.0), rtol=1e-4,
        atol=1e-3, err_msg=f"{what} chosen_score")
    np.testing.assert_allclose(got["final_used"], want["final_used"],
                               rtol=1e-5, err_msg=f"{what} final_used")


def _by_mode(out: dict, mode: str) -> dict:
    return {k[len(mode) + 1:]: v for k, v in out.items()
            if k.startswith(mode + "_")}


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_gloo_ring_engine_equals_jax(tmp_path, shape):
    """Engine(ring_counts=True, mesh=...) on every rank of the mesh, in
    parity and fast mode, against JAX's ring engine on the same mesh
    shape (C1 tolerances for chosen and used). JAX's engine runs in a
    process of its own beside the ranks (tests/jax_ring_reference.py)."""
    *outs, jax_out = _run_ranks(tmp_path, shape, "engine", reference=True)
    for mode in ("parity", "fast"):
        want = _by_mode(jax_out, mode)
        assert (want["assignment"] >= 0).sum() > 20
        for r, out in enumerate(outs):
            _assert_like_jax(_by_mode(out, mode), want, f"{mode} rank {r}")


def _jax_tenants():
    """tests/test_tenants.py's eight tenants (its bucket floor)."""
    bk = JBuckets.fit(64, 16, 64, **worker.TENANT_BUCKETS)
    return [jsynth.make_cluster(np.random.default_rng(8800 + b), 20 + 5 * b,
                                10, buckets=bk, **worker.TENANT_MIX)[0]
            for b in range(worker.TENANTS)]


def test_gloo_solve_many_over_two_ranks(tmp_path, jax_refs):
    """solve_many split over a 2-rank mesh (four tenants a rank, then an
    all-gather): every rank's [B, ...] outputs equal the unsplit batch
    bit for bit, and JAX's solve_many with the tenant axis sharded over
    a (2, 1) mesh (tests/jax_ring_reference.py) in assignment, order and
    rounds."""
    outs = _run_ranks(tmp_path, (2, 1), "tenants")
    cfg = EngineConfig(mode="fast")
    whole = solve_many(cfg, worker.tenant_stack(), device="cpu")
    ja, jc, ju, jo, jr, jev = (jax_refs[f"tenants_{k}"] for k in (
        "a", "c", "u", "o", "rounds", "ev"))
    for r, out in enumerate(outs):
        for key, want in zip(("a", "c", "u", "o", "rounds", "ev"), whole):
            np.testing.assert_array_equal(out[key], want.numpy(),
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(out["a"], ja)
        np.testing.assert_array_equal(out["o"], jo)
        np.testing.assert_array_equal(out["rounds"], jr)
        np.testing.assert_array_equal(out["ev"], jev)
        np.testing.assert_allclose(out["u"], ju, rtol=1e-6)
        np.testing.assert_allclose(np.nan_to_num(out["c"], neginf=-1.0),
                                   np.nan_to_num(jc, neginf=-1.0), rtol=1e-5)
    assert (ja >= 0).sum() > 100


def test_solve_many_refuses_an_uneven_split():
    """B not a multiple of p: ValueError, as JAX's device_put of the
    tenant sharding raises (checked before any exchange)."""
    stacked = worker.tenant_stack().tenant(slice(0, 3))
    mesh = Mesh(shape={"p": 2, "n": 1}, ranks=np.arange(2).reshape(2, 1),
                rank=0, device=torch.device("cpu"), p_groups=())
    with pytest.raises(ValueError, match="multiple of p"):
        solve_many(EngineConfig(), stacked, mesh=mesh)
    jst = jtenants.stack_snapshots(_jax_tenants()[:3])
    jmesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
    with pytest.raises(ValueError):
        jax.device_put(jst, jtenants.tenant_sharding(jmesh, jst))


# -- the one-rank mesh engine ---------------------------------------------------


@pytest.fixture(scope="module")
def one_rank():
    jsnap = _jsnap(77)
    return jsnap, snapshot_from_numpy(jax.device_get(jsnap)), make_mesh(
        devices="cpu")


def _fields(res) -> dict:
    return {f: getattr(res, f) for f in ("assignment", "order", "commit_key",
                                          "chosen_score", "final_used",
                                          "evicted", "rounds",
                                          "host_reads")}


def _assert_same(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_one_rank_engine_solve(one_rank, mode):
    """The ring engine on a (1, 1) mesh: equal to the dense engine in
    every output, and to JAX's ring engine on make_mesh((1, 1))."""
    jsnap, tsnap, mesh = one_rank
    ring = Engine(EngineConfig(mode=mode, ring_counts=True), mesh=mesh)
    dense = Engine(EngineConfig(mode=mode), device="cpu")
    try:
        assert ring.device == torch.device("cpu") and ring.mesh is mesh
        got = _fields(ring.solve(tsnap))
        _assert_same(got, _fields(dense.solve(tsnap)), mode)
        _assert_like_jax(got, _jax_ring_engine((1, 1), mode), mode)
    finally:
        ring.close()
        dense.close()


def test_one_rank_score_topk_and_explained(one_rank):
    """ScoreBatch (score_topk) and the explained solve with its probe:
    the ring engine equal to the dense engine bit for bit, and to JAX's
    ring engine on a (1, 1) mesh (top-k indices exactly, scores at the
    JAX parity tolerance; the explained solve's placements exactly)."""
    jsnap, tsnap, mesh = one_rank
    jeng = JEngine(JConfig(mode="fast", ring_counts=True),
                   mesh=jmake_mesh((1, 1), devices=jax.devices()[:1]))
    ring = Engine(EngineConfig(mode="fast", ring_counts=True), mesh=mesh)
    dense = Engine(EngineConfig(mode="fast"), device="cpu")
    try:
        idx, val, _ = ring.score_topk(tsnap, 4)
        d_idx, d_val, _ = dense.score_topk(tsnap, 4)
        np.testing.assert_array_equal(idx, d_idx)
        np.testing.assert_array_equal(val, d_val)
        j_idx, j_val, _ = jeng.score_topk(jsnap, 4)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_allclose(val, j_val, rtol=1e-4, atol=1e-3)
        res, exd, probe = ring.solve_explained(tsnap, k=3)
        d_res, d_exd, d_probe = dense.solve_explained(tsnap, k=3)
        _assert_same(_fields(res), _fields(d_res), "explained")
        for f in ("rolled", "evictor", "evict_round", "auction_stats"):
            np.testing.assert_array_equal(getattr(exd, f), getattr(d_exd, f))
        for f in ("topk_idx", "topk_score", "topk_terms", "filter_counts"):
            np.testing.assert_array_equal(getattr(probe, f),
                                          getattr(d_probe, f), err_msg=f)
        j_res, _, j_probe = jeng.solve_explained(jsnap, k=3)
        for f in ("assignment", "order", "commit_key"):
            np.testing.assert_array_equal(getattr(res, f), getattr(j_res, f))
        np.testing.assert_array_equal(probe.topk_idx, j_probe.topk_idx)
    finally:
        jeng.close()
        ring.close()
        dense.close()


def test_one_rank_warm_rungs(one_rank):
    """A lineage on the mesh rank's device: the cold and warm rungs of
    the ring engine each equal a cold ring solve of the same state, and
    the dense engine's solve; the incremental rung raises, as JAX's."""
    _, _, mesh = one_rank
    cfg = EngineConfig(mode="fast", ring_counts=True)
    nodes, pods, running = worker.ring_records()
    ds = DeviceSnapshot(cfg, mesh=mesh)
    assert ds.device == torch.device("cpu")
    ds.full_load(nodes, pods, running)
    ring = Engine(cfg, mesh=mesh)
    dense = Engine(EngineConfig(mode="fast"), device="cpu")
    try:
        for cycle in range(3):
            res = ring.solve_warm(ds)
            want = _fields(ring.solve(ds.snap))
            _assert_same(_fields(res), want, f"cycle {cycle}")
            _assert_same(_fields(dense.solve(ds.snap)), want,
                         f"dense {cycle}")
            pods[cycle]["observed_avail"] = 0.3
            ds.apply(upsert_pods=[pods[cycle]])
        assert ds.warm_solves == 2 and ds.cold_solves == 1
        with pytest.raises(NotImplementedError, match="ring_counts"):
            ring.solve_warm(ds, incremental=True)
    finally:
        ring.close()
        dense.close()


def test_ring_counts_needs_a_mesh_and_its_device(one_rank):
    _, _, mesh = one_rank
    with pytest.raises(ValueError, match="mesh"):
        Engine(EngineConfig(ring_counts=True), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Engine(EngineConfig(ring_counts=True), device="cuda:0", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        DeviceSnapshot(EngineConfig(), device="cuda:0", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        solve_many(EngineConfig(), worker.tenant_stack(), device="cuda:0",
                   mesh=mesh)


# -- the auction's exact tableau --------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_tableau_nv_plain_equals_jax(seed):
    """The port's plain `_tableau_nv` against JAX's on the same victim
    table and auction state (earlier evictions, usage, priorities,
    requests; budgets under PDBs): all six outputs equal."""
    jsnap, tsnap = _jax_and_port(500 + seed, n_pods=60, n_nodes=24,
                                 pdb_frac=0.6)
    jctx = jpre.precompute_nv(JConfig(), jsnap, 16)
    tctx = tpre.precompute_nv(EngineConfig(), tsnap, 16)
    M = tsnap.running.valid.shape[0]
    N = tsnap.nodes.valid.shape[0]
    st = _auction_state(np.random.default_rng(seed), jsnap, M, N, 32)
    ev, used, _, prio, req = st[:5]
    want = jax.jit(lambda *a: jpre._tableau_nv(JConfig(), jsnap, jctx, *a))(
        *(jnp.asarray(x) for x in (prio, req, used, ev)))
    got = tpre._tableau_nv(EngineConfig(), tsnap, tctx, *(
        torch.from_numpy(x) for x in (prio, req, used, ev)))
    names = ("elig", "wcost", "wviol", "fits", "node_viol", "node_cost")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        g = g.numpy()
        if name == "wviol":
            assert g.dtype == np.int32
            g = g.astype(np.float32)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].any() and torch.isfinite(got[4]).any()
    if seed == 0:
        assert (got[2] > 0).any()
