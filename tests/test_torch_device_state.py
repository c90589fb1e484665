"""The port's device-resident lineage (`tpusched_torch/device_state.py`)
against the JAX package's (`tpusched/device_state.py`), after the cases
of tests/test_device_state.py: both lineages take the same record
stream, and after every `apply` every snapshot leaf is equal, and so
are the path, the rebuild reasons, the transfer counters and the bytes
shipped. Value-only churn must also equal a fresh build of the same
records (the port's builder); vocabulary growth must solve as a fresh
build does. Port lineages live on the CPU (`device="cpu"`)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from tpusched import EngineConfig as JConfig
from tpusched.config import Buckets as JBuckets
from tpusched.device_state import DeviceSnapshot as JDeviceSnapshot
from tpusched.divergence import warm_churn_stream as jax_churn_stream
from tpusched.synth import make_cluster as jax_make_cluster
from tpusched_torch import Engine, EngineConfig, SnapshotBuilder
from tpusched_torch.config import Buckets
from tpusched_torch.device_state import DeviceSnapshot
from tpusched_torch.synth import make_cluster, warm_churn_stream

from test_device_state import _records


def _leaves_equal(got, want, where: str = "") -> None:
    """Every leaf of the port tree equals the other tree's, NaN = NaN."""
    g_leaves = got.leaves()
    w_leaves = (want.leaves() if hasattr(want, "leaves")
                else jax.tree.leaves(want))
    assert len(g_leaves) == len(w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (where, i)
        eq = g == w
        if np.issubdtype(g.dtype, np.floating):
            eq = eq | (np.isnan(g) & np.isnan(w))
        assert eq.all(), f"{where}: leaf {i} differs"


class Twin:
    """A port lineage and a JAX lineage fed the same records."""

    def __init__(self, nodes, pods, running, buckets=None):
        jbk = None if buckets is None else JBuckets(**vars(buckets))
        self.port = DeviceSnapshot(EngineConfig(), buckets, device="cpu")
        self.jax = JDeviceSnapshot(JConfig(), jbk)
        a = self.port.full_load(nodes, pods, running)
        b = self.jax.full_load(nodes, pods, running)
        self.check(a, b, "full_load")

    def apply(self, **delta):
        a = self.port.apply(**delta)
        b = self.jax.apply(**delta)
        self.check(a, b, "apply")
        return a

    def check(self, a, b, where):
        assert (a.path, a.reason, a.reordered, a.rows_scattered,
                a.h2d_bytes, a.churn_records) == (
            b.path, b.reason, b.reordered, b.rows_scattered, b.h2d_bytes,
            b.churn_records), where
        p, j = self.port, self.jax
        _leaves_equal(p.snap, j.snap, where)
        for f in ("full_uploads", "delta_updates", "rebuilds",
                  "rebuild_reasons", "h2d_bytes_total", "h2d_bytes_last",
                  "full_bytes"):
            assert getattr(p, f) == getattr(j, f), (where, f)
        for f in ("node_names", "pod_names", "n_nodes", "n_pods",
                  "n_running", "group_names", "running_names"):
            assert getattr(p.meta, f) == getattr(j.meta, f), (where, f)
        assert vars(p.meta.buckets) == vars(j.meta.buckets), where


def _fresh_build(nodes, pods, running, buckets):
    """A from-scratch name-sorted build at the lineage's buckets."""
    b = SnapshotBuilder(EngineConfig(), buckets)
    for r in sorted(nodes, key=lambda r: r["name"]):
        b.add_node(**r)
    for r in sorted(pods, key=lambda r: r["name"]):
        b.add_pod(**r)
    for r in sorted(running, key=lambda r: r["name"]):
        b.add_running_pod(**{k: v for k, v in r.items() if k != "name"})
    return b.build()


@pytest.fixture
def loaded():
    nodes, pods, running = _records()
    return Twin(nodes, pods, running), nodes, pods, running


def test_value_churn_scatter_equals_rebuild(loaded):
    tw, nodes, pods, running = loaded
    pods[3]["priority"] = 777.0
    pods[8]["observed_avail"] = 0.42
    nodes[2]["allocatable"] = {"cpu": 5000.0, "memory": float(24 << 30)}
    running[1]["slack"] = 0.9
    stats = tw.apply(upsert_pods=[pods[3], pods[8]],
                     upsert_nodes=[nodes[2]], upsert_running=[running[1]])
    assert stats.path == "delta" and not stats.reordered
    snap, meta = _fresh_build(nodes, pods, running, tw.port.meta.buckets)
    _leaves_equal(tw.port.snap, snap, "fresh build")
    assert tw.port.meta.pod_names == meta.pod_names


def test_add_remove_reorder_equals_rebuild(loaded):
    tw, nodes, pods, running = loaded
    pods = [p for p in pods if p["name"] != "p04"]
    pods.append(dict(name="p03a", requests={"cpu": 150.0},
                     labels={"app": "web"}, observed_avail=1.0))
    running = [r for r in running if r["name"] != "r01"]
    running.append(dict(name="r00a", node="n03", requests={"cpu": 100.0},
                        labels={"app": "db"}, slack=0.2))
    nodes.append(dict(name="n01a",
                      allocatable={"cpu": 6000.0, "memory": float(16 << 30)},
                      labels={"zone": "b", "disktype": "ssd"}))
    stats = tw.apply(upsert_pods=[pods[-1]], remove_pods=["p04"],
                     upsert_running=[running[-1]], remove_running=["r01"],
                     upsert_nodes=[nodes[-1]])
    assert stats.path == "delta" and stats.reordered
    snap, meta = _fresh_build(nodes, pods, running, tw.port.meta.buckets)
    _leaves_equal(tw.port.snap, snap, "fresh build")
    run_nodes = tw.port.snap.running.node_idx.numpy()[:len(running)]
    by_name = {r["name"]: r for r in running}
    for m, rname in enumerate(sorted(by_name)):
        assert tw.port.meta.node_names[run_nodes[m]] == by_name[rname]["node"]


def test_vocab_append_stays_delta_and_solves_identically():
    nodes, pods, running = _records()
    floors = Buckets.fit(32, 16, 16, atoms=64, atom_values=8, terms=4,
                         term_atoms=4, signatures=16, pod_labels=8,
                         node_labels=16, spread_constraints=4,
                         affinity_terms=4, pref_terms=4)
    tw = Twin(nodes, pods, running, floors)
    pods[1]["labels"] = {"app": "brandnew-value"}
    pods[2]["node_selector"] = {"zone": "c"}
    stats = tw.apply(upsert_pods=[pods[1], pods[2]])
    assert stats.path == "delta", stats.reason
    snap, _ = _fresh_build(nodes, pods, running, tw.port.meta.buckets)
    eng = Engine(EngineConfig(mode="fast"), device="cpu")
    a, b = eng.solve(tw.port.snap), eng.solve(snap)
    eng.close()
    np.testing.assert_array_equal(a.assignment, b.assignment)
    np.testing.assert_array_equal(a.chosen_score, b.chosen_score)


def test_growth_falls_back_to_rebuild(loaded):
    tw, nodes, pods, running = loaded
    nodes[3]["taints"] = [("gpu", "true", "NoSchedule")]
    stats = tw.apply(upsert_nodes=[nodes[3]])
    assert stats.path == "rebuild" and stats.reason == "new_taint"
    many = [dict(name=f"q{i:03d}", requests={"cpu": 10.0},
                 observed_avail=1.0)
            for i in range(tw.port.meta.buckets.pods + 1)]
    stats = tw.apply(upsert_pods=many)
    assert stats.path == "rebuild" and stats.reason == "row_bucket"
    snap, _ = _fresh_build(nodes, pods + many, running,
                           tw.port.meta.buckets)
    _leaves_equal(tw.port.snap, snap, "fresh build")
    assert tw.port.rebuild_reasons == ["new_taint", "row_bucket"]


def test_steady_state_ships_no_full_snapshot(loaded):
    tw, nodes, pods, running = loaded
    full = tw.port.full_bytes
    rng = np.random.default_rng(1)
    for cycle in range(20):
        i = int(rng.integers(len(pods)))
        pods[i]["observed_avail"] = float(rng.uniform(0.5, 1.0))
        stats = tw.apply(upsert_pods=[pods[i]])
        assert stats.path == "delta"
        assert stats.h2d_bytes < full / 10, (cycle, stats.h2d_bytes, full)
    assert tw.port.full_uploads == 1 and tw.port.delta_updates == 20
    assert tw.port.rebuilds == 0


def test_group_and_pdb_membership_updates(loaded):
    tw, nodes, pods, running = loaded
    gang_pods = [p for p in pods if p.get("pod_group") == "gang-a"]
    gang_pods[0]["pod_group_min_member"] = 3
    tw.apply(upsert_pods=[gang_pods[0]])
    gi = tw.port._state.group_idx["gang-a"]
    assert int(tw.port.snap.group_min_member[gi]) == 3
    pods = [p for p in pods if p["name"] != gang_pods[0]["name"]]
    tw.apply(remove_pods=[gang_pods[0]["name"]])
    assert int(tw.port.snap.group_min_member[gi]) == 2
    pi = tw.port._state.pdb_idx[("default", "pdb-a")]
    assert float(tw.port.snap.pdb_allowed[pi]) == 1.0
    running = [r for r in running if r["name"] != "r00"]
    tw.apply(remove_running=["r00"])
    assert float(tw.port.snap.pdb_allowed[pi]) == 1.0
    snap, _ = _fresh_build(nodes, pods, running, tw.port.meta.buckets)
    eng = Engine(EngineConfig(mode="fast"), device="cpu")
    np.testing.assert_array_equal(eng.solve(tw.port.snap).assignment,
                                  eng.solve(snap).assignment)
    eng.close()


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_bucket_padding_invariance(mode):
    nodes, pods, running = _records(n_pods=10, n_nodes=4, n_running=3)
    small, _ = _fresh_build(nodes, pods, running, None)
    big, _ = _fresh_build(nodes, pods, running, Buckets.fit(64, 32, 32))
    eng = Engine(EngineConfig(mode=mode), device="cpu")
    a, b = eng.solve(small), eng.solve(big)
    eng.close()
    P = len(pods)
    np.testing.assert_array_equal(a.assignment[:P], b.assignment[:P])
    np.testing.assert_array_equal(a.chosen_score[:P], b.chosen_score[:P])


def test_running_pod_missing_node_raises(loaded):
    tw, nodes, pods, running = loaded
    for ds in (tw.port, tw.jax):
        with pytest.raises(ValueError, match="missing node"):
            ds.apply(upsert_running=[dict(name="rX", node="ghost",
                                          requests={"cpu": 1.0})])
    tw.check(tw.port.apply(), tw.jax.apply(), "empty apply")
    snap, _ = _fresh_build(nodes, pods, running, tw.port.meta.buckets)
    _leaves_equal(tw.port.snap, snap, "fresh build")


def test_lineage_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSnapshot(EngineConfig())


def _plain(x):
    """Records as plain values: dataclass specs by class name and
    fields (each package has its own spec classes)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _plain(dataclasses.astuple(x)))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_and_churn_stream_equal_the_jax_package(seed):
    """make_cluster(as_records=True) and warm_churn_stream draw as the
    JAX package's do: equal records, equal deltas, and a lineage fed
    them stays leaf-equal to the JAX lineage."""
    kw = dict(spread_frac=0.4, interpod_frac=0.4, run_anti_frac=0.2,
              namespace_count=2, pdb_frac=0.3, gang_frac=0.25, gang_size=2,
              taint_frac=0.2, toleration_frac=0.2, selector_frac=0.2,
              affinity_frac=0.2, cordon_frac=0.1)
    got = [list(r) for r in make_cluster(np.random.default_rng(seed), 30, 8,
                                         as_records=True, **kw)]
    want = [list(r) for r in jax_make_cluster(np.random.default_rng(seed),
                                              30, 8, as_records=True, **kw)]
    assert _plain(got) == _plain(want)
    tw = Twin(*got)
    deltas = warm_churn_stream(np.random.default_rng(seed + 9), *got, 8,
                               churn_frac=0.2, structural_every=3)
    jdeltas = jax_churn_stream(np.random.default_rng(seed + 9), *want, 8,
                               churn_frac=0.2, structural_every=3)
    n = 0
    for d, jd in zip(deltas, jdeltas):
        assert _plain(d) == _plain(jd)
        tw.apply(**d)
        n += 1
    assert n == 8 and _plain(got) == _plain(want)
