"""The port's snapshot builder and generator against the JAX package's:
the same records (the same seed) give the same arrays, leaf by leaf,
exactly — field names, dtypes, shapes and values."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from tpusched import synth as jsynth
from tpusched.config import Buckets as JBuckets
from tpusched.config import EngineConfig as JConfig
from tpusched.snapshot import (
    MatchExpression as JExpr,
    NodeSelectorTerm as JTerm,
    PreferredTerm as JPref,
    SnapshotBuilder as JBuilder,
    Toleration as JTol,
)
from tpusched_torch import synth as tsynth
from tpusched_torch.config import Buckets, EngineConfig
from tpusched_torch.snapshot import (
    MatchExpression,
    NodeSelectorTerm,
    PreferredTerm,
    SnapshotBuilder,
    Toleration,
    snapshot_from_numpy,
)


def jax_leaves(obj, prefix=""):
    """(path, numpy leaf) of a JAX snapshot (flax struct dataclasses)."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from jax_leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, np.asarray(obj)


def port_leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from port_leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, obj.numpy()


def assert_same_arrays(jsnap, tsnap):
    jl, tl = dict(jax_leaves(jsnap)), dict(port_leaves(tsnap))
    assert list(jl) == list(tl), "field trees differ"
    for path, want in jl.items():
        got = tl[path]
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)


GENERATOR_CASES = {
    "config1": (lambda m, rng: m.config1_kind_like(rng), 0),
    "config2_40x12": (
        lambda m, rng: m.config2_scale(rng, 40, 12, with_qos=True), 1),
    "config2_no_qos": (
        lambda m, rng: m.make_cluster(rng, 40, 12, with_qos=False), 2),
    "taints": (lambda m, rng: m.make_cluster(
        rng, 40, 12, taint_frac=0.5, toleration_frac=0.5), 3),
    "selectors_affinity": (lambda m, rng: m.make_cluster(
        rng, 40, 12, selector_frac=0.4, affinity_frac=0.4), 4),
    "cordon": (lambda m, rng: m.make_cluster(
        rng, 40, 12, cordon_frac=0.3, keyless_node_frac=0.3), 5),
    "mixed": (lambda m, rng: m.make_cluster(
        rng, 48, 16, taint_frac=0.3, toleration_frac=0.3, selector_frac=0.2,
        affinity_frac=0.3, cordon_frac=0.1, namespace_count=3), 6),
    "spread_frac_drawn_never_fires": (lambda m, rng: m.make_cluster(
        rng, 20, 6, spread_frac=0.0, interpod_frac=0.0, gang_frac=0.0), 7),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generator_arrays_equal_jax(case):
    gen, seed = GENERATOR_CASES[case]
    jsnap, jmeta = gen(jsynth, np.random.default_rng(seed))
    tsnap, tmeta = gen(tsynth, np.random.default_rng(seed))
    assert_same_arrays(jsnap, tsnap)
    assert (dataclasses.asdict(tmeta.buckets)
            == dataclasses.asdict(jmeta.buckets))
    assert tmeta.node_names == jmeta.node_names
    assert tmeta.pod_names == jmeta.pod_names


def _hand_cluster(mod_expr, mod_term, mod_pref, mod_tol, builder):
    """Numeric labels with Gt/Lt, every operator, NoExecute and
    PreferNoSchedule taints, the unschedulable toleration, explicit
    node usage: the builder paths the generator does not reach."""
    b = builder
    for i in range(6):
        b.add_node(f"n{i}", {"cpu": 4000.0 * (i + 1), "memory": float(8 << 30)},
                   labels={"gen": str(i), "disk": "ssd" if i % 2 else "hdd",
                           "odd": "x" if i % 3 == 0 else "y"},
                   taints=[("t", "v", "NoExecute")] if i == 1 else
                   [("soft", "1", "PreferNoSchedule")] if i == 2 else [],
                   used={"cpu": 100.0 * i}, unschedulable=(i == 5))
    b.add_running_pod("n0", {"cpu": 500.0, "memory": float(1 << 28)},
                      labels={"app": "db"}, namespace="ops")
    b.add_pod("p0", {"cpu": 100.0}, required_terms=[mod_term((
        mod_expr("gen", "Gt", ("2",)), mod_expr("disk", "In", ("ssd",))))])
    b.add_pod("p1", {"cpu": 100.0}, node_selector={"odd": "y", "disk": "hdd"},
              preferred_terms=[mod_pref(10.0, mod_term(
                  (mod_expr("gen", "Lt", ("4",)),))),
                  mod_pref(5.0, mod_term((mod_expr("odd", "Exists"),)))])
    b.add_pod("p2", {"cpu": 100.0}, required_terms=[
        mod_term((mod_expr("odd", "NotIn", ("x",)),)),
        mod_term((mod_expr("missing", "DoesNotExist"),))],
        tolerations=[mod_tol("t", "Exists"),
                     mod_tol("node.kubernetes.io/unschedulable", "Exists",
                             effect="NoSchedule")])
    b.add_pod("p3", {"cpu": 100.0, "memory": 1.0}, priority=5.0,
              slo_target=0.99, observed_avail=0.5, labels={"app": "web"},
              tolerations=[mod_tol("", "Exists")], namespace="ops")
    return b.build()


def test_builder_arrays_equal_jax():
    jsnap, _ = _hand_cluster(JExpr, JTerm, JPref, JTol,
                             JBuilder(JConfig()))
    tsnap, _ = _hand_cluster(MatchExpression, NodeSelectorTerm,
                             PreferredTerm, Toleration,
                             SnapshotBuilder(EngineConfig()))
    assert_same_arrays(jsnap, tsnap)
    assert jsnap.atoms.key.shape[0] > 0
    assert np.isfinite(np.asarray(jsnap.nodes.label_nums)).any()


def test_snapshot_from_numpy_round_trips_jax_snapshot():
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(11), 30, 10,
                                   taint_frac=0.4, toleration_frac=0.4,
                                   affinity_frac=0.4)
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    assert_same_arrays(jsnap, tsnap)
    # Moving to a device and back keeps every leaf.
    assert_same_arrays(jsnap, tsnap.to("cpu"))


@pytest.mark.parametrize("kw", [dict(gang_frac=1.0), dict(pdb_frac=1.0)])
def test_generator_refuses_unported_features(kw):
    """The gang and budget draws, refused until ROADMAP A7 and A8a were
    ported, now build: the same seed gives the JAX generator's arrays,
    with the G or GP axis filled."""
    jsnap, jmeta = jsynth.make_cluster(np.random.default_rng(0), 8, 4, **kw)
    tsnap, tmeta = tsynth.make_cluster(np.random.default_rng(0), 8, 4, **kw)
    assert_same_arrays(jsnap, tsnap)
    assert tmeta.group_names == jmeta.group_names
    filled = (tsnap.group_min_member if "gang_frac" in kw
              else tsnap.pdb_allowed)
    assert filled.shape[0] > 0


def test_builder_refuses_unported_features():
    """Gang and budget records, refused until ROADMAP A7 and A8a, now
    give the JAX builder's arrays: groups in sorted name order at their
    largest min_member, budgets keyed by (namespace, name) at their
    largest allowance."""
    def build(b):
        for n in ("n0", "n1"):
            b.add_node(n, {"cpu": 4000.0, "memory": float(8 << 30)})
        b.add_pod("p0", {"cpu": 1.0}, pod_group="g", pod_group_min_member=2)
        b.add_pod("p1", {"cpu": 1.0}, pod_group="a", pod_group_min_member=1)
        b.add_pod("p2", {"cpu": 1.0}, pod_group="g", pod_group_min_member=3)
        b.add_running_pod("n0", {"cpu": 1.0}, pdb_group="budget",
                          pdb_disruptions_allowed=1)
        b.add_running_pod("n1", {"cpu": 1.0}, pdb_group="budget",
                          pdb_disruptions_allowed=2, namespace="other")
        b.add_running_pod("n1", {"cpu": 1.0}, pdb_group="budget")
        return b.build()

    jsnap, jmeta = build(JBuilder(JConfig()))
    tsnap, tmeta = build(SnapshotBuilder(EngineConfig()))
    assert_same_arrays(jsnap, tsnap)
    assert tmeta.group_names == jmeta.group_names == ["a", "g"]
    assert tsnap.group_min_member.tolist() == [1, 3]
    assert tsnap.running.pdb_group[:3].tolist() == [0, 1, 0]
    assert tsnap.pdb_allowed.tolist() == [1.0, 2.0]


CONFIG_DICTS = [
    {},
    {"mode": "parity", "tie_break": "seeded", "tie_seed": 7,
     "weights": {"least_requested": 2.0, "node_affinity": 0.5},
     "qos": {"qos_gain": 500.0, "urgency_reweight": False},
     "score_resource_weights": {"cpu": 1.0, "memory": 3.0}},
    {"resources": ["cpu", "memory", "pods", "gpu"], "mesh_shape": [1, 1]},
]


@pytest.mark.parametrize("d", CONFIG_DICTS)
def test_config_from_dict_matches_jax(d):
    """One config dict drives both engines to the same settings."""
    got = dataclasses.asdict(EngineConfig.from_dict(d))
    want = dataclasses.asdict(JConfig.from_dict(d))
    assert got == want
    assert (EngineConfig.from_dict(d).score_weights_vector()
            == JConfig.from_dict(d).score_weights_vector())


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="typo"):
        EngineConfig.from_dict({"typo": 1})


@pytest.mark.parametrize("counts", [(1, 1, 0), (100, 10, 20), (3000, 1500, 9),
                                    (10_000, 5_000, 5_000)])
def test_buckets_match_jax(counts):
    for name in ("fit", "minimal"):
        got = getattr(Buckets, name)(*counts)
        want = getattr(JBuckets, name)(*counts)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    d = dataclasses.asdict(JBuckets.fit(*counts))
    assert dataclasses.asdict(Buckets.from_dict(d)) == d
