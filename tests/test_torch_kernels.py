"""Each kernel's plain PyTorch version (what the kernel wrapper runs on a
CPU tensor) against the JAX function it ports, on the same numpy inputs.

Tolerances: the boolean tables and the cell-local f32 tables are exact
(integer-valued sums). The finalised static score is held at rtol 1e-6:
jnp's row max is exact, but XLA on the CPU may contract
`w_na*na + w_tt*tt` into a fused multiply-add, which eager torch never
does (the port matches the numpy oracle's rounding instead). The same
reason holds for the per-pod dynamic score."""

from __future__ import annotations

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
    tsat = _sat_tables(tsnap)
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
    tsat = _sat_tables(tsnap)
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
    snapshot's initial usage: feasibility exact, score to f32."""
    jsnap, tsnap = _pair(name)
    jcfg, tcfg = JConfig(), EngineConfig()
    jsat, jmem = jax_sat_tables(jsnap)
    jstatic = jassign.precompute_static(jcfg, jsnap, jsat, jmem)
    jst = jassign.kpair.pair_state_init(jsnap, jstatic.sig_match)
    tstatic = tassign.precompute_static(tcfg, tsnap, _sat_tables(tsnap))
    for p in range(int(np.asarray(jsnap.pods.valid).sum())):
        jf, js, _ = jassign.pod_cycle(jcfg, jsnap, jstatic, p,
                                      jsnap.nodes.used, jst)
        tf, ts = tassign.pod_cycle(tcfg, tsnap, tstatic, p,
                                      tsnap.nodes.used)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
