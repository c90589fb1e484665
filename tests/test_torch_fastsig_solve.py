"""Whole fast-mode solves with pairwise signatures in the port, on the
CPU (every kernel wrapper runs its plain version), held to the JAX
package's fast-mode contract (tpusched/oracle.py, tests/test_fast.py):
no violation under `validate_assignment` with the commit key, and at
least as many placements as the JAX fast engine less 2 (the JAX tests'
margin), with both tie-breaks.

The snapshots: tests/test_fast.py's fuzz seeds (:44) and its
self-affine first pod (:98), the pairwise shapes of
tests/test_parity.py:56-70, the fast cases of
tests/test_symmetric_anti.py and tests/test_namespace.py (hand-built
and fuzzed), and the config-3 snapshots of the pairwise slice.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.oracle import validate_assignment
from tpusched.snapshot import MatchExpression, PodAffinityTerm
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.snapshot import snapshot_from_numpy
from test_torch_pairwise import both_snaps


def _fast_fuzz(seed):
    """tests/test_fast.py:test_fast_valid_fuzz's draws."""
    rng = np.random.default_rng(2000 + seed)
    return jsynth.make_cluster(
        rng, n_pods=int(rng.integers(10, 60)),
        n_nodes=int(rng.integers(4, 20)),
        taint_frac=float(rng.uniform(0, 0.5)),
        toleration_frac=float(rng.uniform(0, 0.5)),
        selector_frac=float(rng.uniform(0, 0.4)),
        affinity_frac=float(rng.uniform(0, 0.4)),
        spread_frac=float(rng.uniform(0, 0.5)),
        interpod_frac=float(rng.uniform(0, 0.5)))[0]


def _anti_fuzz(seed):
    """tests/test_symmetric_anti.py:test_fast_valid_fuzz_with_running_anti."""
    rng = np.random.default_rng(8000 + seed)
    return jsynth.make_cluster(
        rng, n_pods=int(rng.integers(10, 50)),
        n_nodes=int(rng.integers(4, 16)),
        interpod_frac=float(rng.uniform(0, 0.5)),
        run_anti_frac=float(rng.uniform(0.1, 0.5)))[0]


def _self_affine():
    """tests/test_fast.py:test_fast_required_self_affinity_first_pod."""
    b = JBuilder(JConfig(mode="fast"))
    for i in range(4):
        b.add_node(f"n{i}", {"cpu": 4000, "memory": 16 << 30},
                   labels={"zone": "ab"[i % 2]})
    for i in range(3):
        b.add_pod(f"w{i}", {"cpu": 100, "memory": 1 << 28},
                  labels={"app": "w"},
                  pod_affinity=[PodAffinityTerm(
                      "zone", (MatchExpression("app", "In", ("w",)),))])
    return b.build()[0]


SNAPS = {f"fast_fuzz_{s}": (lambda s=s: _fast_fuzz(s)) for s in range(6)}
SNAPS.update({f"anti_fuzz_{s}": (lambda s=s: _anti_fuzz(s))
              for s in range(4)})
SNAPS["self_affine"] = _self_affine
# The pairwise slice's builders: test_parity's shapes (seed 0), the
# symmetric-anti and namespace cases, the namespace fuzz, config 3.
for _name in ("spread", "interpod", "kitchen_sink", "running_anti",
              "pending_anti_holder", "keyless_member_all_zero",
              "ns_own_scope", "ns_explicit", "ns_star", "ns_anti_other",
              "spread_other_ns", "spread_same_ns", "holder_scope",
              "fuzz_namespaces_0", "fuzz_namespaces_1", "fuzz_namespaces_2",
              "fuzz_namespaces_3", "config3", "config3_anti_ns_keyless"):
    SNAPS[_name] = lambda n=_name: both_snaps(n)[0]


def placed(res) -> int:
    return int((res.assignment >= 0).sum())


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("name", sorted(SNAPS))
def test_fast_solve_with_signatures_valid(name, tie_break):
    jsnap = SNAPS[name]()
    assert np.asarray(jsnap.sigs.valid).any()
    kw = dict(mode="fast", tie_break=tie_break, tie_seed=11)
    jcfg = JConfig(**kw)
    jeng = JEngine(jcfg)
    eng = Engine(EngineConfig(**kw), device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = eng.solve(snapshot_from_numpy(jax.device_get(jsnap)))
    finally:
        jeng.close()
        eng.close()
    viol = validate_assignment(jsnap, jcfg, tres.assignment,
                               commit_key=tres.commit_key)
    assert viol == [], viol
    assert placed(tres) >= placed(jres) - 2, (placed(tres), placed(jres))
    hit = tres.assignment >= 0
    assert ((tres.commit_key >= 0) == hit).all()
    assert (tres.commit_key[hit] < tres.rounds).all()
    assert np.isfinite(tres.chosen_score[hit]).all()
    assert np.isneginf(tres.chosen_score[~hit]).all()
    assert not tres.evicted.any()
    assert tres.host_reads > 0
    if name == "self_affine":
        # The first pod of a self-affine group places (the upstream
        # special case) and the others join its zone.
        zones = np.asarray(jsnap.nodes.domain)[:, 0]
        assert (tres.assignment[:3] >= 0).all()
        assert len(set(zones[tres.assignment[:3]].tolist())) == 1
