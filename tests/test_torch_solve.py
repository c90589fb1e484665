"""The slice as a whole: the port's parity `Engine.solve` (on the CPU,
where every kernel wrapper runs its plain version) against the JAX
package's parity engine and its numpy oracle, on clusters the two
generators build from the same seed.

`assignment` and `order` must be exact. `final_used` (rtol 1e-5) and
`chosen_score` (rtol 1e-4, atol 1e-3) use the tolerances the JAX
package's own parity tests hold its engine to against the oracle
(tests/test_parity.py): XLA on the CPU may contract multiply-adds that
the oracle and the port round separately."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.oracle import Oracle
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig, SnapshotBuilder
from tpusched_torch import synth as tsynth
from tpusched_torch.snapshot import snapshot_from_numpy


def solve_both(gen, seed, **cfg_kw):
    """(port result, JAX engine result, oracle result) on the same
    cluster: the port builds it with its own generator."""
    jsnap, _ = gen(jsynth, np.random.default_rng(seed))
    tsnap, _ = gen(tsynth, np.random.default_rng(seed))
    jcfg, tcfg = JConfig(**cfg_kw), EngineConfig(**cfg_kw)
    jeng = JEngine(jcfg)
    teng = Engine(tcfg, device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = teng.solve(tsnap)
    finally:
        jeng.close()
        teng.close()
    return tres, jres, Oracle(jsnap, jcfg).solve()


def assert_parity(tres, jres, ores):
    np.testing.assert_array_equal(tres.assignment, jres.assignment,
                                  err_msg="placements diverge from JAX")
    np.testing.assert_array_equal(tres.assignment, ores.assignment,
                                  err_msg="placements diverge from oracle")
    np.testing.assert_array_equal(tres.order, jres.order)
    n = len(ores.order)
    np.testing.assert_array_equal(tres.order[:n], ores.order)
    np.testing.assert_allclose(tres.final_used, jres.final_used, rtol=1e-5)
    np.testing.assert_allclose(tres.final_used, ores.final_used, rtol=1e-5)
    both = np.isfinite(ores.chosen_score)
    np.testing.assert_array_equal(np.isfinite(tres.chosen_score), both)
    np.testing.assert_allclose(tres.chosen_score[both],
                               jres.chosen_score[both], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tres.chosen_score[both],
                               ores.chosen_score[both], rtol=1e-4, atol=1e-3)
    # Parity layout: commit key = rank in pop order, rounds = P, no
    # eviction without preemption.
    P = tres.assignment.shape[0]
    np.testing.assert_array_equal(tres.commit_key, jres.commit_key)
    assert tres.rounds == jres.rounds == P
    np.testing.assert_array_equal(tres.evicted, jres.evicted)
    assert not tres.evicted.any()


# tests/test_parity.py:36-51, restricted to what this slice covers.
CASES = {
    "resources_only": lambda m, rng: m.make_cluster(rng, 40, 12,
                                                    with_qos=False),
    "qos": lambda m, rng: m.make_cluster(rng, 40, 12, with_qos=True),
    "taints_tolerations": lambda m, rng: m.make_cluster(
        rng, 40, 12, taint_frac=0.5, toleration_frac=0.5),
    "selectors_affinity": lambda m, rng: m.make_cluster(
        rng, 40, 12, selector_frac=0.4, affinity_frac=0.4),
    "cordon_mix": lambda m, rng: m.make_cluster(
        rng, 48, 16, taint_frac=0.3, toleration_frac=0.3,
        selector_frac=0.2, affinity_frac=0.3, cordon_frac=0.2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_cases(case):
    assert_parity(*solve_both(CASES[case], 0))


def _fuzz(seed):
    """tests/test_parity.py:75's draw sequence; the spread and inter-pod
    fractions are drawn (so the generator's stream is the same) and
    then dropped, since this slice refuses them."""
    def gen(m, rng):
        n_pods = int(rng.integers(5, 60))
        n_nodes = int(rng.integers(3, 24))
        kw = dict(
            initial_utilization=float(rng.uniform(0.1, 0.6)),
            taint_frac=float(rng.uniform(0, 0.5)),
            toleration_frac=float(rng.uniform(0, 0.5)),
            selector_frac=float(rng.uniform(0, 0.4)),
            affinity_frac=float(rng.uniform(0, 0.4)),
        )
        rng.uniform(0, 0.4)  # spread_frac
        rng.uniform(0, 0.4)  # interpod_frac
        return m.make_cluster(rng, n_pods=n_pods, n_nodes=n_nodes, **kw)
    return gen


@pytest.mark.parametrize("seed", range(8))
def test_parity_fuzz(seed):
    assert_parity(*solve_both(_fuzz(seed), 1000 + seed))


def test_parity_overcommitted_cluster():
    tres, jres, ores = solve_both(
        lambda m, rng: m.make_cluster(rng, 64, 4, initial_utilization=0.7), 0)
    assert (ores.assignment == -1).any()
    assert_parity(tres, jres, ores)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456])
def test_seeded_tiebreak_identical_nodes(seed):
    """Identical nodes: every node ties, and the seeded pick must be the
    JAX engine's and the oracle's for any seed."""
    def gen(m, rng):
        b = (JBuilder(JConfig()) if m is jsynth
             else SnapshotBuilder(EngineConfig()))
        for i in range(8):
            b.add_node(f"n{i}", {"cpu": 8000, "memory": 32 << 30})
        for i in range(4):
            b.add_pod(f"p{i}", {"cpu": 100, "memory": 1 << 28})
        return b.build()
    tres, jres, ores = solve_both(gen, 0, tie_break="seeded", tie_seed=seed)
    assert_parity(tres, jres, ores)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_tiebreak_fuzz(seed):
    """tests/test_tiebreak.py:105's clusters without the pairwise
    fractions this slice refuses."""
    def gen(m, rng):
        return m.make_cluster(rng, int(rng.integers(10, 40)),
                              int(rng.integers(4, 12)), taint_frac=0.3,
                              toleration_frac=0.3)
    assert_parity(*solve_both(gen, 31000 + seed, tie_break="seeded",
                              tie_seed=42 + seed))


@pytest.mark.parametrize("kw", [dict(spread_frac=0.6),
                                dict(interpod_frac=0.6),
                                dict(gang_frac=1.0)])
def test_unported_snapshot_raises(kw):
    """A spread, inter-pod or gang snapshot (built by the JAX package and
    carried across) is refused in both modes, not solved without its
    constraints."""
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(2), 16, 6, **kw)
    for mode in ("parity", "fast"):
        eng = Engine(EngineConfig(mode=mode), device="cpu")
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP A[67]"):
                eng.solve(snapshot_from_numpy(jax.device_get(jsnap)))
        finally:
            eng.close()


def test_preemption_raises():
    tsnap, _ = tsynth.make_cluster(np.random.default_rng(0), 8, 4)
    eng = Engine(EngineConfig(preemption=True), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            eng.solve(tsnap)
    finally:
        eng.close()
