"""Fast mode of the port (`Engine(EngineConfig(mode="fast"))`, on the CPU,
where every kernel wrapper runs its plain version) held to the JAX
package's fast-mode contract (tpusched/oracle.py docstring,
tests/test_fast.py): every placement valid under
`validate_assignment` with the commit key, and a placed count near the
JAX fast engine's and the sequential oracle's. Where the JAX tests pin
identity (pods pinned to distinct nodes) the port must match exactly.

The placed-count margins are the JAX tests' own (2 pods). The oracle
margin is checked where the JAX fast engine itself meets it (plain
resource clusters, as tests/test_fast.py does); on constrained
clusters the fast dealer may place fewer than the sequential scan, in
JAX as in the port, and the contract is the margin to JAX."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched.oracle import Oracle, validate_assignment
from tpusched.snapshot import SnapshotBuilder as JBuilder
from tpusched_torch import Engine, EngineConfig
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.snapshot import snapshot_from_numpy


def solve_fast(jsnap, **cfg_kw):
    """(port result, JAX fast result, oracle result, JAX config)."""
    jcfg = JConfig(mode="fast", **cfg_kw)
    jeng = JEngine(jcfg)
    teng = Engine(EngineConfig(mode="fast", **cfg_kw), device="cpu")
    try:
        jres = jeng.solve(jsnap)
        tres = teng.solve(snapshot_from_numpy(jax.device_get(jsnap)))
    finally:
        jeng.close()
        teng.close()
    ores = Oracle(jsnap, JConfig(**cfg_kw)).solve()
    return tres, jres, ores, jcfg


def placed(res) -> int:
    return int((res.assignment >= 0).sum())


def check_contract(jsnap, tres, jres, jcfg):
    """Validity with the commit key, the JAX placed-count margin, and a
    consistent result layout (commit key = commit round, no eviction)."""
    violations = validate_assignment(jsnap, jcfg, tres.assignment,
                                     commit_key=tres.commit_key)
    assert violations == [], violations
    assert placed(tres) >= placed(jres) - 2, (placed(tres), placed(jres))
    hit = tres.assignment >= 0
    assert ((tres.commit_key >= 0) == hit).all()
    assert (tres.commit_key[hit] < tres.rounds).all()
    assert not tres.evicted.any()
    assert tres.host_reads > 0
    # Every placed pod's score is finite, every unplaced one -inf.
    assert np.isfinite(tres.chosen_score[hit]).all()
    assert np.isneginf(tres.chosen_score[~hit]).all()


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_valid_resources_only(tie_break):
    """tests/test_fast.py:26's cluster: valid, few rounds, and no fewer
    placements than JAX fast or the oracle (less 2)."""
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(0), 60, 12)
    tres, jres, ores, jcfg = solve_fast(jsnap, tie_break=tie_break,
                                        tie_seed=11)
    check_contract(jsnap, tres, jres, jcfg)
    assert tres.rounds < 20
    assert placed(tres) >= placed(ores) - 2


def test_fast_valid_overcommitted():
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(0), 64, 4,
                                   initial_utilization=0.7)
    tres, jres, _, jcfg = solve_fast(jsnap)
    check_contract(jsnap, tres, jres, jcfg)
    assert (tres.assignment == -1).any()


def test_fast_places_as_many_as_oracle():
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(0), 48, 12)
    tres, jres, ores, jcfg = solve_fast(jsnap)
    check_contract(jsnap, tres, jres, jcfg)
    assert placed(tres) >= placed(ores) - 2


def test_fast_matches_sequential_when_pinned():
    """tests/test_fast.py:62: pods pinned to distinct nodes cannot
    interact, so fast mode equals the oracle exactly."""
    b = JBuilder(JConfig(mode="fast"))
    for i in range(8):
        b.add_node(f"n{i}", {"cpu": 4000, "memory": 16 << 30},
                   labels={"slot": str(i)})
    for i in range(8):
        b.add_pod(f"p{i}", {"cpu": 500, "memory": 1 << 30},
                  node_selector={"slot": str(i)})
    jsnap, _ = b.build()
    tres, jres, ores, jcfg = solve_fast(jsnap)
    np.testing.assert_array_equal(tres.assignment, ores.assignment)
    np.testing.assert_array_equal(tres.assignment, jres.assignment)
    assert tres.rounds <= 3
    check_contract(jsnap, tres, jres, jcfg)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456])
def test_seeded_fast_uncontended_matches_oracle(seed):
    """tests/test_tiebreak.py:56: one pod on identical nodes commits
    exactly at the oracle's hash pick."""
    b = JBuilder(JConfig())
    for i in range(8):
        b.add_node(f"n{i}", {"cpu": 8000, "memory": 32 << 30})
    b.add_pod("p0", {"cpu": 100, "memory": 1 << 28})
    jsnap, _ = b.build()
    tres, jres, ores, jcfg = solve_fast(jsnap, tie_break="seeded",
                                        tie_seed=seed)
    np.testing.assert_array_equal(tres.assignment, ores.assignment)
    check_contract(jsnap, tres, jres, jcfg)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_fast_valid_fuzz(seed, tie_break):
    """tests/test_fast.py:43's draw sequence (the spread and inter-pod
    fractions are drawn and dropped: this slice refuses them), both
    tie-breaks."""
    rng = np.random.default_rng(2000 + seed)
    n_pods = int(rng.integers(10, 60))
    n_nodes = int(rng.integers(4, 20))
    kw = dict(taint_frac=float(rng.uniform(0, 0.5)),
              toleration_frac=float(rng.uniform(0, 0.5)),
              selector_frac=float(rng.uniform(0, 0.4)),
              affinity_frac=float(rng.uniform(0, 0.4)))
    rng.uniform(0, 0.5)  # spread_frac
    rng.uniform(0, 0.5)  # interpod_frac
    jsnap, _ = jsynth.make_cluster(rng, n_pods=n_pods, n_nodes=n_nodes,
                                   initial_utilization=0.4, **kw)
    tres, jres, _, jcfg = solve_fast(jsnap, tie_break=tie_break,
                                     tie_seed=seed)
    check_contract(jsnap, tres, jres, jcfg)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_tranche_path_valid(seed, tie_break, monkeypatch):
    """P > 2C: the full-width round 1, then tranches of C pods (here an
    explicit cap of 4, as the JAX function's `cap=` allows) with their
    spent marking and round cap. Held against the JAX function with the
    same cap: valid, near-equal placed count."""
    jsnap = jax.device_put(jsynth.make_cluster(
        np.random.default_rng(100 + seed), 60, 10,
        initial_utilization=0.3 + 0.1 * seed, taint_frac=0.2,
        toleration_frac=0.3, selector_frac=0.2)[0])
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jcfg = JConfig(mode="fast", tie_break=tie_break, tie_seed=5)
    tcfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=5)
    P = int(jsnap.pods.valid.shape[0])
    N = int(jsnap.nodes.valid.shape[0])
    jsat, jmem = jax_sat_tables(jsnap)
    jst = jassign.precompute_static(jcfg, jsnap, jsat, jmem)
    jorder = jassign.pop_order(jcfg, jsnap)
    jrank = jnp.zeros(P, jnp.int32).at[jorder].set(
        jnp.arange(P, dtype=jnp.int32))
    _, jasg, _, _, jrounds = jassign._solve_rounds_nosig(
        jcfg, jsnap, jst, jrank, jorder, 2 * P + 8,
        jassign._fallback_depth(N), cap=4)

    tranches = []
    top = tassign._top_by_rank
    monkeypatch.setattr(tassign, "_top_by_rank",
                        lambda *a: tranches.append(1) or top(*a))
    tst = tassign.precompute_static(tcfg, tsnap, _sat_tables(tsnap))
    torder = tassign.pop_order(tcfg, tsnap)
    trank = torch.zeros(P, dtype=torch.int32)
    trank[torder] = torch.arange(P, dtype=torch.int32)
    used, asg, chosen, round_of, rounds = tassign._solve_rounds_nosig(
        tcfg, tsnap, tst, trank, torder, 2 * P + 8,
        tassign._fallback_depth(N), cap=4)
    assert tranches, "the tranche path did not run"
    asg = asg.numpy()
    violations = validate_assignment(jsnap, jcfg, asg,
                                     commit_key=round_of.numpy())
    assert violations == [], violations
    jasg = np.asarray(jasg)
    assert (asg >= 0).sum() >= (jasg >= 0).sum() - 2
    # Capacity: the final usage is the initial one plus the placed
    # requests (f32 sums in another order: rtol 1e-5, as the parity
    # tests hold final_used).
    want = np.asarray(jsnap.nodes.used, np.float64).copy()
    req = np.asarray(jsnap.pods.requests, np.float64)
    for p in np.nonzero(asg >= 0)[0]:
        want[asg[p]] += req[p]
    np.testing.assert_allclose(used.numpy(), want, rtol=1e-5)
    assert rounds >= 2


def test_fast_rounds_bounded_by_max_rounds():
    """cfg.max_rounds caps the round count; pods still pending at the
    cap stay unassigned, and what was placed stays valid."""
    jsnap, _ = jsynth.make_cluster(np.random.default_rng(0), 64, 4,
                                   initial_utilization=0.5)
    tres, _, _, jcfg = solve_fast(jsnap, max_rounds=1)
    assert tres.rounds <= 1
    violations = validate_assignment(jsnap, jcfg, tres.assignment,
                                     commit_key=tres.commit_key)
    assert violations == [], violations


def test_fast_agreement_with_jax():
    """Assignment agreement with the JAX fast engine, as a share of
    pods, over contended clusters (tests/test_tiebreak.py:123's draws
    without the pairwise fractions), both tie-breaks. The contract asks
    only validity and the placed-count margin (checked too); on these
    clusters the share has been 1.0, and a fall below it is a
    divergence to record in ROADMAP queue C."""
    total = same = 0
    first_diff = None
    for s in range(10):
        for tie_break in ("first", "seeded"):
            rng = np.random.default_rng(50000 + s)
            jsnap, _ = jsynth.make_cluster(
                rng, n_pods=int(rng.integers(20, 60)),
                n_nodes=int(rng.integers(4, 12)),
                initial_utilization=float(rng.uniform(0.3, 0.7)),
                taint_frac=0.2, toleration_frac=0.3, selector_frac=0.2,
                affinity_frac=0.3)
            tres, jres, _, jcfg = solve_fast(jsnap, tie_break=tie_break,
                                             tie_seed=s)
            check_contract(jsnap, tres, jres, jcfg)
            n = int(np.asarray(jsnap.pods.valid).sum())
            eq = tres.assignment[:n] == jres.assignment[:n]
            total += n
            same += int(eq.sum())
            if first_diff is None and not eq.all():
                i = int(np.nonzero(~eq)[0][0])
                first_diff = (s, tie_break, i, int(jres.assignment[i]),
                              int(tres.assignment[i]))
    assert same == total, (f"agreement {same}/{total}; first difference "
                           f"(seed, tie_break, pod, jax, port): {first_diff}")
