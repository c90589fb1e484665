"""The multi-tenant batch of the port (`tpusched_torch.tenants`) on the
CPU, where every kernel wrapper runs its plain version.

`solve_many` over stacked snapshots is held to
  * the port's own solo `Engine.solve` of each tenant, bit for bit in all
    six outputs, in both modes and both tie-breaks (the batch's
    contract);
  * the JAX package's `solve_many` on the same snapshots: in parity mode
    assignment, order, used, evicted and rounds exactly and chosen
    within the JAX package's parity tolerance (rtol 1e-4, atol 1e-3:
    XLA contracts the score's multiply-adds on the CPU, ROADMAP C1); in
    fast mode, after the port's solo solve of each tenant is shown equal
    to JAX's, assignment and rounds exactly and used within rtol 1e-6
    (the commit adds' order, ROADMAP C6);
and the tranche loop, uneven tenants (one with no valid pod, one with
no placeable pod, tenants that finish at different rounds), the
ring_counts refusal, stacking, `zipf_weights` and the moved plain
versions of the dealing (K23) and the tranche pick (K24).

With pairwise signatures and gangs (configs 3-4) the batch is held to
  * each tenant's solo solve, bit for bit in all six outputs, in both
    modes and both tie-breaks, for spread / inter-pod tenants, gang
    tenants (one rolling groups back, one rolling none) and gang tenants
    with spread and inter-pod terms;
  * the JAX package's `solve_many` on its own tenant shape
    (tests/test_tenants.py: three make_cluster tenants with spread and
    inter-pod terms under a 16-signature floor): parity assignment,
    order, used and evicted exactly, chosen at rtol 1e-4 / atol 1e-3;
    fast assignment and rounds exactly, used at rtol 1e-6;
  * JAX's signature rounds at compact_cap = 4 with tenants that hand
    off to the compacted rounds at different rounds, the batch reading
    one flag vector a loop step.

With preemption and PodDisruptionBudgets (config 5) the batch is held to
  * each tenant's solo solve, bit for bit in all six outputs, in both
    modes (and both tie-breaks without signatures), with and without
    signatures, with gangs (whose members never preempt), and for
    uneven tenants (no valid running pod, spent budgets, a tenant with
    nothing to preempt; per-tenant round caps);
  * the JAX package's `solve_many` on the two probed shapes: parity
    assignment, order, evicted and rounds exactly, chosen at rtol 1e-4
    / atol 1e-3 (ROADMAP C1), used at rtol 1e-5; fast, after each solo
    solve is shown equal to JAX's, assignment, evicted and rounds
    exactly and used at rtol 1e-6 (ROADMAP C6);
and the batched victim tables, thresholds and budget gate equal their
solo calls tenant by tenant.

Tenants are built under one explicit `Buckets` floor; the signature
bucket, not the count of real signatures, decides the path (the
configs 1-2 cases set signatures=0).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpusched import Engine as JEngine
from tpusched import synth as jsynth
from tpusched import tenants as jtenants
from tpusched.config import Buckets as JBuckets
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jax_sat_tables
from tpusched.kernels import assign as jassign
from tpusched_torch import Engine, EngineConfig, solve_many, stack_snapshots
from tpusched_torch import synth as tsynth
from tpusched_torch import tenants as ttenants
from tpusched_torch.config import Buckets
from tpusched_torch.engine import _sat_tables
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import preempt as tpre
from tpusched_torch.snapshot import snapshot_from_numpy

MIX = dict(taint_frac=0.3, toleration_frac=0.3, affinity_frac=0.3,
           selector_frac=0.3, cordon_frac=0.1)
# Tenant b: 20 + 4b pods on 10 + 2b nodes, seeds 700 + b.
SIZES = [(20, 10), (24, 12), (28, 14), (30, 16)]


def _floor(metas, cls=Buckets, **fixed):
    """The elementwise max of the tenants' own buckets (with the `fixed`
    fields): one floor every tenant fits."""
    fl = {}
    for m in metas:
        for f, v in dataclasses.asdict(m.buckets).items():
            fl[f] = max(fl.get(f, 0), v)
    fl.update(fixed)
    return cls(**fl)


def _port_tenants(n=3, seed=700, **kw):
    kw = dict(MIX, **kw)
    draw = lambda b, **x: tsynth.make_cluster(  # noqa: E731
        np.random.default_rng(seed + b), *SIZES[b], **kw, **x)
    floor = _floor([draw(b)[1] for b in range(n)], signatures=0)
    return [draw(b, buckets=floor)[0] for b in range(n)]


def _jax_tenants(n=3, seed=700):
    draw = lambda b, **x: jsynth.make_cluster(  # noqa: E731
        np.random.default_rng(seed + b), *SIZES[b], **MIX, **x)
    floor = _floor([draw(b)[1] for b in range(n)], JBuckets, signatures=0)
    return [jax.device_put(draw(b, buckets=floor)[0]) for b in range(n)]


def _np(out):
    return [t.numpy() for t in out]


def _solo_equal(cfg, snaps, out):
    """Every tenant of solve_many's output is the port's solo solve of
    its snapshot, bit for bit; returns the solo results."""
    a, c, u, o, rounds, ev = _np(out)
    eng = Engine(cfg, device="cpu")
    solos = []
    for b, snap in enumerate(snaps):
        res = eng.solve(snap)
        np.testing.assert_array_equal(a[b], res.assignment, f"tenant {b}")
        np.testing.assert_array_equal(c[b], res.chosen_score, f"tenant {b}")
        np.testing.assert_array_equal(u[b], res.final_used, f"tenant {b}")
        np.testing.assert_array_equal(o[b], res.order, f"tenant {b}")
        np.testing.assert_array_equal(ev[b], res.evicted, f"tenant {b}")
        assert int(rounds[b]) == res.rounds, (b, int(rounds[b]), res.rounds)
        solos.append(res)
    eng.close()
    return solos


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_batch_equals_solo_solves(mode, tie_break):
    """Four tenants of different sizes under one floor: each is its solo
    solve, bit for bit; a fast batch reads one flag a loop step for all
    tenants, so it reads no more than the solo solves together."""
    cfg = EngineConfig(mode=mode, tie_break=tie_break, tie_seed=11)
    snaps = _port_tenants(4)
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    solos = _solo_equal(cfg, snaps, out)
    assert stats.host_reads <= sum(r.host_reads for r in solos)
    if mode == "fast":
        assert stats.host_reads >= max(r.host_reads for r in solos)


def _jax_batch(jcfg, jsnaps):
    stacked = jtenants.stack_snapshots(jsnaps)
    return [np.asarray(x) for x in jtenants.solve_many_jit(jcfg)(stacked)]


def test_parity_batch_matches_jax():
    jcfg = JConfig(mode="parity")
    jsnaps = _jax_tenants(3)
    ja, jc, ju, jo, jr, jev = _jax_batch(jcfg, jsnaps)
    cfg = EngineConfig(mode="parity")
    out = solve_many(cfg, stack_snapshots([jax.device_get(s)
                                           for s in jsnaps]), device="cpu")
    a, c, u, o, rounds, ev = _np(out)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(rounds, jr)
    np.testing.assert_allclose(np.nan_to_num(c, neginf=-1.0),
                               np.nan_to_num(jc, neginf=-1.0),
                               rtol=1e-4, atol=1e-3)


def test_fast_batch_matches_jax():
    jcfg = JConfig(mode="fast")
    jsnaps = _jax_tenants(3)
    jeng = JEngine(jcfg)
    teng = Engine(EngineConfig(mode="fast"), device="cpu")
    try:
        for b, js in enumerate(jsnaps):
            jres = jeng.solve(js)
            tres = teng.solve(snapshot_from_numpy(jax.device_get(js)))
            np.testing.assert_array_equal(tres.assignment, jres.assignment,
                                          f"solo tenant {b}")
    finally:
        jeng.close()
        teng.close()
    ja, _, ju, _, jr, _ = _jax_batch(jcfg, jsnaps)
    out = solve_many(EngineConfig(mode="fast"),
                     stack_snapshots([jax.device_get(s) for s in jsnaps]),
                     device="cpu")
    a, _, u, _, rounds, _ = _np(out)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(rounds, jr)
    np.testing.assert_allclose(u, ju, rtol=1e-6)


def _rounds_inputs(cfg, snap):
    static = tassign.precompute_static(cfg, snap, _sat_tables(snap)[0])
    order = tassign.pop_order(cfg, snap)
    return static, order, tassign._rank_of(order)


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
def test_tranches_batch_equals_solo_and_jax(tie_break):
    """P > cap: round 1, then tranches of 8 pods (K24's pick) with their
    spent marking, over three tenants at once. Each tenant equals its
    solo rounds bit for bit, and JAX's `_solve_rounds_nosig(cap=8)` in
    assignment and rounds."""
    cfg = EngineConfig(mode="fast", tie_break=tie_break, tie_seed=3)
    jcfg = JConfig(mode="fast", tie_break=tie_break, tie_seed=3)
    jsnaps = _jax_tenants(3)
    snaps = [snapshot_from_numpy(jax.device_get(s)) for s in jsnaps]
    stacked = stack_snapshots(snaps)
    P = snaps[0].pods.valid.shape[0]
    N = snaps[0].nodes.valid.shape[0]
    K = tassign._fallback_depth(N)
    static, order, rank = _rounds_inputs(cfg, stacked)
    used, asg, chosen, rnd, rounds = tassign._solve_rounds_nosig(
        cfg, stacked, static, rank, order, 2 * P + 8, K, cap=8)
    for b, (snap, js) in enumerate(zip(snaps, jsnaps)):
        s_static, s_order, s_rank = _rounds_inputs(cfg, snap)
        solo = tassign._solve_rounds_nosig(cfg, snap, s_static, s_rank,
                                           s_order, 2 * P + 8, K, cap=8)
        for got, want in zip((used[b], asg[b], chosen[b], rnd[b]), solo):
            assert torch.equal(got, want), f"tenant {b}"
        assert int(rounds[b]) == solo[4]
        jst = jassign.precompute_static(jcfg, js, *jax_sat_tables(js))
        jorder = jassign.pop_order(jcfg, js)
        jrank = jax.numpy.zeros(P, jax.numpy.int32).at[jorder].set(
            jax.numpy.arange(P, dtype=jax.numpy.int32))
        _, jasg, _, _, jrounds = jassign._solve_rounds_nosig(
            jcfg, js, jst, jrank, jorder, 2 * P + 8, K, cap=8)
        np.testing.assert_array_equal(asg[b].numpy(), np.asarray(jasg),
                                      f"tenant {b} against JAX")
        assert int(rounds[b]) == int(jrounds)


def _uneven():
    """Tenants that end at different rounds: two contended ones (half
    full at the start), one with no valid pod and one whose pods fit
    nowhere (no allocatable)."""
    base = _port_tenants(4, initial_utilization=0.5)
    none = dataclasses.replace(base[1], pods=dataclasses.replace(
        base[1].pods, valid=torch.zeros_like(base[1].pods.valid)))
    full = dataclasses.replace(base[2], nodes=dataclasses.replace(
        base[2].nodes, allocatable=torch.zeros_like(
            base[2].nodes.allocatable)))
    return [base[0], none, full, base[3]]


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_uneven_tenants_keep_their_state(mode):
    """A tenant with no valid pod and one with no placeable pod finish at
    once; the others run on. Every tenant is still its solo solve in all
    six outputs, its round counter included, so a finished tenant's
    state did not move while the loop ran for the others."""
    cfg = EngineConfig(mode=mode)
    snaps = _uneven()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu")
    solos = _solo_equal(cfg, snaps, out)
    assert (out[0][1] == -1).all() and (out[0][2] == -1).all()
    if mode == "fast":
        rounds = [r.rounds for r in solos]
        assert rounds[1] == rounds[2] == 1 and max(rounds) > 1, rounds


def test_uneven_tranches_freeze_finished_tenants():
    """The tranche loop with a cap of 4: tenants whose loop ends early
    keep their assignment, spent marks and round counter while the
    others take more tranches (each equals its solo rounds)."""
    cfg = EngineConfig(mode="fast")
    snaps = _uneven()
    stacked = stack_snapshots(snaps)
    P = snaps[0].pods.valid.shape[0]
    K = tassign._fallback_depth(snaps[0].nodes.valid.shape[0])
    static, order, rank = _rounds_inputs(cfg, stacked)
    stats = tassign.RoundStats()
    out = tassign._solve_rounds_nosig(cfg, stacked, static, rank, order,
                                      2 * P + 8, K, cap=4, stats=stats)
    solo_reads = 0
    for b, snap in enumerate(snaps):
        s_static, s_order, s_rank = _rounds_inputs(cfg, snap)
        s_stats = tassign.RoundStats()
        solo = tassign._solve_rounds_nosig(cfg, snap, s_static, s_rank,
                                           s_order, 2 * P + 8, K, cap=4,
                                           stats=s_stats)
        solo_reads = max(solo_reads, s_stats.host_reads)
        for got, want in zip(out[:4], solo[:4]):
            assert torch.equal(got[b], want), f"tenant {b}"
        assert int(out[4][b]) == solo[4]
    assert len(set(out[4].tolist())) > 2, out[4]
    assert stats.host_reads >= solo_reads


@pytest.mark.parametrize("what", ["ring_counts"])
def test_refusals(what):
    snaps = _port_tenants(2)
    with pytest.raises(NotImplementedError, match="no ring to run"):
        solve_many(EngineConfig(**{what: True}), stack_snapshots(snaps),
                   device="cpu")


# -- pairwise signatures and gangs (configs 3-4) ------------------------------

# JAX's own tenant shape (tests/test_tenants.py:19-36).
JBK = dict(atoms=16, signatures=16, taint_vocab=8, topo_keys=4,
           node_labels=8, pod_labels=4, sig_namespaces=2, term_atoms=4)


def _jax_shape_tenants():
    bk = JBuckets.fit(64, 16, 64, **JBK)
    return [jsynth.make_cluster(
        np.random.default_rng(8800 + b), 20 + b * 5, 10, buckets=bk,
        spread_frac=0.3, interpod_frac=0.3, taint_frac=0.2,
        toleration_frac=0.3)[0] for b in range(3)]


def _floored(draw, n, cls=Buckets):
    """n tenants drawn twice: on their own buckets, then under the
    elementwise max of those (signatures included)."""
    floor = _floor([draw(b)[1] for b in range(n)], cls)
    return [draw(b, buckets=floor)[0] for b in range(n)]


def _pair_tenants():
    """Spread and inter-pod tenants of uneven size, some with running
    anti-affinity holders and namespace scopes."""
    return _floored(lambda b, **x: tsynth.make_cluster(
        np.random.default_rng(900 + b), 20 + 5 * b, 10, spread_frac=0.3,
        interpod_frac=0.3, taint_frac=0.2, toleration_frac=0.3,
        run_anti_frac=0.2 * (b % 2), namespace_count=1 + b, **x), 3)


# (groups, gang size, nodes) a tenant: the first keeps every group, the
# others are tight enough to roll groups back.
GANG_SIZES = [(6, 3, 12), (8, 4, 5), (7, 3, 3)]


def _gang_tenants(pairwise=False):
    kw = dict(spread_frac=0.3, interpod_frac=0.3) if pairwise else {}
    return _floored(lambda b, **x: tsynth.config4_gangs(
        np.random.default_rng(820 + b), n_groups=GANG_SIZES[b][0],
        gang_size=GANG_SIZES[b][1], n_nodes=GANG_SIZES[b][2], **kw, **x), 3)


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_pairwise_batch_equals_solo_solves(mode, tie_break):
    """Three spread / inter-pod tenants under one 16-wide signature floor
    (K4's pairwise variant, K9-K14 and the signature rounds over the
    tenant axis): each is its solo solve, bit for bit in all six
    outputs; a fast batch reads no fewer flags than the longest solo
    solve and fewer than the solo solves together."""
    cfg = EngineConfig(mode=mode, tie_break=tie_break, tie_seed=5)
    snaps = _pair_tenants()
    assert snaps[0].sigs.key.shape[0] > 0
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    solos = _solo_equal(cfg, snaps, out)
    assert all((r.assignment >= 0).any() for r in solos)
    if mode == "fast":
        reads = [r.host_reads for r in solos]
        assert max(reads) <= stats.host_reads < sum(reads), (
            stats.host_reads, reads)


def _rolled(cfg, snap):
    return int(tassign.solve_rounds(cfg, snap, *_sat_tables(snap),
                                    explain=True)[-1][0].sum()
               if cfg.mode == "fast" else tassign.solve_sequential(
                   cfg, snap, *_sat_tables(snap), explain=True)[-1][0].sum())


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_gang_batch_equals_solo_solves(mode, tie_break):
    """Three config-4 tenants whose group ids overlap (each tenant counts
    its own quorums): the first rolls no group back, the others roll
    some back. Each tenant is its solo solve in all six outputs."""
    cfg = EngineConfig(mode=mode, tie_break=tie_break, tie_seed=5)
    snaps = _gang_tenants()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu")
    _solo_equal(cfg, snaps, out)
    rolled = [_rolled(cfg, s) for s in snaps]
    assert rolled[0] == 0 and rolled[1] > 0 and rolled[2] > 0, rolled
    assert all((out[0][b] >= 0).any() for b in range(3))


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_pairwise_gang_batch_equals_solo_solves(mode):
    """Gang tenants with spread and inter-pod terms: the gate reverts the
    rolled pods out of each tenant's pair state (K10's pair_commit with
    sign -1) as well as out of `used`."""
    cfg = EngineConfig(mode=mode)
    snaps = _gang_tenants(pairwise=True)
    assert snaps[0].sigs.key.shape[0] > 0
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu")
    _solo_equal(cfg, snaps, out)
    assert sum(_rolled(cfg, s) for s in snaps) > 0


def test_jax_tenant_shape_parity_matches_jax():
    """JAX's own tenant test shape in parity mode: assignment, order,
    used and evicted exactly, chosen within ROADMAP C1's tolerance."""
    jsnaps = _jax_shape_tenants()
    ja, jc, ju, jo, jr, jev = _jax_batch(JConfig(mode="parity"), jsnaps)
    out = solve_many(EngineConfig(mode="parity"), stack_snapshots(
        [jax.device_get(s) for s in jsnaps]), device="cpu")
    a, c, u, o, rounds, ev = _np(out)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(rounds, jr)
    np.testing.assert_allclose(u, ju, rtol=1e-5)
    np.testing.assert_allclose(np.nan_to_num(c, neginf=-1.0),
                               np.nan_to_num(jc, neginf=-1.0),
                               rtol=1e-4, atol=1e-3)


def test_jax_tenant_shape_fast_matches_jax():
    """JAX's own tenant test shape in fast mode: assignment and rounds
    exactly, used within rtol 1e-6 (the commit adds' order, ROADMAP
    C6)."""
    jsnaps = _jax_shape_tenants()
    ja, _, ju, _, jr, _ = _jax_batch(JConfig(mode="fast"), jsnaps)
    out = solve_many(EngineConfig(mode="fast"), stack_snapshots(
        [jax.device_get(s) for s in jsnaps]), device="cpu")
    a, _, u, _, rounds, _ = _np(out)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(rounds, jr)
    np.testing.assert_allclose(u, ju, rtol=1e-6)


# Tenants of 20, 40 and 60 pods on 10, 10 and 14 nodes (seeds 109 + b)
# with spread and inter-pod terms: at compact_cap = 4 the first hands off
# after one full-width round, the last after four, the middle never.
HANDOFF = [(20, 10), (40, 10), (60, 14)]


def _handoff_tenants():
    return _floored(lambda b, **x: jsynth.make_cluster(
        np.random.default_rng(109 + b), *HANDOFF[b], spread_frac=0.5,
        interpod_frac=0.5, taint_frac=0.2, toleration_frac=0.3, **x), 3,
        JBuckets)


def test_signature_batch_hands_off_at_different_rounds():
    """compact_cap = 4: each tenant runs full-width rounds until at most
    4 of its pods are pending, then [4, N] views, which wait until the
    full-width loop has ended for every tenant. Two tenants hand off at
    different rounds (counted per tenant from the K5 calls' pending
    rows); the batch equals each tenant's solo rounds bit for bit and
    JAX's fast solve at the same cap (its `_solve_rounds_sig` with
    cap = 4) in assignment and rounds, and reads no fewer flags than the
    longest solo solve and fewer than all of them together."""
    cfg = EngineConfig(mode="fast", compact_cap=4)
    jsnaps = _handoff_tenants()
    snaps = [snapshot_from_numpy(jax.device_get(s)) for s in jsnaps]
    P = snaps[0].pods.valid.shape[0]
    full, compact = np.zeros(3, int), np.zeros(3, int)

    def cycle(*args, **kw):
        width = args[3].shape[-2]
        live = kw["pending"].any(dim=-1).numpy()
        (full if width == P else compact)[:] += live
        return tassign.cycle_plain(*args, **kw)

    ops = dataclasses.replace(tassign.PLAIN, cycle=cycle)
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", ops=ops,
                     stats=stats)
    handed = full[compact > 0]
    assert len(set(handed.tolist())) > 1, (full, compact)
    solos = _solo_equal(cfg, snaps, out)
    reads = [r.host_reads for r in solos]
    assert max(reads) <= stats.host_reads < sum(reads), (stats.host_reads,
                                                         reads)
    jeng = JEngine(JConfig(mode="fast", compact_cap=4))
    try:
        for b, js in enumerate(jsnaps):
            jres = jeng.solve(js)
            np.testing.assert_array_equal(out[0][b].numpy(), jres.assignment,
                                          f"tenant {b} against JAX")
            assert int(out[4][b]) == jres.rounds
    finally:
        jeng.close()


def test_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stacked = stack_snapshots(_port_tenants(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_many(EngineConfig(), stacked)
    out = ttenants.solve_many_jit(EngineConfig())(stacked, device="cpu")
    assert out[0].shape[0] == 2


def test_mismatched_buckets_rejected():
    rng = np.random.default_rng(0)
    s1, _ = tsynth.make_cluster(rng, 8, 4)
    s2, _ = tsynth.make_cluster(rng, 40, 4)
    with pytest.raises(ValueError, match="bucket shapes differ"):
        stack_snapshots([s1, s2])
    with pytest.raises(ValueError, match="no snapshots"):
        stack_snapshots([])


@pytest.mark.parametrize("n,skew", [(1, 1.0), (5, 0.0), (8, 1.2),
                                    (3, -1.0)])
def test_zipf_weights_match_jax(n, skew):
    np.testing.assert_array_equal(ttenants.zipf_weights(n, skew),
                                  jtenants.zipf_weights(n, skew))


def test_zipf_weights_refuse_zero_tenants():
    with pytest.raises(ValueError, match="must be >= 1"):
        ttenants.zipf_weights(0, 1.0)


def _deal_inputs(seed, L=37, N=23, R=3):
    """Integer-valued demand and capacity (exact sums in any order) with
    ties, zero rows, -0.0 and +inf: the dealing's edge cases."""
    rng = np.random.default_rng(seed)
    dem = rng.integers(0, 4, (L, R)).astype(np.float32)
    rem = rng.integers(0, 6, (N, R)).astype(np.float32)
    dem[5] = 0.0
    dem[6] = -0.0
    rem[3:7] = 0.0
    rem[8, 1] = -0.0
    rem[-1, 2] = np.inf
    return torch.from_numpy(dem), torch.from_numpy(rem)


def _deal_reference(dem, rem, gather=None):
    """numpy: f64 cumsums (exact here) and searchsorted(side='left')."""
    cd = np.cumsum(dem.numpy().astype(np.float64), axis=0)
    cr = np.cumsum(rem.numpy().astype(np.float64), axis=0)
    if gather is not None:
        cd = cd[gather.numpy()]
    pos = np.zeros(cd.shape[0], np.int64)
    for r in range(cd.shape[1]):
        pos = np.maximum(pos, np.searchsorted(cr[:, r], cd[:, r], "left"))
    return pos


@pytest.mark.parametrize("seed", range(3))
def test_deal_plain_is_the_moved_dealing(seed):
    """K23's plain version is `_deal_prefixes` (the fixed Hillis-Steele
    order) and torch.searchsorted, with or without a rank gather, and a
    batch gives each tenant's positions."""
    dem, rem = _deal_inputs(seed)
    pos = tassign.deal_plain(dem, rem)
    np.testing.assert_array_equal(pos.numpy(), _deal_reference(dem, rem))
    my_dem, cum_rem = tassign._deal_prefixes(dem, rem)
    want = torch.zeros(dem.shape[0], dtype=torch.int64)
    for r in range(dem.shape[1]):
        want = torch.maximum(want, torch.searchsorted(
            cum_rem[:, r].contiguous(), my_dem[:, r].contiguous()))
    assert torch.equal(pos, want)
    gather = torch.from_numpy(
        np.random.default_rng(seed).permutation(dem.shape[0]))
    np.testing.assert_array_equal(tassign.deal_plain(dem, rem, gather).numpy(),
                                  _deal_reference(dem, rem, gather))
    dem2, rem2 = _deal_inputs(seed + 10)
    batch = tassign.deal_plain(torch.stack([dem, dem2]),
                               torch.stack([rem, rem2]))
    assert torch.equal(batch[0], pos)
    assert torch.equal(batch[1], tassign.deal_plain(dem2, rem2))


@pytest.mark.parametrize("C", [1, 5, 16])
def test_top_by_rank_plain_is_the_moved_pick(C):
    """K24's plain version is `_top_by_rank`, tenant by tenant, and picks
    the C lowest-rank pending pods then the others by rank."""
    rng = np.random.default_rng(C)
    P, B = 16, 3
    pend = torch.from_numpy(rng.random((B, P)) < 0.4)
    order = torch.stack([torch.from_numpy(rng.permutation(P))
                         for _ in range(B)])
    buf, n_pend = tassign.top_by_rank_plain(pend, order, C)
    for b in range(B):
        want = tassign._top_by_rank(pend[b], order[b], C)
        assert torch.equal(buf[b], want[0]) and int(n_pend[b]) == int(want[1])
        pm = pend[b][order[b]].numpy()
        ref = np.concatenate([order[b].numpy()[pm], order[b].numpy()[~pm]])
        np.testing.assert_array_equal(buf[b].numpy(), ref[:C])
    solo = tassign.top_by_rank_plain(pend[0], order[0], C)
    assert torch.equal(solo[0], buf[0])


# -- preemption with PodDisruptionBudgets (config 5) --------------------------


def _pre_tenants(n=3, seed=900, **kw):
    """Config-5 tenants of 40 + 8 b pods on 12 nodes (seeds seed + b)
    under their elementwise-max floor: nodes 90 % full of running pods, a
    third of them under budgets."""
    return _floored(lambda b, **x: tsynth.config5_preemption(
        np.random.default_rng(seed + b), 40 + 8 * b, 12, **kw, **x), n)


def _jax_pre_tenants(pairwise):
    """The two shapes probed against JAX's solve_many: the pairwise
    config-5 tenants (seeds 900 + b, S = 4, M = 128 floor), or ROADMAP
    A1's tight tenants without signatures (seeds 500 + b under
    Buckets(pods=64, nodes=16, running_pods=256))."""
    if pairwise:
        return _floored(lambda b, **x: jsynth.config5_preemption(
            np.random.default_rng(900 + b), 40 + 8 * b, 12, spread_frac=0.3,
            interpod_frac=0.3, **x), 3, JBuckets)
    bk = JBuckets(pods=64, nodes=16, running_pods=256)
    return [jsynth.make_cluster(
        np.random.default_rng(500 + b), 40 + 8 * b, 12,
        initial_utilization=0.9, n_running_per_node=8, pdb_frac=0.3,
        tight_utilization=True, buckets=bk)[0] for b in range(3)]


def _fast_reads(stats, solos):
    reads = [r.host_reads for r in solos]
    assert max(reads) <= stats.host_reads < sum(reads), (stats.host_reads,
                                                         reads)


@pytest.mark.parametrize("tie_break", ["first", "seeded"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_preempt_batch_equals_solo_solves(mode, tie_break):
    """Three config-5 tenants (K4's preemption variant with one CTA a
    tenant; the fast auction rounds with K16-K18 over the tenant axis):
    each is its solo solve, bit for bit in all six outputs, and each
    evicts; a fast batch reads no fewer flags than the longest solo
    solve and fewer than the solo solves together."""
    cfg = EngineConfig(mode=mode, tie_break=tie_break, tie_seed=7,
                       preemption=True)
    snaps = _pre_tenants()
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    solos = _solo_equal(cfg, snaps, out)
    assert all(r.evicted.any() for r in solos)
    if mode == "fast":
        _fast_reads(stats, solos)
        assert len(stats.preempt_rounds) == 3


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_pairwise_preempt_batch_equals_solo_solves(mode):
    """The pairwise config-5 tenants (S = 4 floor): K4's pairwise
    preemption variant with one CTA a tenant; the fast rounds' pairwise
    fixpoint per tenant. Each tenant is its solo solve."""
    cfg = EngineConfig(mode=mode, preemption=True)
    snaps = _pre_tenants(spread_frac=0.3, interpod_frac=0.3)
    assert snaps[0].sigs.key.shape[0] > 0
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    solos = _solo_equal(cfg, snaps, out)
    assert all(r.evicted.any() for r in solos)
    if mode == "fast":
        _fast_reads(stats, solos)


def _pre_matches_jax(mode, pairwise):
    jcfg = JConfig(mode=mode, preemption=True)
    cfg = EngineConfig(mode=mode, preemption=True)
    jsnaps = _jax_pre_tenants(pairwise)
    snaps = [jax.device_get(s) for s in jsnaps]
    if mode == "fast":
        jeng = JEngine(jcfg)
        teng = Engine(cfg, device="cpu")
        try:
            for b, (js, s) in enumerate(zip(jsnaps, snaps)):
                np.testing.assert_array_equal(
                    teng.solve(snapshot_from_numpy(s)).assignment,
                    jeng.solve(js).assignment, f"solo tenant {b}")
        finally:
            jeng.close()
            teng.close()
    ja, jc, ju, jo, jr, jev = _jax_batch(jcfg, jsnaps)
    a, c, u, o, rounds, ev = _np(solve_many(cfg, stack_snapshots(snaps),
                                            device="cpu"))
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(rounds, jr)
    assert ev.any(axis=1).all()
    if mode == "parity":
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_allclose(u, ju, rtol=1e-5)
        np.testing.assert_allclose(np.nan_to_num(c, neginf=-1.0),
                                   np.nan_to_num(jc, neginf=-1.0),
                                   rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_allclose(u, ju, rtol=1e-6)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_preempt_batch_matches_jax(mode):
    """ROADMAP A1's tight config-5 tenants without signatures against
    JAX's solve_many_jit (placed 38 / 47 / 56 in parity)."""
    _pre_matches_jax(mode, pairwise=False)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_pairwise_preempt_batch_matches_jax(mode):
    """The pairwise config-5 tenants against JAX's solve_many_jit."""
    _pre_matches_jax(mode, pairwise=True)


def _uneven_pre():
    """Four config-5 tenants: a contended one; one with no valid running
    pod (in the M > 0 bucket); one whose budgets are all spent; one with
    room for every pod (its preemption loop ends at once)."""
    base = _pre_tenants(4, seed=930)
    norun = dataclasses.replace(base[1], running=dataclasses.replace(
        base[1].running, valid=torch.zeros_like(base[1].running.valid)))
    spent = dataclasses.replace(
        base[2], pdb_allowed=torch.zeros_like(base[2].pdb_allowed))
    nodes = base[3].nodes
    roomy = dataclasses.replace(base[3], nodes=dataclasses.replace(
        nodes, allocatable=nodes.allocatable * 8.0))
    assert base[2].pdb_allowed.sum() > 0
    return [base[0], norun, spent, roomy]


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_preempt_uneven_tenants(mode, monkeypatch):
    """Uneven config-5 tenants: each is its solo solve in all six
    outputs (a tenant's spent budgets never gate another's bids, a
    tenant without victims evicts nothing). In fast mode their auction
    loops end at different rounds; with the round cap at 2 (in this test
    only) the contended tenant hits it while the roomy one has ended
    after one round, and each still equals its solo solve under that
    cap: a finished tenant's state did not move after its last round."""
    cfg = EngineConfig(mode=mode, preemption=True)
    snaps = _uneven_pre()
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    solos = _solo_equal(cfg, snaps, out)
    assert not solos[1].evicted.any() and solos[0].evicted.any()
    assert solos[2].evicted.any()
    if mode == "parity":
        return
    rounds = stats.preempt_rounds
    assert rounds[3] == 1 and len(set(rounds)) > 2, rounds
    monkeypatch.setattr(tassign, "_PREEMPT_MAX_ROUNDS", 2)
    stats = tassign.RoundStats()
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu", stats=stats)
    assert stats.preempt_rounds[0] == 2 and stats.preempt_rounds[3] == 1
    capped = _solo_equal(cfg, snaps, out)
    assert (capped[0].assignment >= 0).sum() < (
        solos[0].assignment >= 0).sum()


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_gang_preempt_batch_equals_solo_solves(mode):
    """Config-5 tenants with gangs of 3 (half the pods): gang members
    never preempt (no gang member is placed with chosen = -inf), groups
    that cannot place all their members roll back per tenant, and each
    tenant is its solo solve in all six outputs."""
    cfg = EngineConfig(mode=mode, preemption=True)
    snaps = _pre_tenants(seed=960, gang_frac=0.5, gang_size=3)
    out = solve_many(cfg, stack_snapshots(snaps), device="cpu")
    solos = _solo_equal(cfg, snaps, out)
    for snap, res in zip(snaps, solos):
        preempted = (res.assignment >= 0) & ~np.isfinite(res.chosen_score)
        assert not (snap.pods.group.numpy()[preempted] >= 0).any()
    assert any(r.evicted.any() for r in solos)
    assert sum(_rolled(cfg, s) for s in snaps) > 0


def _batch_and_solos(snaps):
    stacked = stack_snapshots(snaps)
    return stacked, [stacked.tenant(b) for b in range(len(snaps))]


def test_precompute_over_tenants_equals_solo():
    """The victim order with K15's node offsets and planes (parity) and
    the node-major victim table (fast) of a batch are each tenant's own,
    bit for bit; so are the budgets left after an eviction mask."""
    cfg = EngineConfig(preemption=True)
    stacked, solos = _batch_and_solos(_uneven_pre())
    ctx = tpre.precompute(cfg, stacked)
    nv = tpre.precompute_nv(cfg, stacked, tassign._PREEMPT_VICTIM_CAP)
    rng = np.random.default_rng(3)
    ev = torch.from_numpy(rng.random(stacked.running.valid.shape) < 0.3)
    rem = tpre.pdb_remaining(stacked, ev)
    for b, snap in enumerate(solos):
        for got, want in ((ctx.tenant(b), tpre.precompute(cfg, snap)),
                          (nv.tenant(b), tpre.precompute_nv(
                              cfg, snap, tassign._PREEMPT_VICTIM_CAP))):
            for g, w in zip(got.leaves(), want.leaves()):
                assert torch.equal(g, w), f"tenant {b}"
        assert torch.equal(rem[b], tpre.pdb_remaining(snap, ev[b]))


@pytest.mark.parametrize("seed", range(3))
def test_prio_thresholds_over_tenants_equal_solo(seed):
    """Each tenant's thresholds are the quantiles of its own active
    bidders (NaN for a tenant with none), and its buckets follow them."""
    rng = np.random.default_rng(seed)
    B, C = 4, 37
    prio = torch.from_numpy(rng.normal(50, 20, (B, C)).astype(np.float32))
    prio[:, :5] = prio[:, 5:10]                       # ties
    active = torch.from_numpy(rng.random((B, C)) < 0.5)
    active[1] = False
    active[2, 1:] = False
    thr = tpre.prio_thresholds(prio, active)
    lane = tpre.bucket_of(thr, prio)
    assert torch.isnan(thr[1]).all()
    for b in range(B):
        want = tpre.prio_thresholds(prio[b], active[b])
        np.testing.assert_array_equal(thr[b].numpy(), want.numpy())
        assert torch.equal(lane[b], tpre.bucket_of(want, prio[b]))


@pytest.mark.parametrize("pairwise", [False, True])
def test_auction_round_over_tenants_equals_solo(pairwise, monkeypatch):
    """The first auction round of a fast batch: preempt_auction (K17's
    two entry points, K16, K6 at K = 256 and K18 over the tenant axis),
    the budget gate and the eviction marks on its claims each give every
    tenant its solo call's outputs, bit for bit."""
    kw = dict(spread_frac=0.3, interpod_frac=0.3) if pairwise else {}
    stacked, solos = _batch_and_solos(_pre_tenants(**kw))
    calls = []
    real = tpre.preempt_auction

    def auction(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(tpre, "preempt_auction", auction)
    solve_many(EngineConfig(mode="fast", preemption=True), stacked,
               device="cpu")
    a, k, out = calls[0]
    claimed, usage = out[1], out[5]
    assert claimed.any(dim=-1).all() and usage.any()
    rng = np.random.default_rng(5)
    evicted = torch.from_numpy(rng.random(stacked.running.valid.shape) < 0.2)
    keep = tassign._budget_gate(stacked, evicted, claimed, usage)
    marks = tassign._evict_round(evicted, out[3], keep & out[2])
    for b, snap in enumerate(solos):
        pick = lambda x: (x.tenant(b) if hasattr(x, "tenant") else  # noqa
                          x[b] if isinstance(x, torch.Tensor) else x)
        want = real(*(pick(x) for x in a),
                    **{n: pick(v) for n, v in k.items()})
        for g, w in zip(out, want):
            assert torch.equal(g[b], w), f"tenant {b}"
        solo_keep = tassign._budget_gate(snap, evicted[b], claimed[b],
                                         usage[b])
        assert torch.equal(keep[b], solo_keep), f"tenant {b}"
        assert torch.equal(marks[b], tassign._evict_round(
            evicted[b], out[3][b], solo_keep & out[2][b]))
