"""Host reads of the port's fast solves (on the CPU, where every kernel
wrapper runs its plain version): one device flag read a round, a
tranche, a validation pass, a full-width/compacted hand-off and a
preemption round, and none for the commit sub-steps, which K8
(`prefix_commit_loop`) runs inside one launch a round. The loop the host
ran before read one flag a sub-step and one more to end each round's
loop; holding the same solve through that loop shows that the reads
fall by exactly those, with the same results.

K18's cluster policy (`kernels/preempt.claim_cluster_size`) is held here
too: every cluster on an SM of its own, and every bidder on one warp's
slot."""

from __future__ import annotations

import collections
import dataclasses
import sys

import numpy as np
import pytest
import torch

from tpusched_torch import EngineConfig
from tpusched_torch import synth as tsynth
from tpusched_torch.engine import solve_core
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.kernels import preempt as tpre


class _SiteStats(tassign.RoundStats):
    """RoundStats that notes the function each host read comes from."""

    def __init__(self):
        super().__init__()
        self.sites: collections.Counter = collections.Counter()

    def read(self, flag):
        self.sites[sys._getframe(1).f_code.co_name] += 1
        return super().read(flag)

    def read_each(self, flags):
        self.sites[sys._getframe(1).f_code.co_name] += 1
        return super().read_each(flags)


def _host_loop(stats: tassign.RoundStats):
    """The commit loop as the host ran it before K8 took it on: one read
    of the active flag a sub-step, and the read that ends the loop."""

    def loop(topi, topv, allowed, rank, requests, alloc, used, step):
        lead = rank.shape[:-1]
        P, KC, N = rank.shape[-1], topi.shape[-1], alloc.shape[-2]
        choice = torch.full((*lead, P), -1, dtype=torch.int32)
        ptr = torch.zeros((*lead, P), dtype=torch.int32)
        steps = torch.zeros(lead, dtype=torch.int32)
        while True:
            ptr_c = ptr.clamp(0, KC - 1).long()[..., None]
            cand = topi.gather(-1, ptr_c)[..., 0]
            cand_ok = topv.gather(-1, ptr_c)[..., 0] > tassign.NEG_INF
            active = allowed & (choice < 0) & (ptr < KC) & cand_ok
            if not stats.read(active.any()):
                return used, choice, steps
            steps = steps + active.any(dim=-1).to(torch.int32)
            cand_m = torch.where(active, cand, N)
            perm = torch.sort((cand_m.long() << 32) + rank.long(), dim=-1,
                              stable=True).indices
            used, choice, ptr = step(perm.to(torch.int32),
                                     cand_m.gather(-1, perm).contiguous(),
                                     requests, alloc, used, choice, ptr, KC)

    return loop


def _case(name):
    """(config, snapshot) of each path whose reads differ."""
    if name == "direct":
        snap, _ = tsynth.make_cluster(np.random.default_rng(0), 60, 12)
        return EngineConfig(mode="fast"), snap
    if name == "tranches":
        snap, _ = tsynth.make_cluster(
            np.random.default_rng(7), 160, 20, taint_frac=0.3,
            toleration_frac=0.3, selector_frac=0.3, affinity_frac=0.3)
        return EngineConfig(mode="fast"), snap
    if name == "signatures":
        snap, _ = tsynth.config3_pairwise(np.random.default_rng(43), 200, 40)
        return EngineConfig(mode="fast", compact_cap=8), snap
    snap, _ = tsynth.config5_preemption(np.random.default_rng(45), 200, 60)
    return EngineConfig(mode="fast", preemption=True), snap


# Where a fast solve's reads may come from: the round loops, the
# tranche loop, the validation passes, the hand-offs, the preemption
# rounds and their pairwise fixpoint.
READ_SITES = {"_run_rounds", "_rounds_nosig", "_round_sig", "advance",
              "_rounds_sig", "_preempt_rounds_many"}


@pytest.mark.parametrize("name", ["direct", "tranches", "signatures",
                                  "preemption"])
def test_fast_host_reads_have_no_substep_reads(name, monkeypatch):
    """A fast solve reads only in its round, tranche, validation,
    hand-off and preemption loops (never in _deal_commit or K8's loop);
    the host loop K8 replaced would have read once more for every
    sub-step and once more for every round's loop, and gives the same
    solve. Without tranches, signatures or preemption a solve reads
    once a round."""
    if name == "tranches":       # tranches of 16 at this size
        monkeypatch.setattr(tassign, "_RESIDUAL_CAP", 16)
    cfg, snap = _case(name)
    stats = _SiteStats()
    calls = []

    def loop(*args):
        out = tassign.prefix_commit_loop(*args)
        calls.append(int(out[2].max()))
        return out

    ops = dataclasses.replace(tassign.KERNELS, prefix_commit_loop=loop)
    got = solve_core(cfg, snap, ops=ops, stats=stats)
    assert set(stats.sites) <= READ_SITES, stats.sites
    assert sum(stats.sites.values()) == stats.host_reads
    assert calls and max(calls) > 0
    old = tassign.RoundStats()
    ops_old = dataclasses.replace(tassign.KERNELS,
                                  prefix_commit_loop=_host_loop(old))
    want = solve_core(cfg, snap, ops=ops_old, stats=old)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert stats.host_reads == old.host_reads - sum(c + 1 for c in calls)
    if name == "direct":
        assert stats.host_reads == int(got[5]) > 0
    if name == "tranches":
        assert stats.sites["_rounds_nosig"] > 2
    if name == "signatures":
        assert stats.sites["_round_sig"] > 0
    if name == "preemption":
        assert stats.sites["_preempt_rounds_many"] > 0


def _claim_layout(C: int, Q: int, threads: int) -> list:
    """csrc/auction.cu's (CTA, warp, slot) of each bidder 0..C-1: CTA q
    owns bidders [q * ceil(C / Q), ...), its warp w the next BPW =
    ceil(ceil(C / Q) / warps) of them."""
    cpc = -(-C // Q)
    warps = threads // 32
    bpw = -(-cpc // warps)
    return [(c // cpc, (c % cpc) // bpw, (c % cpc) % bpw) for c in range(C)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("C", [1, 31, 100, 1000, 1024])
@pytest.mark.parametrize("B", [1, 2, 8, 9, 40, 200])
def test_claim_cluster_policy(B, C, sms):
    """K18's (Q, threads): Q one of 1-16 with B x Q within the SMs (Q = 1
    when B alone passes them), at most 32 warps a CTA, and
    the kernel's layout puts each bidder on one (CTA, warp, slot) of the
    cluster, in bidder order."""
    Q, threads = tpre.claim_cluster_size(B, C, sms)
    assert Q in tpre.CLAIM_CLUSTERS
    assert B * Q <= sms or Q == 1
    assert 32 <= threads <= 32 * tpre.CLAIM_WARPS and threads % 32 == 0
    where = _claim_layout(C, Q, threads)
    assert len(where) == C and where == sorted(where)
    assert len(set(where)) == C
    assert all(q < Q and w < threads // 32 for q, w, _ in where)
    if C >= 1000 and B <= 8 and sms == 132:
        # (h)'s and the 8-tenant batches' auctions: 16 CTAs, two bidders
        # a warp, both in registers.
        assert Q == 16 and max(s for _, _, s in where) < tpre.CLAIM_REG
