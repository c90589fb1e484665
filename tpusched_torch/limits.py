"""The card's limits, refused by name before any launch.

The JAX package answers any resource count, any number of spread
constraints a pod and any preemption shape. A few hand kernels of the
port hold a per-CTA table of a fixed size, so on the card those shapes
would otherwise fail inside a wrapper in the middle of a solve, or only
as a CUDA error code. `check_card_limits` names each limit and the value
found instead; `Engine` runs it on its config when it is built and on
every snapshot it puts, and `tenants.solve_many` on the batch. It is a
pure function of the config and the shapes (the SM count is a
parameter), so the CPU tests call it on CPU tensors.

The limits (copies of the CUDA sources' constants; a card test holds
them against the values the built library reports):
  MAX_R       resource axes: K4's and K5's per-resource registers and
              K18's need rows (csrc/cell.cuh MAX_R, csrc/auction.cu MAXR)
  MAX_C       spread constraints a pod: K4's pairwise variant's and K11's
              per-constraint minima in shared memory (csrc/pairwise.cuh)
  CLAIM_SMEM  K18's shared memory a CTA (csrc/auction.cu CLAIM_SMEM_LIMIT):
              the fast preemption auction's node bits and bidder rows
  DEAL_ROWS   rows of a column K23's dealing holds in shared memory (the
              fast rounds' demand over the pod bucket, capacity over N)
"""

from __future__ import annotations

from tpusched_torch.kernels.assign import _DEAL_SMEM, _PREEMPT_BATCH
from tpusched_torch.kernels.pairwise import MAX_C
from tpusched_torch.kernels.preempt import CLAIM_MAX_K, claim_cluster_size

MAX_R = 8
CLAIM_SMEM = 200 * 1024
DEAL_ROWS = _DEAL_SMEM // 8
H100_SMS = 132


def claim_smem_bytes(N: int, C: int, Q: int, K: int) -> int:
    """K18's dynamic shared memory a CTA (csrc/auction.cu
    claim_smem_bytes): the taken bits of every node, the best bidder of
    each of the CTA's nodes twice, and each of its bidders' rows."""
    NW = (N + 31) // 32
    NPC = ((N + Q - 1) // Q + 31) // 32 * 32
    CPC = (C + Q - 1) // Q
    KPL = (K + 31) // 32
    return 4 * NW + 8 * NPC + CPC * (4 * KPL + 13)


def check_config(cfg) -> None:
    """Raise ValueError if the config asks for more resource axes than
    the kernels take."""
    R = len(cfg.resources)
    if R > MAX_R:
        raise ValueError(f"resources: {R} resource axes, the card's kernels "
                         f"take at most MAX_R = {MAX_R}")


def check_card_limits(cfg, snap, sms: int = H100_SMS) -> None:
    """Raise ValueError naming the first card limit the config or the
    snapshot (any tree with the ClusterSnapshot fields; a tenant batch's
    leading [B] axis included) passes. sms: the card's SM count, which
    sets K18's cluster size. The config's own resource axes are
    check_config's, run when a card Engine is built."""
    pods, nodes = snap.pods, snap.nodes
    lead = tuple(pods.valid.shape[:-1])
    B = lead[0] if lead else 1
    P, N = pods.valid.shape[-1], nodes.valid.shape[-1]
    R = nodes.allocatable.shape[-1]
    if R > MAX_R:
        raise ValueError(f"snapshot: {R} resource axes, the card's kernels "
                         f"take at most MAX_R = {MAX_R}")
    C = pods.ts_sig.shape[-1]
    if C > MAX_C:
        raise ValueError(f"snapshot: {C} spread constraints a pod, the "
                         f"card's kernels take at most MAX_C = {MAX_C}")
    if cfg.mode != "fast":
        return
    if max(P, N) > DEAL_ROWS:
        raise ValueError(f"snapshot: {max(P, N)} rows in the fast rounds' "
                         f"dealing, the card takes at most DEAL_ROWS = "
                         f"{DEAL_ROWS}")
    M = snap.running.valid.shape[-1]
    if cfg.preemption and M > 0 and P > 0 and N > 0:
        bidders = min(P, _PREEMPT_BATCH)
        Q, _ = claim_cluster_size(B, bidders, sms)
        smem = claim_smem_bytes(N, bidders, Q, min(CLAIM_MAX_K, N))
        if smem > CLAIM_SMEM:
            raise ValueError(
                f"snapshot: the preemption auction's claims need {smem} "
                f"bytes of shared memory a CTA ({N} nodes, {bidders} "
                f"bidders, {B} tenants over {sms} SMs: Q = {Q}), the card "
                f"takes at most CLAIM_SMEM = {CLAIM_SMEM}")
