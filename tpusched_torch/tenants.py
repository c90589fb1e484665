"""Multi-tenant batched solving: the port of `tpusched/tenants.py`.

A sidecar serving many clusters (or many isolated tenants of one
control plane) holds B snapshots with no cross-tenant interaction,
which is a batch axis:

  * stack_snapshots: B bucket-aligned snapshots -> one ClusterSnapshot
    whose leaves carry a leading tenant axis;
  * solve_many: the solve over that axis, as the JAX package's
    jax.vmap of solve_core. Every kernel of the path launches once for
    all B tenants (K4 with one CTA a tenant, K8 likewise, the others
    over the flattened tenant rows), and a fast-mode loop step reads one
    device flag for all of them; a tenant whose loop has ended keeps its
    state while the others go on.

Every tenant's result equals the solo `Engine.solve` of its snapshot bit
for bit. The batch covers configs 1-5 in both modes: pairwise signatures
(topology spread, inter-pod affinity; K4's pairwise variant, K9-K14 and
the signature rounds, each tenant handing off to compacted rounds at its
own frontier), gangs (each tenant's own quorums) and preemption with
PodDisruptionBudgets (K4's preemption variants with K15 inside, one CTA
a tenant over its own victim table; the fast auction rounds with K16-K18
over the tenant axis, each tenant's own thresholds, budgets, round
counter and commit keys). ring_counts is refused: JAX's solve_many
solves with no mesh, so it has no ring to run.

On a mesh (`solve_many(..., mesh=...)`, JAX's `tenant_sharding`) the
tenants split over the mesh's p axis in contiguous blocks, as PS('p')
splits them (B must be a multiple of p, or ValueError, as JAX's
device_put refuses); each rank solves its block on its device and an
all-gather over the p ring returns every output as [B, ...] on every
rank.

Alignment requirement: all tenants share identical bucket shapes; build
them with one explicit `Buckets` floor (S is the bucket, not the count
of real signatures: a floor with S > 0 sends every tenant down the
signature path).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpusched_torch.config import EngineConfig
from tpusched_torch.engine import solve_core
from tpusched_torch.kernels import stack_tenants
from tpusched_torch.kernels.assign import KERNELS, Ops, RoundStats
from tpusched_torch.limits import check_card_limits
from tpusched_torch.mesh import POD_AXIS, mesh_device
from tpusched_torch.snapshot import ClusterSnapshot, snapshot_from_numpy


def zipf_weights(n: int, skew: float) -> np.ndarray:
    """Normalized Zipf weights over n tenants: w_r ∝ 1 / rank^skew
    (skew <= 0 is uniform), the JAX package's tenant-skew definition."""
    if n < 1:
        raise ValueError(f"zipf_weights: n={n} must be >= 1")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                       max(float(skew), 0.0))
    return w / w.sum()


def stack_snapshots(snaps: list) -> ClusterSnapshot:
    """Stack bucket-aligned snapshots (the port's, or any object with the
    ClusterSnapshot field tree and numpy leaves, such as the JAX
    package's) along a new leading tenant axis, on the host. Raises if
    any leaf shapes disagree (different buckets)."""
    if not snaps:
        raise ValueError("no snapshots to stack")
    trees = [s.to("cpu") if isinstance(s, ClusterSnapshot)
             else snapshot_from_numpy(s) for s in snaps]
    first = trees[0].leaves()
    for i, t in enumerate(trees[1:], 1):
        for a, b in zip(first, t.leaves()):
            if a.shape != b.shape:
                raise ValueError(
                    f"tenant {i} bucket shapes differ: {tuple(b.shape)} vs "
                    f"{tuple(a.shape)} — build all tenants with one "
                    "explicit Buckets floor")
    return stack_tenants(trees)


def _refuse(cfg: EngineConfig, stacked: ClusterSnapshot) -> None:
    """What the tenant batch does not run yet, by name."""
    if cfg.mode not in ("parity", "fast"):
        raise ValueError(f"mode={cfg.mode!r}: want 'parity' or 'fast'")
    if cfg.tie_break not in ("first", "seeded"):
        raise NotImplementedError(
            f"tie_break={cfg.tie_break!r}: want 'first' or 'seeded'")
    if cfg.ring_counts:
        raise NotImplementedError(
            "solve_many: ring_counts=True has no ring to run: the tenant "
            "batch solves with no mesh, as JAX's solve_many does")


def solve_many(cfg: EngineConfig, stacked, device=None, mesh=None,
               ops: Ops = KERNELS, stats: RoundStats | None = None):
    """Solve B independent tenants at once: per tenant (assignment [B, P]
    int32, chosen [B, P] f32, used [B, N, R] f32, order [B, P] int64,
    rounds [B] int32, evicted [B, M] bool), tensors on the device.

    stacked: stack_snapshots' result (or any tree of that shape). device:
    "cuda" (the default; raises without CUDA) or "cpu", which runs every
    kernel's plain version (the tests). mesh: a `mesh.Mesh`; this rank
    then solves its contiguous block of B / p tenants on the mesh's
    device (a `device` that differs raises) and the outputs are gathered
    over its p ring. ops: the kernel table (PLAIN runs the whole batch
    without a kernel, to compare). stats: collects the fast loops' host
    reads (this rank's block's), one a loop step for all tenants (with
    preemption, stats.preempt_rounds lists each tenant's auction
    rounds)."""
    _refuse(cfg, stacked)
    device = mesh_device(mesh, device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: solve_many runs on the GPU; pass "
                "device='cpu' explicitly to run the plain versions")
        device = "cuda"
    if not isinstance(stacked, ClusterSnapshot):
        stacked = snapshot_from_numpy(stacked)
    if mesh is not None:
        B, p = stacked.pods.valid.shape[0], mesh.shape[POD_AXIS]
        if B % p:
            raise ValueError(f"solve_many: {B} tenants do not split over "
                             f"the mesh's {p} p ranks (B must be a multiple "
                             "of p)")
        i = mesh.coords[0]
        stacked = stacked.tenant(slice(i * B // p, (i + 1) * B // p))
    if torch.device(device).type == "cuda":
        check_card_limits(cfg, stacked, torch.cuda.get_device_properties(
            device).multi_processor_count)
    snap = stacked.to(device)
    a, c, u, o, _, rounds, ev = solve_core(cfg, snap, ops=ops, stats=stats)
    out = (a, c, u, o, rounds, ev)
    return out if mesh is None else tuple(mesh.p_gather(t) for t in out)


def solve_many_jit(cfg: EngineConfig):
    """solve_many closed over the config, the JAX package's entry name.
    Nothing compiles per config here (the kernels are built once), so
    there is nothing to memoize."""
    return functools.partial(solve_many, cfg)
