"""tpusched_torch — the PyTorch / CUDA port of tpusched for one NVIDIA H100.

A package of its own beside the JAX reference (`tpusched/`), which it
never imports. This slice covers the parity-mode `Engine.solve` on
snapshots without pairwise signatures, gangs or preemption: label
matching, the static Filter/Score tableau and the exactly-sequential
commit, each on a CUDA kernel written for Hopper (tpusched_torch/csrc),
built with nvcc at first use.
"""

from tpusched_torch.config import Buckets, EngineConfig, PluginWeights
from tpusched_torch.engine import Engine, SolveResult
from tpusched_torch.snapshot import (
    ClusterSnapshot,
    SnapshotBuilder,
    snapshot_from_numpy,
)

__all__ = [
    "Buckets",
    "ClusterSnapshot",
    "Engine",
    "EngineConfig",
    "PluginWeights",
    "SnapshotBuilder",
    "SolveResult",
    "snapshot_from_numpy",
]
