"""tpusched_torch — the PyTorch / CUDA port of tpusched for one NVIDIA H100.

A package of its own beside the JAX reference (`tpusched/`), which it
never imports. It covers, for snapshots without pairwise signatures,
gangs or preemption, `Engine.solve` in parity mode (the
exactly-sequential commit) and fast mode (batched commit rounds), and
ScoreBatch (`Engine.score`, `score_top1`, `score_topk`): label matching,
the static Filter/Score tableau, the batched Filter/Score pass, the
per-row ranking, the dealing and the commits, each on a CUDA kernel
written for Hopper (tpusched_torch/csrc), built with nvcc at first use.
"""

from tpusched_torch.config import Buckets, EngineConfig, PluginWeights
from tpusched_torch.engine import Engine, ScoreBatchResult, SolveResult
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
    "ScoreBatchResult",
    "SnapshotBuilder",
    "SolveResult",
    "snapshot_from_numpy",
]
