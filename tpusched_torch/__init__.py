"""tpusched_torch — the PyTorch / CUDA port of tpusched for one NVIDIA H100.

A package of its own beside the JAX reference (`tpusched/`), which it
never imports. It covers `Engine.solve` in parity mode (the
exactly-sequential commit) and fast mode (batched commit rounds), with
pairwise constraints, gangs and preemption; ScoreBatch (`Engine.score`,
`score_top1`, `score_topk`); their async forms; and warm lineages
(`device_state.DeviceSnapshot` with `Engine.solve_warm`, bitwise or
incremental); the device pending queue (`DeviceQueue`); and decision
provenance (`Engine.solve_explained`: `ExplainData`, `ScoreExplain`);
and the multi-tenant batch (`stack_snapshots`, `solve_many`); and the
device mesh with the pairwise count ring (`mesh.make_mesh`,
`Engine(mesh=...)` with `ring_counts`).
Every device program runs on a CUDA kernel written for
Hopper (tpusched_torch/csrc), built with nvcc at first use, or on plain
torch where the JAX program is a row gather, scatter or sort.
"""

from tpusched_torch.config import Buckets, EngineConfig, PluginWeights
from tpusched_torch.device_state import DeviceQueue
from tpusched_torch.engine import (
    Engine,
    ExplainData,
    ScoreBatchResult,
    SolveResult,
)
from tpusched_torch.kernels.explain import ScoreExplain
from tpusched_torch.snapshot import (
    ClusterSnapshot,
    SnapshotBuilder,
    snapshot_from_numpy,
)
from tpusched_torch.tenants import solve_many, stack_snapshots

__all__ = [
    "Buckets",
    "ClusterSnapshot",
    "DeviceQueue",
    "Engine",
    "EngineConfig",
    "ExplainData",
    "PluginWeights",
    "ScoreBatchResult",
    "ScoreExplain",
    "SnapshotBuilder",
    "SolveResult",
    "snapshot_from_numpy",
    "solve_many",
    "stack_snapshots",
]
