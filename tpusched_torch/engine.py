"""Engine: the solve entry point, the port of `tpusched/engine.py`'s
parity path.

`Engine.solve` runs on the CUDA device unless the caller asks for the
CPU (`Engine(cfg, device="cpu")`, which only the tests do): snapshot in,
one flat f32 result buffer out (the JAX engine's layout, decoded by
`Engine.unpack`), with the chain

    _sat_tables (K1) -> precompute_static (K2, K3) -> pop_order (sort)
    -> parity_scan (K4) -> _pack_solve.

The engine starts no thread: `solve` is synchronous and `close` has
nothing to release. Fast mode (ROADMAP A4), signatures (A6), gangs (A7)
and preemption (A8) are refused with NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels.assign import solve_sequential
from tpusched_torch.kernels.atoms import atom_sat
from tpusched_torch.snapshot import ClusterSnapshot


@dataclasses.dataclass
class SolveResult:
    assignment: np.ndarray     # [P] int32 node index or -1
    chosen_score: np.ndarray   # [P] f32 (-inf where unschedulable)
    final_used: np.ndarray     # [N, R] f32
    order: np.ndarray          # [P] int32 pop order
    # [P] commit key: pods with smaller keys committed strictly earlier
    # (parity: the position in pop order).
    commit_key: np.ndarray | None = None
    rounds: int = 0            # P for parity
    evicted: np.ndarray | None = None  # [M] bool (no preemption: False)
    solve_seconds: float = 0.0


def _sat_tables(snap: ClusterSnapshot) -> torch.Tensor:
    """Node atom satisfaction [A, N] (K1, transposed). The JAX function
    also returns the member table over pod labels, which only the
    signature paths read (ROADMAP A6); this slice refuses those, so it
    is not built (the JAX program drops it too when S = 0)."""
    return atom_sat(
        snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
        snap.nodes.label_nums,
    ).T.contiguous()


def solve_core(cfg: EngineConfig, snap: ClusterSnapshot):
    """(assigned, chosen, used, order, commit_key, rounds, evicted) of
    the parity solve; commit_key is the rank in pop order, rounds = P."""
    if cfg.mode != "parity":
        raise NotImplementedError(
            f"mode={cfg.mode!r}: fast mode is not ported yet; ROADMAP A4 "
            "ports it")
    a, c, u, o, ev = solve_sequential(cfg, snap, _sat_tables(snap))
    P = a.shape[0]
    rank = torch.zeros(P, dtype=torch.int32, device=o.device)
    rank[o] = torch.arange(P, dtype=torch.int32, device=o.device)
    rounds = torch.full((), P, dtype=torch.int32, device=o.device)
    return a, c, u, o, rank, rounds, ev


def _pack_solve(out) -> torch.Tensor:
    """Flatten a solve_core output into the ONE f32 result buffer
    (layout authority: Engine.unpack). Indices are exact in f32."""
    assigned, chosen, used, order, commit_key, rounds, ev = out
    return torch.cat([
        assigned.to(torch.float32), chosen,
        order.to(torch.float32), commit_key.to(torch.float32),
        used.reshape(-1), ev.to(torch.float32),
        rounds.to(torch.float32)[None],
    ])


class Engine:
    """Parity-mode scheduling engine on one CUDA device.

    device: "cuda" (the default) or a CUDA device; "cpu" runs every
    kernel's plain version instead, for tests. Without CUDA the default
    raises: the engine never falls back to the CPU by itself."""

    mesh = None  # single device; the JAX engine's mesh is ROADMAP A14

    def __init__(self, config: EngineConfig | None = None,
                 device: "str | torch.device | None" = None):
        self.config = config or EngineConfig()
        cfg = self.config
        if cfg.mode not in ("parity", "fast"):
            raise ValueError(f"mode={cfg.mode!r}: want 'parity' or 'fast'")
        if cfg.mode == "fast":
            raise NotImplementedError(
                "mode='fast' is not ported yet; ROADMAP A4 ports it")
        if cfg.ring_counts:
            raise ValueError(
                "ring_counts=True needs a device mesh, which the port "
                "does not have yet (ROADMAP A14)")
        if cfg.tie_break not in ("first", "seeded"):
            raise NotImplementedError(
                f"tie_break={cfg.tie_break!r}: want 'first' or 'seeded'")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: the engine runs on the GPU; pass "
                    "device='cpu' explicitly to run the plain versions")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device={device!r}: want 'cuda' or 'cpu'")

    @staticmethod
    def unpack(snap: ClusterSnapshot, buf) -> SolveResult:
        """Decode _pack_solve's flat buffer."""
        buf = np.asarray(buf)
        P = snap.pods.valid.shape[0]
        N, R = snap.nodes.used.shape
        M = snap.running.valid.shape[0]
        base = 4 * P + N * R
        return SolveResult(
            assignment=buf[:P].astype(np.int32),
            chosen_score=buf[P: 2 * P],
            order=buf[2 * P: 3 * P].astype(np.int32),
            commit_key=buf[3 * P: 4 * P].astype(np.int32),
            final_used=buf[4 * P: base].reshape(N, R),
            evicted=buf[base: base + M] > 0,
            rounds=int(buf[-1]),
        )

    def put(self, snap: ClusterSnapshot) -> ClusterSnapshot:
        """Host -> device transfer of every leaf."""
        return snap.to(self.device)

    def solve(self, snap: ClusterSnapshot) -> SolveResult:
        """Assign every pending pod (or -1). The time covers the
        transfer in, the solve and the one device -> host read of the
        result buffer, which waits for the device."""
        t0 = time.perf_counter()
        dsnap = self.put(snap)
        buf = _pack_solve(solve_core(self.config, dsnap))
        out = self.unpack(dsnap, buf.cpu().numpy())
        out.solve_seconds = time.perf_counter() - t0
        return out

    def close(self) -> None:
        """Nothing to release: the engine holds no thread or handle."""
