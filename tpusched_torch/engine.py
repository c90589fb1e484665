"""Engine: the entry points, the port of `tpusched/engine.py`.

Everything runs on the CUDA device unless the caller asks for the CPU
(`Engine(cfg, device="cpu")`, which only the tests do).

`Engine.solve` takes a snapshot and returns one flat f32 result buffer
(the JAX engine's layout, decoded by `Engine.unpack`), through

    _sat_tables (K1) -> precompute_static (K2, K3; K9 with signatures)
    -> pop_order (sort)
    -> parity_scan (K4)                        [mode="parity", S = 0]
    -> pair_counts (K10) -> parity_scan_pair (K4's pairwise variant)
                                               [mode="parity", S > 0]
       with preemption=True and running pods, after the victim sort
       (kernels/preempt.precompute), the same scans' preemption
       variants parity_scan_preempt / parity_scan_pair_preempt, which
       run K15's victim search for each pod that fits nowhere
    -> solve_rounds (K5, K6, K7, K8 a round)    [mode="fast", S = 0]
    -> pair_counts (K10) -> solve_rounds (K11, K5, K12, K6, K7, K8 and
       K10's commit a round; K14, K13, K8's node_add and K10's commit a
       validation pass)                        [mode="fast", S > 0]
       with preemption=True and running pods, after the main rounds, the
       preemption drain's auction rounds (the node-major victim table
       kernels/preempt.precompute_nv, then each round K5 and K6 on the
       bidders' rows, K11 first with signatures, the auction's K17, K16,
       K17, K6 and K18, the plain commits through K7, K8 and node_add,
       and with signatures the validation through K10, K14 and K13)
    -> gang_rollback (the gang gate, both modes: quorum counts, then
       K8's node_add and K10's pair_commit with sign -1)
    -> _pack_solve (the evicted running pods in its [M] section).

`Engine.score`, `score_top1` and `score_topk` (ScoreBatch) run the same
static front half, then, with signatures, the pair state of the running
members (K10) and every pod's pairwise row (K11), then one [P, N] Filter
+ Score pass (K5) and, for the top-k forms, a per-row ranking (K6).

S is the number of pairwise signatures (topology spread, inter-pod
affinity and anti-affinity terms). The engine starts no thread: every
entry point is synchronous and `close` has nothing to release.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpusched_torch.config import EngineConfig
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels.assign import (
    KERNELS,
    Ops,
    RoundStats,
    score_batch,
    solve_rounds,
    solve_sequential,
)
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
    # Fast mode: device flags the host read to drive the round loops.
    host_reads: int = 0


@dataclasses.dataclass
class ScoreBatchResult:
    feasible: np.ndarray       # [P, N] bool
    scores: np.ndarray         # [P, N] f32
    solve_seconds: float = 0.0


def _sat_tables(snap: ClusterSnapshot, ops: Ops = KERNELS):
    """(node atom satisfaction [A, N], member atom satisfaction [A, M+P]
    over running then pending pod labels), both K1, transposed. The
    member table is only read by the signature paths and is None at
    S = 0 (the JAX program drops it there too)."""
    node_sat_t = ops.atom_sat(
        snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
        snap.nodes.label_nums,
    ).T.contiguous()
    member_sat_t = None
    if snap.sigs.key.shape[0] > 0:
        member_sat_t = kpair.member_label_sat_t(snap, ops.atom_sat)
    return node_sat_t, member_sat_t


def solve_core(cfg: EngineConfig, snap: ClusterSnapshot, ops: Ops = KERNELS,
               stats: RoundStats | None = None):
    """(assigned, chosen, used, order, commit_key, rounds, evicted) in
    either mode. Parity: commit_key is the rank in pop order, rounds = P.
    Fast: commit_key is each pod's commit round. stats collects the fast
    loops' host reads (and spans, when it times)."""
    if cfg.mode == "fast":
        return solve_rounds(cfg, snap, *_sat_tables(snap, ops), ops=ops,
                            stats=stats)
    a, c, u, o, ev = solve_sequential(cfg, snap, *_sat_tables(snap, ops),
                                      ops=ops)
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


def score_core(cfg: EngineConfig, snap: ClusterSnapshot, masked: bool = False,
               ops: Ops = KERNELS):
    """ScoreBatch on the device: (feasible [P, N], score [P, N]); with
    masked, the score is -inf at infeasible cells."""
    return score_batch(cfg, snap, *_sat_tables(snap, ops), masked=masked,
                       ops=ops)


def score_top1_core(cfg: EngineConfig, snap: ClusterSnapshot,
                    ops: Ops = KERNELS):
    """Each pod's best feasible node (lowest index among the maxima, -1
    if none), its score and whether any node is feasible, on the
    device."""
    _, masked = score_core(cfg, snap, masked=True, ops=ops)
    topv, topi, _ = ops.row_topk(masked, 1)
    any_feasible = topv[:, 0] > float("-inf")
    best = torch.where(any_feasible, topi[:, 0], -1)
    return best, topv[:, 0], any_feasible


def score_topk_core(cfg: EngineConfig, snap: ClusterSnapshot, kb: int,
                    ops: Ops = KERNELS):
    """Each pod's kb best feasible nodes, descending, ties to the lower
    index: (idx [P, kb] int32, -1 past the feasible ones; val [P, kb]
    f32, 0 there), on the device."""
    _, masked = score_core(cfg, snap, masked=True, ops=ops)
    topv, topi, _ = ops.row_topk(masked, kb)
    ok = torch.isfinite(topv)
    zero = torch.zeros((), dtype=topv.dtype, device=topv.device)
    return torch.where(ok, topi, -1), torch.where(ok, topv, zero)


class Engine:
    """Scheduling engine on one CUDA device, in parity or fast mode.

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
        stats = RoundStats()
        buf = _pack_solve(solve_core(self.config, dsnap, stats=stats))
        out = self.unpack(dsnap, buf.cpu().numpy())
        out.host_reads = stats.host_reads
        out.solve_seconds = time.perf_counter() - t0
        return out

    def score(self, snap: ClusterSnapshot) -> ScoreBatchResult:
        """ScoreBatch: [P, N] feasibility + normalized weighted scores
        against the snapshot's usage, no commits."""
        t0 = time.perf_counter()
        feasible, scores = score_core(self.config, self.put(snap))
        return ScoreBatchResult(feasible=feasible.cpu().numpy(),
                                scores=scores.cpu().numpy(),
                                solve_seconds=time.perf_counter() - t0)

    def score_top1(self, snap: ClusterSnapshot):
        """Each pod's best node (-1 if none is feasible), its score and
        feasibility: (best [P] int32, score [P] f32, feasible [P] bool,
        seconds). The [P, N] matrix stays on the device."""
        t0 = time.perf_counter()
        best, mx, anyf = score_top1_core(self.config, self.put(snap))
        return (best.cpu().numpy(), mx.cpu().numpy(), anyf.cpu().numpy(),
                time.perf_counter() - t0)

    @staticmethod
    def _k_bucket(k: int, n: int) -> int:
        """The power of two at or above k, at most n: the device ranks
        this many columns and the caller keeps the first k, which equal
        a direct top-k (the ranking is a descending sort)."""
        kb = 1 << (max(int(k), 1) - 1).bit_length()
        return min(kb, int(n))

    def score_topk(self, snap: ClusterSnapshot, k: int):
        """Each pod's best k feasible nodes, descending (ties to the
        lower index), and their scores: (idx [P, k] int32 with -1 where
        fewer than k are feasible, scores [P, k] f32 with 0 there,
        seconds)."""
        k = int(k)
        N = snap.nodes.valid.shape[0]
        if not 1 <= k <= N:
            raise ValueError(f"top_k={k} out of range for {N} node slots")
        t0 = time.perf_counter()
        idx, val = score_topk_core(self.config, self.put(snap),
                                   self._k_bucket(k, N))
        return (idx[:, :k].cpu().numpy(), val[:, :k].cpu().numpy(),
                time.perf_counter() - t0)

    def close(self) -> None:
        """Nothing to release: the engine holds no thread or handle."""
