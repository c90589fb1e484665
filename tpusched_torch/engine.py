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
affinity and anti-affinity terms).

The async forms (`solve_async`, `score_async`, `score_topk_async`)
enqueue the work and a copy of the result into pinned host memory
behind a CUDA event, and return a `PendingFetch` whose `result()` waits
on that event: the engine starts no thread, and `close` has nothing to
release. (Fast mode reads device flags while it dispatches, so its
dispatch returns when its last round has been decided.)

The explained entry points (`solve_explained_async`, `solve_explained`)
run the solve with JAX's provenance outputs (the gang gate's rollbacks,
each victim's evicting pod and commit round: K4's explain outputs in
parity mode, a scatter-max over each auction round's kept bids in fast
mode, with the per-round auction table) and, beside it, the probe
(`kernels/explain.explain_probe`: K1, K2, with signatures K9 and K10,
then K22's tallies and masked totals, K6's top k and K22's terms at the
chosen cells). The placements equal the unexplained solve's.

The warm entry points (`solve_warm_async`, `solve_warm`) solve a
device-resident lineage (`device_state.DeviceSnapshot`, or any object
with its interface, such as the JAX package's): the cold rung builds
the lineage's tableau (`kernels/assign.build_tableau`), the warm rung
refreshes its dirty rows and columns (`refresh_tableau`: K1, K2 and K9
on views) and solves bitwise as a cold solve would, and the incremental
rung seeds the fast rounds with the previous cycle's placements
(`solve_incremental`: K20's frontier closure, K19's capacity prefix,
then the rounds over the frontier).

With `ring_counts=True` (on `Engine(mesh=...)`, a `mesh.Mesh`) every
entry point but the incremental rung takes the initial pair counts from
the ring over the mesh's p axis (`ring.ring_sig_counts`, K25 a hop) in
place of K10's counts, the same bits; anti and match_tot still come from
K10. Each rank runs the rest of the solve whole on its device.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from tpusched_torch.config import EngineConfig
from tpusched_torch.device_state import _pad_pow2
from tpusched_torch.kernels import explain as kexplain
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels.assign import (
    EXPLAIN_AUCTION_STATS,
    INC_AUDIT_LEN,
    KERNELS,
    _PREEMPT_MAX_ROUNDS,
    Ops,
    RoundStats,
    StaticCtx,
    WarmTableau,
    _rank_of,
    build_tableau,
    finalize_static,
    refresh_tableau,
    score_batch,
    solve_incremental,
    solve_rounds,
    solve_sequential,
)
from tpusched_torch.kernels.queue import k_bucket
from tpusched_torch.limits import check_card_limits, check_config
from tpusched_torch.mesh import mesh_device
from tpusched_torch.ring import ring_sig_counts
from tpusched_torch.snapshot import ClusterSnapshot, snapshot_from_numpy


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
    # Incremental warm solves: the audit tail (cap_violations,
    # static_violations, pair_violations, audit_violations = their sum,
    # which the validity contract holds at 0; carried; frontier).
    inc_info: dict | None = None
    # Bytes the call moved host -> device: the whole snapshot for a
    # cold solve or a lineage not resident on the engine's device, the
    # index lists and carry for a resident warm lineage.
    h2d_bytes: int = 0


@dataclasses.dataclass
class ExplainData:
    """The explained solve's provenance (JAX `ExplainData`): which gang
    placements rolled back, and for every evicted running pod which pod
    evicted it and in which commit round (parity: the evicting pod's
    pop-order step). auction_stats has one row per fast-mode preemption
    round (kernels/assign.EXPLAIN_AUCTION_STATS columns), zero rows
    included."""

    rolled: np.ndarray         # [P] bool: reverted by the gang gate
    evictor: np.ndarray        # [M] int32 preemptor pod index (-1)
    evict_round: np.ndarray    # [M] int32 commit-round key (-1)
    auction_stats: np.ndarray  # [rounds cap, N_STATS] f32


@dataclasses.dataclass
class ScoreBatchResult:
    feasible: np.ndarray       # [P, N] bool
    scores: np.ndarray         # [P, N] f32
    solve_seconds: float = 0.0


def _sat_tables(snap: ClusterSnapshot, ops: Ops = KERNELS):
    """(node atom satisfaction [A, N], member atom satisfaction [A, M+P]
    over running then pending pod labels), both K1, transposed. The
    member table is only read by the signature paths and is None at
    S = 0 (the JAX program drops it there too). A tenant batch gives
    [B, A, N] and [B, A, M+P]."""
    node_sat_t = ops.atom_sat(
        snap.atoms, snap.nodes.label_pairs, snap.nodes.label_keys,
        snap.nodes.label_nums,
    ).transpose(-2, -1).contiguous()
    member_sat_t = None
    if snap.sigs.key.shape[-1] > 0:
        member_sat_t = kpair.member_label_sat_t(snap, ops.atom_sat)
    return node_sat_t, member_sat_t


def ring_counts(cfg: EngineConfig, snap: ClusterSnapshot,
                member_sat_t: torch.Tensor | None, mesh,
                ops: Ops = KERNELS) -> torch.Tensor | None:
    """The initial [S, N] domain counts from the ring (ring.py, K25 a
    hop) when cfg.ring_counts is set and the snapshot has signatures,
    else None (JAX solve_core's branch): no pending pod placed yet."""
    if not cfg.ring_counts or snap.sigs.key.shape[-1] == 0:
        return None
    if mesh is None:
        raise ValueError("ring_counts=True needs a mesh: the ring rotates "
                         "signature blocks over the mesh's 'p' axis")
    P = snap.pods.valid.shape[-1]
    unplaced = torch.full((P,), -1, dtype=torch.int32,
                          device=snap.pods.valid.device)
    return ring_sig_counts(snap, member_sat_t, unplaced, mesh, ops.ring_hop)


def solve_core(cfg: EngineConfig, snap: ClusterSnapshot, ops: Ops = KERNELS,
               stats: RoundStats | None = None,
               static: StaticCtx | None = None, explain: bool = False,
               mesh=None, member_sat_t: torch.Tensor | None = None):
    """(assigned, chosen, used, order, commit_key, rounds, evicted) in
    either mode. Parity: commit_key is the rank in pop order, rounds = P.
    Fast: commit_key is each pod's commit round. stats collects the fast
    loops' host reads (and spans, when it times). static: a StaticCtx
    already made from a tableau (the warm path); the label tables and
    the tableau are then not computed, and member_sat_t (the tableau's)
    rides along for the ring. With cfg.ring_counts the initial pair
    counts come from the ring over `mesh` (`ring_counts`), bit for bit
    the dense counts. explain=True appends the provenance tuple
    (rolled, evictor, evict_round, auction_stats) of solve_sequential /
    solve_rounds; the rest is the same. A tenant batch
    (tenants.solve_many: a leading [B] axis on every leaf; signatures,
    gangs and preemption included) gives every output that axis, rounds
    [B]."""
    if static is None:
        tables = _sat_tables(snap, ops)
        member_sat_t = tables[1]
    else:
        tables = (None, None)
    init_counts = ring_counts(cfg, snap, member_sat_t, mesh, ops)
    if cfg.mode == "fast":
        return solve_rounds(cfg, snap, *tables, static=static, ops=ops,
                            stats=stats, explain=explain,
                            init_counts=init_counts)
    a, c, u, o, ev, *extras = solve_sequential(cfg, snap, *tables, ops=ops,
                                               static=static,
                                               explain=explain,
                                               init_counts=init_counts)
    rank = _rank_of(o)
    rounds = torch.full(o.shape[:-1], o.shape[-1], dtype=torch.int32,
                        device=o.device)
    return (a, c, u, o, rank, rounds, ev, *extras)


def _pack_solve(out) -> torch.Tensor:
    """Flatten a solve_core output into the ONE f32 result buffer
    (layout authority: Engine.unpack; with the provenance tuple,
    Engine.unpack_explained). Indices are exact in f32."""
    assigned, chosen, used, order, commit_key, rounds, ev, *extras = out
    parts = [
        assigned.to(torch.float32), chosen,
        order.to(torch.float32), commit_key.to(torch.float32),
        used.reshape(-1), ev.to(torch.float32),
        rounds.to(torch.float32)[None],
    ]
    for rolled, evictor, evict_round, astats in extras:
        parts += [rolled.to(torch.float32), evictor.to(torch.float32),
                  evict_round.to(torch.float32), astats.reshape(-1)]
    return torch.cat(parts)


def probe_core(cfg: EngineConfig, snap: ClusterSnapshot, kb: int,
               ops: Ops = KERNELS, mesh=None) -> torch.Tensor:
    """The provenance probe's flat buffer (kernels/explain.explain_probe)
    at top-kb: K1's label tables, K2's tableau (K9 with signatures),
    the ring's counts with cfg.ring_counts, then the probe."""
    node_sat_t, member_sat_t = _sat_tables(snap, ops)
    tab = build_tableau(cfg, snap, node_sat_t, member_sat_t, ops)
    return kexplain.explain_probe(
        cfg, snap, tab, kb, ops,
        init_counts=ring_counts(cfg, snap, member_sat_t, mesh, ops))


def score_core(cfg: EngineConfig, snap: ClusterSnapshot, masked: bool = False,
               ops: Ops = KERNELS, mesh=None):
    """ScoreBatch on the device: (feasible [P, N], score [P, N]); with
    masked, the score is -inf at infeasible cells. With cfg.ring_counts
    the running members' counts come from the ring over `mesh`."""
    node_sat_t, member_sat_t = _sat_tables(snap, ops)
    return score_batch(cfg, snap, node_sat_t, member_sat_t, masked=masked,
                       ops=ops, init_counts=ring_counts(cfg, snap,
                                                        member_sat_t, mesh,
                                                        ops))


def score_top1_core(cfg: EngineConfig, snap: ClusterSnapshot,
                    ops: Ops = KERNELS, mesh=None):
    """Each pod's best feasible node (lowest index among the maxima, -1
    if none), its score and whether any node is feasible, on the
    device."""
    _, masked = score_core(cfg, snap, masked=True, ops=ops, mesh=mesh)
    topv, topi, _ = ops.row_topk(masked, 1)
    any_feasible = topv[:, 0] > float("-inf")
    best = torch.where(any_feasible, topi[:, 0], -1)
    return best, topv[:, 0], any_feasible


def score_topk_core(cfg: EngineConfig, snap: ClusterSnapshot, kb: int,
                    ops: Ops = KERNELS, mesh=None):
    """Each pod's kb best feasible nodes, descending, ties to the lower
    index: (idx [P, kb] int32, -1 past the feasible ones; val [P, kb]
    f32, 0 there), on the device."""
    _, masked = score_core(cfg, snap, masked=True, ops=ops, mesh=mesh)
    topv, topi, _ = ops.row_topk(masked, kb)
    ok = torch.isfinite(topv)
    zero = torch.zeros((), dtype=topv.dtype, device=topv.device)
    return torch.where(ok, topi, -1), torch.where(ok, topv, zero)


def _pin(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor, enqueued on the current
    stream (the copy lands when the stream reaches it)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class PendingFetch:
    """A dispatched result on its way to the host (JAX `PendingFetch`).
    On a CUDA device the result buffers are copied into pinned host
    memory behind a CUDA event; `result()` waits on that event and
    decodes. On the CPU the result is there at dispatch."""

    def __init__(self, bufs, unpack: Callable[[list, float], Any],
                 t0: float):
        self._unpack = unpack
        self._t0 = t0
        self._event = None
        if bufs and bufs[0].device.type == "cuda":
            self._bufs = [_pin(b) for b in bufs]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._bufs = list(bufs)

    def result(self, timeout: float | None = None):
        """Wait for the copy and decode. `timeout` (seconds) raises
        concurrent.futures.TimeoutError if the copy has not landed in
        time (the work goes on; a later call may still succeed)."""
        ev = self._event
        if ev is not None:
            if timeout is None:
                ev.synchronize()
            else:
                deadline = time.perf_counter() + timeout
                while not ev.query():
                    if time.perf_counter() >= deadline:
                        raise concurrent.futures.TimeoutError(
                            f"device result not ready after {timeout} s")
                    time.sleep(min(1e-4, max(0.0, deadline
                                             - time.perf_counter())))
        return self._unpack([b.numpy() for b in self._bufs],
                            time.perf_counter() - self._t0)


@dataclasses.dataclass
class WarmState:
    """The carried state of one warm lineage (JAX `WarmState`): its
    device-resident tableau and the facts that decide whether it may be
    trusted next cycle. Held by the lineage (`commit_warm`), read only by
    `Engine.solve_warm_async`."""

    tableau: WarmTableau
    lineage: Any       # the lineage's warm_lineage token at build time
    shapes: tuple      # snapshot leaf shapes the tableau was built at
    engine: Any        # the Engine that built it


class Engine:
    """Scheduling engine on one CUDA device, in parity or fast mode.

    device: "cuda" (the default) or a CUDA device; "cpu" runs every
    kernel's plain version instead, for tests. Without CUDA the default
    raises: the engine never falls back to the CPU by itself.

    mesh: a `mesh.Mesh` this rank belongs to; the engine then runs on
    the mesh's device (a `device` that differs raises). It is required
    by cfg.ring_counts, whose initial pair counts come from the ring over
    the mesh's p axis (ring.py); every rank of the mesh makes the same
    calls, and each runs the rest of the solve whole on its own device
    (the passes JAX shards over p and n are ROADMAP A14b)."""

    def __init__(self, config: EngineConfig | None = None,
                 device: "str | torch.device | None" = None, mesh=None):
        self.config = config or EngineConfig()
        self.mesh = mesh
        cfg = self.config
        if cfg.mode not in ("parity", "fast"):
            raise ValueError(f"mode={cfg.mode!r}: want 'parity' or 'fast'")
        if cfg.ring_counts and mesh is None:
            raise ValueError(
                "ring_counts=True needs Engine(mesh=...): the ring rotates "
                "signature blocks over the mesh's 'p' axis")
        if cfg.tie_break not in ("first", "seeded"):
            raise NotImplementedError(
                f"tie_break={cfg.tie_break!r}: want 'first' or 'seeded'")
        device = mesh_device(mesh, device)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: the engine runs on the GPU; pass "
                    "device='cpu' explicitly to run the plain versions")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device={device!r}: want 'cuda' or 'cpu'")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._sms = None
        if self.device.type == "cuda":
            check_config(cfg)
            self._sms = torch.cuda.get_device_properties(
                self.device).multi_processor_count

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

    def _resident(self, snap) -> bool:
        """snap is the port's snapshot with its leaves on this device."""
        return (isinstance(snap, ClusterSnapshot)
                and snap.pods.valid.device == self.device)

    def put(self, snap) -> ClusterSnapshot:
        """Host -> device transfer of every leaf. A snapshot of another
        package (any object with the ClusterSnapshot field tree and
        array leaves, such as the JAX package's) is read through numpy
        first."""
        return self._put(snap)[0]

    def _put(self, snap) -> tuple[ClusterSnapshot, int]:
        """put(snap) and the bytes it moved host -> device (0 for a
        snapshot already on this device). On the card, a snapshot past
        one of its limits is refused by name first (limits.py)."""
        if self._sms is not None:
            check_card_limits(self.config, snap, self._sms)
        if self._resident(snap):
            return snap, 0
        if not isinstance(snap, ClusterSnapshot):
            snap = snapshot_from_numpy(snap)
        dsnap = snap.to(self.device)
        return dsnap, dsnap.nbytes

    def solve(self, snap) -> SolveResult:
        """Assign every pending pod (or -1). The time covers the
        transfer in, the solve and the device -> host read of the
        result buffer, which waits for the device."""
        return self.solve_async(snap).result()

    def solve_async(self, snap) -> PendingFetch:
        """Dispatch the solve; `.result()` waits for the one flat result
        buffer and decodes it (a SolveResult)."""
        t0 = time.perf_counter()
        dsnap, moved = self._put(snap)
        stats = RoundStats()
        buf = _pack_solve(solve_core(self.config, dsnap, stats=stats,
                                     mesh=self.mesh))

        def unpack(raw, seconds):
            out = self.unpack(dsnap, raw[0])
            out.host_reads = stats.host_reads
            out.h2d_bytes = moved
            out.solve_seconds = seconds
            return out

        return PendingFetch([buf], unpack, t0)

    # -- decision provenance ------------------------------------------------

    @staticmethod
    def unpack_explained(snap: ClusterSnapshot, buf):
        """Decode the explained solve's buffer: the solve layout
        (Engine.unpack), then the provenance. Returns (SolveResult,
        ExplainData)."""
        buf = np.asarray(buf)
        P = snap.pods.valid.shape[0]
        N, R = snap.nodes.used.shape
        M = snap.running.valid.shape[0]
        std = 4 * P + N * R + M + 1
        res = Engine.unpack(snap, buf[:std])
        off = std
        rolled = buf[off:off + P] > 0
        off += P
        evictor = buf[off:off + M].astype(np.int32)
        off += M
        evict_round = buf[off:off + M].astype(np.int32)
        off += M
        astats = buf[off:].reshape(_PREEMPT_MAX_ROUNDS,
                                   len(EXPLAIN_AUCTION_STATS))
        return res, ExplainData(rolled=rolled, evictor=evictor,
                                evict_round=evict_round,
                                auction_stats=astats)

    def solve_explained_async(self, snap, k: int = 3):
        """Dispatch the explained solve and the provenance probe: returns
        (pending_solve, pending_probe), the first joining to
        (SolveResult, ExplainData), the second to a ScoreExplain with
        top-k columns (k clipped to [1, N]). The probe ranks the power of
        two at or above k and keeps the first k, which equal a direct
        top-k. The placements, order, commit keys, rounds and host reads
        equal solve()'s."""
        cfg = self.config
        t0 = time.perf_counter()
        dsnap, moved = self._put(snap)
        stats = RoundStats()
        buf = _pack_solve(solve_core(cfg, dsnap, stats=stats, explain=True,
                                     mesh=self.mesh))
        N = max(int(dsnap.nodes.valid.shape[0]), 1)
        kk = min(max(int(k), 1), N)
        kb = self._k_bucket(kk, N)
        probe = probe_core(cfg, dsnap, kb, mesh=self.mesh)

        def unpack_solve(raw, seconds):
            res, exd = self.unpack_explained(dsnap, raw[0])
            res.host_reads = stats.host_reads
            res.h2d_bytes = moved
            res.solve_seconds = seconds
            return res, exd

        def unpack_probe(raw, _seconds):
            se = kexplain.unpack_probe(dsnap, raw[0], kb)
            if kb == kk:
                return se
            return dataclasses.replace(
                se, k=kk, topk_idx=se.topk_idx[:, :kk],
                topk_score=se.topk_score[:, :kk],
                topk_terms=se.topk_terms[:, :kk, :])

        return (PendingFetch([buf], unpack_solve, t0),
                PendingFetch([probe], unpack_probe, t0))

    def solve_explained(self, snap, k: int = 3):
        """Blocking form: (SolveResult, ExplainData, ScoreExplain)."""
        p_solve, p_probe = self.solve_explained_async(snap, k)
        res, exd = p_solve.result()
        return res, exd, p_probe.result()

    def score(self, snap) -> ScoreBatchResult:
        """ScoreBatch: [P, N] feasibility + normalized weighted scores
        against the snapshot's usage, no commits."""
        return self.score_async(snap).result()

    def score_async(self, snap) -> PendingFetch:
        """Async form of score(): `.result()` is a ScoreBatchResult."""
        t0 = time.perf_counter()
        feasible, scores = score_core(self.config, self.put(snap),
                                      mesh=self.mesh)

        def unpack(raw, seconds):
            return ScoreBatchResult(feasible=raw[0], scores=raw[1],
                                    solve_seconds=seconds)

        return PendingFetch([feasible, scores], unpack, t0)

    def score_top1(self, snap):
        """Each pod's best node (-1 if none is feasible), its score and
        feasibility: (best [P] int32, score [P] f32, feasible [P] bool,
        seconds). The [P, N] matrix stays on the device."""
        t0 = time.perf_counter()
        best, mx, anyf = score_top1_core(self.config, self.put(snap),
                                         mesh=self.mesh)
        return (best.cpu().numpy(), mx.cpu().numpy(), anyf.cpu().numpy(),
                time.perf_counter() - t0)

    # The power of two at or above k, at most n: the device ranks this
    # many columns and the caller keeps the first k, which equal a direct
    # top-k (the ranking is a descending sort). The queue's window shares
    # the bucket.
    _k_bucket = staticmethod(k_bucket)

    def score_topk(self, snap, k: int):
        """Each pod's best k feasible nodes, descending (ties to the
        lower index), and their scores: (idx [P, k] int32 with -1 where
        fewer than k are feasible, scores [P, k] f32 with 0 there,
        seconds)."""
        return self.score_topk_async(snap, k).result()

    def score_topk_async(self, snap, k: int) -> PendingFetch:
        """Async form of score_topk: `.result()` -> (idx, val,
        seconds)."""
        k = int(k)
        N = snap.nodes.valid.shape[0]
        if not 1 <= k <= N:
            raise ValueError(f"top_k={k} out of range for {N} node slots")
        t0 = time.perf_counter()
        idx, val = score_topk_core(self.config, self.put(snap),
                                   self._k_bucket(k, N), mesh=self.mesh)

        def unpack(raw, seconds):
            return raw[0][:, :k], raw[1][:, :k], seconds

        return PendingFetch([idx, val], unpack, t0)

    # -- warm lineages ------------------------------------------------------

    @staticmethod
    def _pad_idx(idx) -> "np.ndarray | None":
        """A dirty index list padded to a power of two (the repeated
        first index carries identical content); None when empty."""
        return _pad_pow2(list(idx)) if idx else None

    @staticmethod
    def _shape_key(snap: ClusterSnapshot) -> tuple:
        return tuple(tuple(t.shape) for t in snap.leaves())

    @staticmethod
    def _frontier_bucket(est: int, P: int) -> int:
        """The frontier-compaction width for an estimated frontier of
        `est` pods: a power of two with 2x headroom, at least 64; 0 (full
        width) once it would reach the pod axis."""
        want = max(64, 2 * max(est, 1))
        cap = 1 << (want - 1).bit_length()
        return 0 if cap >= P else cap

    def unpack_incremental(self, snap: ClusterSnapshot, buf):
        """Decode the incremental solve's buffer: the solve layout, then
        the INC_AUDIT_LEN audit tail. Returns (SolveResult, info)."""
        buf = np.asarray(buf)
        res = Engine.unpack(snap, buf[:-INC_AUDIT_LEN])
        audit = buf[-INC_AUDIT_LEN:]
        info = dict(
            cap_violations=int(audit[0]),
            static_violations=int(audit[1]),
            pair_violations=int(audit[2]),
            audit_violations=int(audit[0] + audit[1] + audit[2]),
            carried=int(audit[3]),
            frontier=int(audit[4]),
        )
        return res, info

    def _tableau_cold(self, dsnap: ClusterSnapshot) -> WarmTableau:
        node_sat_t, member_sat_t = _sat_tables(dsnap)
        if member_sat_t is None:
            # The lineage carries the member table at S = 0 too, so a
            # later refresh has it (the JAX tableau always holds it).
            member_sat_t = kpair.member_label_sat_t(dsnap, KERNELS.atom_sat)
        return build_tableau(self.config, dsnap, node_sat_t, member_sat_t)

    def solve_warm_async(self, device, incremental: bool = False,
                         ) -> PendingFetch:
        """Solve a device-resident lineage (JAX `solve_warm_async`).
        `device` is a DeviceSnapshot (this package's, or any object with
        its interface). Its accumulated dirty state (`warm_delta()`)
        picks the rung:

          * cold: anything the row model cannot express (a rebuild,
            vocabulary growth, no tableau, a tableau of another lineage,
            engine or shape) builds the tableau from scratch and solves
            as `solve` does;
          * warm: the carried tableau is reordered and refreshed on its
            dirty rows and columns, then the solve runs from it, bitwise
            equal to a cold solve;
          * incremental (incremental=True, with a carry from the last
            warm result): `solve_incremental` over the frontier, held to
            the validity contract (SolveResult.inc_info).

        The new tableau is committed to the lineage at dispatch
        (`commit_warm`); the result becomes the lineage's carry at join
        (`commit_carry`). A lineage whose leaves are not tensors on this
        engine's device is read through numpy and sent whole, every
        cycle; SolveResult.h2d_bytes counts it. With cfg.ring_counts the
        cold and warm rungs take the ring's counts (the member table from
        the tableau); the incremental rung raises NotImplementedError, as
        JAX's does."""
        cfg = self.config
        if incremental and cfg.ring_counts:
            raise NotImplementedError(
                "incremental warm solve does not support ring_counts")
        t0 = time.perf_counter()
        dsnap, moved = self._put(device.snap)
        delta = device.warm_delta()
        warm = device.warm_state
        shapes = self._shape_key(dsnap)
        reason = None
        if delta.needs_cold:
            reason = delta.reason or "needs_cold"
        elif warm is None:
            reason = "no_tableau"
        elif warm.lineage is not device.warm_lineage:
            reason = "lineage_mismatch"
        elif warm.engine is not self:
            reason = "engine_mismatch"
        elif warm.shapes != shapes:
            reason = "shape_change"
        carry = device.carry_arrays() if incremental else None
        stats = RoundStats()
        dev = self.device

        def idx(a):
            nonlocal moved
            if a is None:
                return None
            a = np.asarray(a, np.int32)
            moved += a.nbytes
            return torch.from_numpy(a).to(dev).long()

        inc_run = False
        if reason is not None:
            tab = self._tableau_cold(dsnap)
            out = solve_core(cfg, dsnap, stats=stats,
                             static=finalize_static(cfg, dsnap, tab),
                             mesh=self.mesh, member_sat_t=tab.member_sat_t)
            buf = _pack_solve(out)
            path, rows = "cold", (0, 0, 0)
        else:
            rows = (len(delta.dirty_pods or ()),
                    len(delta.dirty_nodes or ()),
                    len(delta.dirty_members or ()))
            tab = refresh_tableau(
                cfg, dsnap, warm.tableau,
                dirty_pods=idx(self._pad_idx(delta.dirty_pods)),
                dirty_nodes=idx(self._pad_idx(delta.dirty_nodes)),
                dirty_members=idx(self._pad_idx(delta.dirty_members)),
                pod_perm=idx(delta.pod_perm), node_perm=idx(delta.node_perm),
                member_perm=idx(delta.member_perm))
            if incremental and carry is not None:
                carry_arr, chosen_arr = carry
                P = dsnap.pods.valid.shape[0]
                frontier = np.zeros(P, bool)
                if delta.dirty_pods:
                    frontier[np.asarray(delta.dirty_pods, np.int32)] = True
                dnode = None
                if delta.dirty_nodes:
                    dnode = np.zeros(dsnap.nodes.valid.shape[0], bool)
                    dnode[np.asarray(delta.dirty_nodes, np.int32)] = True
                    moved += dnode.nbytes
                # The estimate counts real rows only (padding reads as
                # carry -1 and would push it over a power of two).
                n_real = len(device.meta.pod_names)
                est = (int(frontier[:n_real].sum())
                       + int((np.asarray(carry_arr)[:n_real] < 0).sum()))
                moved += frontier.nbytes + 8 * P
                out = solve_incremental(
                    cfg, dsnap, tab,
                    torch.from_numpy(np.asarray(carry_arr, np.int32)).to(dev),
                    torch.from_numpy(np.asarray(chosen_arr,
                                                np.float32)).to(dev),
                    torch.from_numpy(frontier).to(dev),
                    None if dnode is None else torch.from_numpy(dnode).to(dev),
                    self._frontier_bucket(est, P), stats=stats)
                buf = torch.cat([_pack_solve(out[:7]), out[7]])
                path, inc_run = "incremental", True
            else:
                out = solve_core(cfg, dsnap, stats=stats,
                                 static=finalize_static(cfg, dsnap, tab),
                                 mesh=self.mesh,
                                 member_sat_t=tab.member_sat_t)
                buf = _pack_solve(out)
                path = "warm"
        device.commit_warm(
            WarmState(tableau=tab, lineage=device.warm_lineage,
                      shapes=shapes, engine=self),
            path=path, reason=reason or "", rows=rows)
        # The carry maps by name: capture the name orders of the snapshot
        # this dispatch solves.
        pod_names = list(device.meta.pod_names)
        node_names = list(device.meta.node_names)

        def unpack(raw, seconds):
            if inc_run:
                res, res.inc_info = self.unpack_incremental(dsnap, raw[0])
            else:
                res = self.unpack(dsnap, raw[0])
            res.host_reads = stats.host_reads
            res.h2d_bytes = moved
            res.solve_seconds = seconds
            device.commit_carry(pod_names, node_names, res.assignment,
                                np.asarray(res.chosen_score))
            return res

        return PendingFetch([buf], unpack, t0)

    def solve_warm(self, device, incremental: bool = False) -> SolveResult:
        """Blocking form of solve_warm_async."""
        return self.solve_warm_async(device, incremental=incremental).result()

    def close(self) -> None:
        """Nothing to release: the engine holds no thread or handle."""
