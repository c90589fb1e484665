"""The device-resident pending queue's ranking: the port of
`tpusched/kernels/queue.py`.

A [Q] pending table (struct of arrays, `QueueTable`) holds each waiting
pod's QoS terms. Each cycle every slot's availability, pressure and
effective priority are derived anew on the device, and the slots are
ranked under the ordering contract

    (eligible first,  effective_priority DESC,  arrival seq ASC)

`rank_full` gives the whole order, `window_select` its first kb slots
(the solve window); both run kernel K21 (`queue_rank`, csrc/queue.cu),
whose plain version is `queue_rank_plain`. The numpy oracle
`reference_priorities` / `rank_reference` is the contract both are held
to, bit for bit.

Floats do not sort as their bits, so the priority key is the monotone
f32 -> u32 embedding `sortable_u32` (flip every bit of a negative, set
the sign bit of a non-negative), inverted for the descending leg. The
arrival sequence is a u32 stamped at submission: equal priorities pop in
arrival order. Torch on the CPU refuses uint32 `+`, `>>` and `<`, so the
tensor forms here work in int64 masked to 32 bits; the device table
holds `seq` as int32 with the u32's bits.

Times are f32 seconds relative to the owning queue's epoch. The priority
is `base + gain * pressure` with ONE rounding: the f32 product of two
f32s is exact in f64, so f64(base) + f64(gain) * f64(pressure) rounded
to f32 is the fused multiply-add that XLA on the CPU emits for the JAX
kernel, and what the oracle computes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import DEFAULT_OBSERVED_AVAIL
from tpusched_torch.kernels import check, ptrs, stream_of
from tpusched_torch.qos import MIN_OBSERVED_AGE_S

_MASK32 = 0xFFFFFFFF


class QueueTable(NamedTuple):
    """The [Q] pending table: numpy on the host (the queue's mirror),
    tensors on the device. Times are f32 seconds relative to the owning
    queue's epoch; a slot is eligible iff valid and parked_until <= now."""

    valid: "np.ndarray | torch.Tensor"          # bool[Q]  slot occupied
    base_priority: "np.ndarray | torch.Tensor"  # f32[Q]   pod.spec priority
    slo_target: "np.ndarray | torch.Tensor"     # f32[Q]   availability SLO
    submitted: "np.ndarray | torch.Tensor"      # f32[Q]   submit time
    run_seconds: "np.ndarray | torch.Tensor"    # f32[Q]   banked run time
    parked_until: "np.ndarray | torch.Tensor"   # f32[Q]   backoff; 0 = none
    tenant: "np.ndarray | torch.Tensor"         # i32[Q]   ingest tenant
    seq: "np.ndarray | torch.Tensor"            # u32[Q] (device: i32 bits)


N_FIELDS = len(QueueTable._fields)


def k_bucket(k: int, n: int) -> int:
    """The power of two at or above k, at most n: the window's size
    class (the engine's `_k_bucket`)."""
    kb = 1 << (max(int(k), 1) - 1).bit_length()
    return min(kb, int(n))


def empty_table(capacity: int) -> QueueTable:
    """An empty numpy table of `capacity` slots."""
    q = int(capacity)
    return QueueTable(
        valid=np.zeros(q, bool),
        base_priority=np.zeros(q, np.float32),
        slo_target=np.zeros(q, np.float32),
        submitted=np.zeros(q, np.float32),
        run_seconds=np.zeros(q, np.float32),
        parked_until=np.zeros(q, np.float32),
        tenant=np.zeros(q, np.int32),
        seq=np.zeros(q, np.uint32),
    )


def to_device(table: QueueTable, device) -> QueueTable:
    """A numpy table as tensors on `device` (seq as int32 bits)."""
    return QueueTable(*[
        torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in table])


def _tensors(table: QueueTable) -> QueueTable:
    """The table as tensors: numpy leaves go to the CPU."""
    if isinstance(table.valid, torch.Tensor):
        return table
    return to_device(QueueTable(*[np.asarray(a) for a in table]), "cpu")


def sortable_u32(prio):
    """Monotone f32 -> u32 key: a < b as floats iff sortable_u32(a) <
    sortable_u32(b) as unsigned (finite inputs). A numpy array gives a
    uint32 array; a tensor gives an int64 tensor holding the u32."""
    if isinstance(prio, torch.Tensor):
        u = prio.to(torch.float32).contiguous().view(torch.int32).to(
            torch.int64) & _MASK32
        sign = 0x80000000
        return torch.where(u >= sign, ~u & _MASK32, u | sign)
    u = np.ascontiguousarray(prio, dtype=np.float32).view(np.uint32)
    sign = np.uint32(0x80000000)
    return np.where(u >= sign, ~u, u | sign)


# -- K21: priority, keys, sort ----------------------------------------------


def _priorities_plain(t: QueueTable, now: float, qos_gain: float):
    """(prio [Q] f32, eligible [Q] bool) in reference_priorities' op
    order."""
    dev = t.valid.device
    f32 = torch.float32
    now_t = torch.tensor(now, dtype=f32, device=dev)
    age = now_t - t.submitted
    never = age < torch.tensor(MIN_OBSERVED_AGE_S, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    avail = torch.where(
        never, torch.tensor(DEFAULT_OBSERVED_AVAIL, dtype=f32, device=dev),
        (t.run_seconds / torch.where(never, one, age)).clamp(0.0, 1.0))
    pressure = (t.slo_target - avail).clamp(0.0, 1.0)
    prio = (t.base_priority.to(torch.float64)
            + float(qos_gain) * pressure.to(torch.float64)).to(f32)
    eligible = t.valid & (t.parked_until <= now_t)
    return prio, eligible


def queue_rank_plain(table: QueueTable, now: float, qos_gain: float,
                     kb: int | None = None):
    """K21's plain version: (idx, prio_out, n_eligible, depth). idx is the
    whole order [Q] (kb None) or its first kb slots; prio_out is every
    slot's priority [Q] (kb None) or the window's [kb]; the counts are
    0-d int32 tensors. The order: two stable sorts, by seq, then by the
    int64 key (ineligible << 32) | ~sortable_u32(prio), which is the
    contract's lexicographic order with ties in slot order."""
    t = _tensors(table)
    prio, eligible = _priorities_plain(t, now, qos_gain)
    k1 = ((~eligible).to(torch.int64) << 32) | (~sortable_u32(prio)
                                                  & _MASK32)
    seq = t.seq.to(torch.int64) & _MASK32
    o = torch.sort(seq, stable=True).indices
    o = o[torch.sort(k1[o], stable=True).indices].to(torch.int32)
    n_elig = eligible.sum().to(torch.int32)
    depth = t.valid.sum().to(torch.int32)
    if kb is None:
        return o, prio, n_elig, depth
    win = o[:kb]
    return win, prio[win.long()], n_elig, depth


def queue_rank(table: QueueTable, now: float, qos_gain: float,
               kb: int | None = None):
    """Kernel K21 on CUDA tensors, the plain version on CPU tensors."""
    t = _tensors(table)
    dev = t.valid.device
    if dev.type == "cpu":
        return queue_rank_plain(t, now, qos_gain, kb)
    k = "queue_rank"
    Q = t.valid.shape[0]
    for a, dt in zip(t, (torch.bool, torch.float32, torch.float32,
                         torch.float32, torch.float32, torch.float32,
                         torch.int32, torch.int32)):
        check(k, dev, a, dt, (Q,))
    n_out = Q if kb is None else min(int(kb), Q)
    Qp = 1 << max(Q - 1, 0).bit_length()
    prio = torch.empty(Q, dtype=torch.float32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    idx = torch.empty(n_out, dtype=torch.int32, device=dev)
    prio_out = (None if kb is None
                else torch.empty(n_out, dtype=torch.float32, device=dev))
    if Q == 0:
        return idx, prio if kb is None else prio_out, counts[0], counts[1]
    keys = torch.empty((2, Qp, 2), dtype=torch.int64, device=dev)
    _build.launch("tpusched_queue_rank", Q, Qp, n_out,
                  *ptrs((t.valid, t.base_priority, t.slo_target, t.submitted,
                         t.run_seconds, t.parked_until, t.seq)),
                  float(np.float32(now)), float(qos_gain),
                  *ptrs((prio, keys[0], keys[1], counts, idx, prio_out)),
                  stream_of(dev))
    queue_rank.launches += 1
    return idx, prio if kb is None else prio_out, counts[0], counts[1]


queue_rank.launches = 0


def rank_full(table: QueueTable, now, qos_gain):
    """Every slot in (eligible, priority desc, seq asc) order, with the
    per-slot priorities and the eligible and valid counts: (order [Q]
    int32, prio [Q] f32, n_eligible, depth)."""
    return queue_rank(table, float(now), float(qos_gain))


def window_select(table: QueueTable, now, qos_gain, kb: int):
    """The first kb slots of the full ranking (the solve window), on the
    device: (idx [kb], prio [kb], n_eligible, depth). kb is rounded up
    to a power of two, as JAX's compile cache keys it, and clamped to
    Q."""
    kb = 1 << (max(int(kb), 1) - 1).bit_length()
    return queue_rank(table, float(now), float(qos_gain), kb)


# -- the numpy oracle ---------------------------------------------------------


def reference_priorities(table: QueueTable, now: float,
                         qos_gain: float) -> np.ndarray:
    """The priorities in numpy, f32 op for op, the multiply-add rounded
    once (see the module docstring)."""
    submitted = np.asarray(table.submitted, np.float32)
    run = np.asarray(table.run_seconds, np.float32)
    slo = np.asarray(table.slo_target, np.float32)
    base = np.asarray(table.base_priority, np.float32)
    age = np.float32(now) - submitted
    never = age < np.float32(MIN_OBSERVED_AGE_S)
    avail = np.where(
        never,
        np.float32(DEFAULT_OBSERVED_AVAIL),
        np.clip(run / np.where(never, np.float32(1.0), age),
                np.float32(0.0), np.float32(1.0)),
    ).astype(np.float32)
    pressure = np.clip(slo - avail, np.float32(0.0),
                       np.float32(1.0)).astype(np.float32)
    fused = (base.astype(np.float64)
             + np.float64(qos_gain) * pressure.astype(np.float64))
    return fused.astype(np.float32)


def rank_reference(table: QueueTable, now: float, qos_gain: float):
    """The full ranking in numpy: np.lexsort (stable, last key primary)
    over the same three keys. Returns (order [Q], prio [Q], n_eligible,
    depth)."""
    prio = reference_priorities(table, now, qos_gain)
    valid = np.asarray(table.valid, bool)
    eligible = valid & (np.asarray(table.parked_until, np.float32)
                        <= np.float32(now))
    k_elig = np.where(eligible, np.uint32(0), np.uint32(1))
    k_prio = ~sortable_u32(prio)
    seq = np.asarray(table.seq, np.uint32)
    order = np.lexsort((seq, k_prio, k_elig)).astype(np.int32)
    return order, prio, int(eligible.sum()), int(valid.sum())
