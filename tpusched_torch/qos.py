"""Dynamic QoS priority: the port of `tpusched/qos.py`.

    pressure(pod)  = clip(slo_target - observed_availability, 0, 1)
    priority(pod)  = base_priority + qos_gain * pressure

Pressure also reweights the score plugins per pod (urgency reweight):
a pod far below its SLO interpolates toward an all-least-requested
profile. Everything here is elementwise over [P] (over [M] for the
preemption victims) and stays plain torch;
the op order is the JAX package's, so every value is the same f32 on
the CPU (eager torch contracts no multiply-add into an FMA).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from tpusched_torch.config import DEFAULT_OBSERVED_AVAIL, EngineConfig

# Ages below this are "never observed": no 0/0 at the submission
# instant, and the pod keeps its default availability until time has
# passed.
MIN_OBSERVED_AGE_S = 1e-9

_PLUGINS = (
    "least_requested",
    "balanced_allocation",
    "node_affinity",
    "taint_toleration",
    "topology_spread",
    "interpod_affinity",
)

_MASK32 = 0xFFFFFFFF
_PRIME1 = 2654435761
_PRIME2 = 2246822519


def pressure_of(slo_target: Any, observed_avail: Any) -> Any:
    """Works on tensors and numpy arrays alike."""
    return (slo_target - observed_avail).clip(0.0, 1.0)


def effective_priority(cfg: EngineConfig, base_priority: Any,
                       slo_target: Any, observed_avail: Any) -> Any:
    return base_priority + cfg.qos.qos_gain * pressure_of(slo_target,
                                                          observed_avail)


def _clamp01(v: float, default: float) -> float:
    """v clipped to [0, 1]; a non-finite v gives `default`."""
    v = float(v)
    if not math.isfinite(v):
        return float(default)
    return min(max(v, 0.0), 1.0)


def observed_availability(submitted: float, run_seconds: float,
                          bound_at: "float | None", now: float,
                          default: float = DEFAULT_OBSERVED_AVAIL) -> float:
    """Availability of one pod at `now`: banked run time plus the current
    run (since bound_at; None while pending) over its age. A pod younger
    than MIN_OBSERVED_AGE_S returns `default`."""
    age = now - submitted
    if age < MIN_OBSERVED_AGE_S:
        return float(default)
    run = float(run_seconds)
    if bound_at is not None:
        run += max(now - bound_at, 0.0)
    return _clamp01(run / age, default)


def priority_terms(cfg: EngineConfig, base_priority: Any, slo_target: Any,
                   observed_avail: Any) -> dict[str, Any]:
    """The dynamic priority's terms: base + qos_boost == effective,
    computed as effective_priority computes it (same op order)."""
    p = pressure_of(slo_target, observed_avail)
    return {
        "base": base_priority,
        "pressure": p,
        "qos_boost": cfg.qos.qos_gain * p,
        "effective": base_priority + cfg.qos.qos_gain * p,
    }


def slack_of(slo_target: Any, observed_avail: Any) -> Any:
    return observed_avail - slo_target


def base_weights(cfg: EngineConfig) -> dict[str, float]:
    return {p: float(getattr(cfg.weights, p)) for p in _PLUGINS}


def effective_weights(cfg: EngineConfig,
                      pressure: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-pod plugin weights, [P] each. With urgency_reweight,
    interpolate between the configured profile and the urgent one by
    QoS pressure: (1 - p) * w + p * w_urgent."""
    w = base_weights(cfg)
    if not cfg.qos.urgency_reweight:
        return {k: v + 0.0 * pressure for k, v in w.items()}
    total = sum(w.values())
    urgent = {p: (total if p == "least_requested" else 0.0) for p in _PLUGINS}
    return {
        p: (1.0 - pressure) * w[p] + pressure * urgent[p] for p in _PLUGINS
    }


def tie_hash(seed: int, pod_index: Any) -> Any:
    """Deterministic per-pod 32-bit mix for the "seeded" tie-break,
    bit-identical to the JAX package's uint32 version. A Python int
    gives a Python int; a tensor gives an int64 tensor holding the
    uint32 value. The tensor path works in int64 masked to 32 bits
    because torch on the CPU refuses uint32 `+` and `>>`."""
    if isinstance(pod_index, int):
        x = (seed * _PRIME1 + pod_index * _PRIME2) & _MASK32
        x ^= x >> 16
        x = (x * _PRIME2) & _MASK32
        x ^= x >> 13
        return x
    # Each product of two values < 2^32 would overflow int64, so the
    # multiplications split the constant into 16-bit halves.
    x = pod_index.to(torch.int64) & _MASK32
    x = (_mul32(x, _PRIME2) + ((seed & _MASK32) * _PRIME1 & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _PRIME2)
    x = x ^ (x >> 13)
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without overflow."""
    lo = (x * (c & 0xFFFF)) & _MASK32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def victim_effective_priority(cfg: EngineConfig, priority: Any,
                              slack: Any) -> Any:
    """A running pod below its SLO (negative slack) gets the boost a
    pending pod would: pressure = clip(-slack, 0, 1). Two roundings (the
    product, then the sum), as the oracle computes it."""
    pressure = (-slack).clip(0.0, 1.0)
    return priority + cfg.qos.qos_gain * pressure


def evict_cost_raw(cfg: EngineConfig, priority: Any, slack: Any) -> Any:
    """Eviction cost before the per-snapshot positive shift: the victim's
    effective priority less evict_slack_weight times how far above its
    SLO it runs (victims with QoS to spare are cheap)."""
    return (victim_effective_priority(cfg, priority, slack)
            - cfg.qos.evict_slack_weight * slack.clip(0.0, 1.0))
