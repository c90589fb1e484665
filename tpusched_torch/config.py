"""Engine configuration: resource axes, static shape buckets, plugin weights.

A copy of the JAX package's `tpusched/config.py` (minus the simulator
config and the YAML loader), kept here so this package never imports
`tpusched`: importing any `tpusched` module runs its `__init__`, which
imports JAX. `EngineConfig.from_dict` takes the same dict, so one
config drives both engines. Knobs that only the JAX engine reads
(`mesh_shape`, `ring_counts`, `compact_cap`, `max_rounds`) are kept so
the dicts stay interchangeable; the port refuses the modes it does not
implement yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# ---------------------------------------------------------------------------
# Resource axes.
#
# The device-side resource dimension R is a fixed, configured list of
# resource names. The first three are always present and always in this
# order; extended resources (gpus, custom devices) append after.
# "pods" is modelled as an ordinary resource with request == 1 for every
# pod, which turns the node pod-count cap into the same <= comparison as
# cpu/memory (upstream NodeResourcesFit semantics, SURVEY.md C2).
# ---------------------------------------------------------------------------

RESOURCE_CPU = "cpu"          # millicores
RESOURCE_MEMORY = "memory"    # bytes
RESOURCE_PODS = "pods"        # count; every pod requests exactly 1

DEFAULT_RESOURCES: tuple[str, ...] = (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS)

# Default per-resource weights for the LeastRequested score, matching the
# upstream NodeResourcesFit default of cpu:1 memory:1 (the "pods" axis does
# not participate in scoring upstream, weight 0).
DEFAULT_SCORE_RESOURCE_WEIGHTS: Mapping[str, float] = {
    RESOURCE_CPU: 1.0,
    RESOURCE_MEMORY: 1.0,
    RESOURCE_PODS: 0.0,
}

MAX_NODE_SCORE = 100.0  # upstream framework.MaxNodeScore

# Taint effects (int8 codes on device).
EFFECT_NO_SCHEDULE = 0
EFFECT_PREFER_NO_SCHEDULE = 1
EFFECT_NO_EXECUTE = 2
TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")

# Match-expression operators (int8 codes on device).
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")

# whenUnsatisfiable codes for topology spread.
DO_NOT_SCHEDULE = 0
SCHEDULE_ANYWAY = 1

# QoS defaults, threaded through every layer that parses pod records
# (kube annotations, host records, the wire codec): slo_target 0 means
# "no availability SLO" (pressure is always 0), and a pod with no
# observed-availability history is OPTIMISTICALLY compliant (1.0) until
# lifecycle accounting produces a real number — the never-scheduled
# fallback the sim's closed loop and the kube annotation default share.
DEFAULT_SLO_TARGET = 0.0
DEFAULT_OBSERVED_AVAIL = 1.0


def _next_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def _next_bucket(x: int) -> int:
    """Bucket size policy: powers of two up to 2048, then multiples of
    1024. Pure pow2 pads a 10k x 5k problem to 16384 x 8192 — 2.7x the
    arithmetic and HBM traffic for nothing. Multiples of 1024 keep the
    distinct-shape count (recompiles) bounded while capping padding
    overhead at ~10% for large axes. Kept identical to the JAX package
    so both builders pad to the same shapes."""
    if x <= 2048:
        return _next_pow2(x)
    return ((x + 1023) // 1024) * 1024


@dataclasses.dataclass(frozen=True)
class Buckets:
    """Static device-side array sizes.

    Builders pad every axis up to these sizes, the JAX package's
    buckets, so both packages see the same shapes (the JAX engine
    compiles one program per shape tuple). Padding rows/cols are masked
    so they can never win an argmax.
    """

    pods: int = 128            # P: pending pods
    nodes: int = 128           # N: candidate nodes
    running_pods: int = 256    # M: bound pods (preemption victims, affinity)
    node_labels: int = 16      # LN: label (key,value) pairs per node
    pod_labels: int = 8        # LP: label pairs per pod
    node_taints: int = 4       # TN: taints per node
    atoms: int = 64            # A: distinct match-expression atoms
    atom_values: int = 8       # VA: values per In/NotIn atom
    terms: int = 4             # T: nodeSelectorTerms per pod (OR)
    term_atoms: int = 4        # AT: expressions per term (AND)
    pref_terms: int = 4        # PT: preferred affinity terms per pod
    topo_keys: int = 4         # TK: distinct topology keys in play
    spread_constraints: int = 2  # C: topology-spread constraints per pod
    affinity_terms: int = 2    # IT: inter-pod (anti)affinity terms per pod
    pod_groups: int = 64       # G: distinct gangs (pod groups)
    taint_vocab: int = 16      # VT: distinct taints across the cluster
    signatures: int = 8        # S: distinct (topo key, ns, selector) signatures
    sig_namespaces: int = 2    # NSV: explicit namespace ids per signature
    pdb_groups: int = 8        # GP: distinct PodDisruptionBudgets

    @staticmethod
    def fit(
        n_pods: int,
        n_nodes: int,
        n_running: int = 0,
        min_pods: int = 8,
        min_nodes: int = 8,
        **overrides: int,
    ) -> "Buckets":
        """Smallest bucket set covering the given counts (pow2 up to
        2048, multiples of 1024 above — see _next_bucket)."""
        base = Buckets(
            pods=max(min_pods, _next_bucket(n_pods)),
            nodes=max(min_nodes, _next_bucket(n_nodes)),
            running_pods=max(8, _next_bucket(max(1, n_running))),
        )
        return dataclasses.replace(base, **overrides) if overrides else base

    @staticmethod
    def minimal(n_pods: int, n_nodes: int, n_running: int = 0) -> "Buckets":
        """Like fit(), but every feature dimension starts at ZERO and only
        grows to what the snapshot actually uses (SnapshotBuilder grows
        them from observed need). Unused features then have 0-sized axes,
        and the traced program drops their kernels entirely (loops over
        `range(0)` vanish, empty gathers fold away) — at 10k x 5k the
        difference between milliseconds and tens of seconds."""
        return dataclasses.replace(
            Buckets.fit(n_pods, n_nodes, n_running),
            node_labels=0, pod_labels=0, node_taints=0, atoms=0,
            atom_values=0, terms=0, term_atoms=0, pref_terms=0,
            topo_keys=0, spread_constraints=0, affinity_terms=0,
            pod_groups=0, taint_vocab=0, signatures=0, sig_namespaces=0,
            pdb_groups=0,
        )

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Buckets":
        """Inverse of dataclasses.asdict for serialized bucket sets (the
        shape-class registry round-trips buckets through JSON). Unknown
        keys are rejected loudly: a registry written by a build with more
        axes must not silently deserialize into smaller shapes."""
        fields = {f.name for f in dataclasses.fields(Buckets)}
        extra = set(d) - fields
        if extra:
            raise ValueError(
                f"Buckets.from_dict: unknown bucket axes {sorted(extra)}"
            )
        return Buckets(**{k: int(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class PluginWeights:
    """Score-plugin weights, the analogue of the `weight` field on each
    entry of a scheduler-framework plugin profile (SURVEY.md C5).

    A weight of 0 disables the plugin's score contribution; filter
    plugins are structural and always on (as upstream defaults them).
    """

    least_requested: float = 1.0        # NodeResourcesFit/LeastAllocated (C3)
    balanced_allocation: float = 1.0    # NodeResourcesBalancedAllocation (C4)
    node_affinity: float = 1.0          # preferred node affinity terms
    taint_toleration: float = 1.0       # PreferNoSchedule taint counting
    topology_spread: float = 2.0        # upstream default weight is 2
    interpod_affinity: float = 1.0      # preferred pod (anti)affinity


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Parameters of the QoS-driven dynamic priority (SURVEY.md C10).

    priority(pod, t) = base_priority + qos_gain * pressure where
    pressure = clip(slo_target - observed_availability, 0, 1): how far the
    pod is *below* its availability SLO. Pods further below their SLO pop
    first and may preempt pods with positive slack (above their SLO).
    """

    qos_gain: float = 1000.0
    # Pressure also interpolates per-pod plugin weights between the
    # configured ("balanced") profile and a pure least-requested
    # ("place me fast") profile: effective_w = (1-p)*w + p*w_urgent.
    urgency_reweight: bool = True
    # A preemptor's effective priority must exceed a victim's effective
    # priority (victim: priority + qos_gain * clip(-slack, 0, 1), i.e. a
    # victim below its SLO is boosted) by this margin to evict it.
    preemption_margin: float = 0.0
    # Eviction cost (SURVEY.md C9: "eviction cost = victim's QoS slack"):
    #   cost(victim) = eff_priority(victim) - evict_slack_weight
    #                  * clip(slack, 0, 1)
    # so among equal-priority victims, the one furthest ABOVE its SLO is
    # cheapest. Costs are shifted positive per snapshot (+1 per victim),
    # which also encodes the upstream "fewer victims" preference.
    evict_slack_weight: float = 100.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    resources: tuple[str, ...] = DEFAULT_RESOURCES
    score_resource_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SCORE_RESOURCE_WEIGHTS)
    )
    weights: PluginWeights = dataclasses.field(default_factory=PluginWeights)
    qos: QoSConfig = dataclasses.field(default_factory=QoSConfig)
    # "parity" = exactly-sequential commit, one pod after another in
    # dynamic-priority order (stock semantics). "fast" = round-based
    # batched commit.
    mode: str = "parity"
    # Fast-mode round cap (0: the automatic bound, 2 * P + 8).
    max_rounds: int = 0
    # PostFilter preemption: parity mode runs it inside the scan, fast
    # mode as batched auction rounds after its main rounds.
    preemption: bool = False
    # Tie-break among equal-score maxima: "first" = lowest node index;
    # "seeded" = the qos.tie_hash(tie_seed, pod) pick among the maxima,
    # bit-identical to the JAX engine and its oracle.
    tie_break: str = "first"
    tie_seed: int = 0
    # Multi-device knobs of the JAX engine (ROADMAP A14), kept so one
    # config dict drives both engines.
    mesh_shape: tuple[int, int] = (1, 1)
    ring_counts: bool = False
    compact_cap: int = -1

    def resource_index(self, name: str) -> int:
        return self.resources.index(name)

    def score_weights_vector(self) -> list[float]:
        return [float(self.score_resource_weights.get(r, 0.0)) for r in self.resources]

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "EngineConfig":
        """Build from a YAML/JSON-decoded mapping (KubeSchedulerConfiguration
        profile analogue); unknown keys rejected to catch typos."""
        kw: dict[str, Any] = {}
        if "resources" in d:
            kw["resources"] = tuple(d["resources"])
        if "score_resource_weights" in d:
            kw["score_resource_weights"] = dict(d["score_resource_weights"])
        if "weights" in d:
            kw["weights"] = PluginWeights(**d["weights"])
        if "qos" in d:
            kw["qos"] = QoSConfig(**d["qos"])
        for k in ("mode", "max_rounds", "tie_break", "tie_seed",
                  "preemption", "ring_counts", "compact_cap"):
            if k in d:
                kw[k] = d[k]
        if "mesh_shape" in d:
            kw["mesh_shape"] = tuple(d["mesh_shape"])
        extra = set(d) - {
            "resources", "score_resource_weights", "weights", "qos",
            "mode", "max_rounds", "tie_break", "tie_seed", "mesh_shape",
            "preemption", "ring_counts", "compact_cap",
        }
        if extra:
            raise ValueError(f"unknown EngineConfig keys: {sorted(extra)}")
        return EngineConfig(**kw)
