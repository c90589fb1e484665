"""ClusterSnapshot: the cluster state as dataclasses of tensors.

The port of `tpusched/snapshot.py`. The field tree and every dtype are
the JAX package's, so a snapshot carries across in either direction
leaf by leaf: `snapshot_from_numpy` takes any object with this field
tree and numpy leaves (a JAX `ClusterSnapshot` after `jax.device_get`).

Encoding invariants (relied on by every kernel):
  * -1 is the universal padding id in any id array.
  * `valid` masks mark live rows; padded rows never win an argmax.
  * A nodeSelectorTerm with zero atoms is dropped at build (upstream: an
    empty term matches no objects); a pod with zero valid required
    terms has no required node affinity (matches all nodes).

`SnapshotBuilder` interns and pads in the JAX builder's order, so the
same records give identical arrays. It covers resources, QoS, labels
(numeric ones too), taints and tolerations, cordon, nodeSelector,
required/preferred node affinity, topology spread and inter-pod
(anti-)affinity with namespace scopes, including running pods' required
anti-affinity (the symmetric rule), pod groups (gangs, numbered in
sorted name order) and PodDisruptionBudgets of running pods (keyed by
(namespace, name), numbered in sorted key order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from tpusched_torch.config import (
    Buckets,
    DEFAULT_OBSERVED_AVAIL,
    DEFAULT_SLO_TARGET,
    EngineConfig,
    OPERATORS,
    RESOURCE_PODS,
    TAINT_EFFECTS,
    DO_NOT_SCHEDULE,
    SCHEDULE_ANYWAY,
    _next_bucket,
)

# ---------------------------------------------------------------------------
# Host-side spec structures (the "pod spec" surface a caller fills in).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatchExpression:
    """One matchExpressions entry: key op values, with the upstream
    operators In / NotIn / Exists / DoesNotExist / Gt / Lt."""

    key: str
    op: str
    values: tuple[str, ...] = ()

    def __post_init__(self):
        if self.op not in OPERATORS:
            raise ValueError(f"bad operator {self.op!r}; want one of {OPERATORS}")
        if self.op in ("Gt", "Lt") and len(self.values) != 1:
            raise ValueError(f"{self.op} needs exactly one value")


@dataclasses.dataclass(frozen=True)
class NodeSelectorTerm:
    expressions: tuple[MatchExpression, ...]


@dataclasses.dataclass(frozen=True)
class PreferredTerm:
    weight: float
    term: NodeSelectorTerm


@dataclasses.dataclass(frozen=True)
class Toleration:
    key: str = ""           # "" + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""        # "" matches all effects


@dataclasses.dataclass(frozen=True)
class TopologySpreadConstraint:
    topology_key: str
    max_skew: int
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    # Label selector over pods as match expressions (a matchLabels entry
    # is an In expression with one value).
    selector: tuple[MatchExpression, ...] = ()


@dataclasses.dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    selector: tuple[MatchExpression, ...] = ()
    anti: bool = False
    required: bool = True
    weight: float = 1.0      # only used when required=False
    # Namespace scope (upstream podAffinityTerm.namespaces): empty = the
    # owning pod's own namespace; ("*",) = all namespaces.
    namespaces: tuple[str, ...] = ()


def selector_from_labels(
        labels: Mapping[str, str]) -> tuple[MatchExpression, ...]:
    """matchLabels -> the equivalent In expressions."""
    return tuple(MatchExpression(k, "In", (v,))
                 for k, v in sorted(labels.items()))


# ---------------------------------------------------------------------------
# Device-side dataclasses of tensors.
# ---------------------------------------------------------------------------


class _Tree:
    """A dataclass of tensors (nested ones too) that moves as a whole."""

    def to(self, device, copy: bool = False) -> Any:
        """A copy with every leaf on `device` (leaves already there are
        shared unless `copy`)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, copy=copy)
            for f in dataclasses.fields(self)
        })

    def leaves(self) -> list:
        """Every tensor leaf, in field order (nested trees flattened)."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.extend(v.leaves() if isinstance(v, _Tree) else [v])
        return out

    @property
    def nbytes(self) -> int:
        """Bytes of every leaf (as a tensor's `nbytes`)."""
        return sum(t.nbytes for t in self.leaves())

    def tenant(self, b: int) -> Any:
        """Tenant b of a tree whose leaves carry a leading tenant axis
        (tenants.stack_snapshots): every leaf's b-th slice."""
        return self._map(lambda t: t[b])

    def as_batch(self) -> Any:
        """The tree as a batch of one tenant (a leading axis of 1)."""
        return self._map(lambda t: t.unsqueeze(0))

    def _map(self, fn) -> Any:
        return dataclasses.replace(self, **{
            f.name: (getattr(self, f.name)._map(fn)
                     if isinstance(getattr(self, f.name), _Tree)
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class AtomTable(_Tree):
    """Distinct match-expression atoms across the snapshot."""

    key: torch.Tensor    # [A] int32  key id (-1 pad)
    op: torch.Tensor     # [A] int8   OP_* code
    pairs: torch.Tensor  # [A, VA] int32  (key,value)-pair ids for In/NotIn
    num: torch.Tensor    # [A] f32    numeric bound for Gt/Lt
    valid: torch.Tensor  # [A] bool


@dataclasses.dataclass
class SigTable(_Tree):
    """Distinct (topology key, namespace scope, pod-label selector)
    signatures of the spread and inter-pod terms."""

    key: torch.Tensor     # [S] int32 topology-key index (-1 pad)
    atoms: torch.Tensor   # [S, AT] int32 selector atoms (-1 pad)
    ns: torch.Tensor      # [S, NSV] int32 namespace ids in scope (-1 pad)
    ns_all: torch.Tensor  # [S] bool: every namespace is in scope
    valid: torch.Tensor   # [S] bool


@dataclasses.dataclass
class NodeArrays(_Tree):
    allocatable: torch.Tensor  # [N, R] f32
    used: torch.Tensor         # [N, R] f32 (requests of bound pods)
    label_pairs: torch.Tensor  # [N, LN] int32 (-1 pad)
    label_keys: torch.Tensor   # [N, LN] int32 (-1 pad)
    label_nums: torch.Tensor   # [N, LN] f32 (numeric label value or NaN)
    taint_ids: torch.Tensor    # [N, TN] int32 into taint vocab (-1 pad)
    domain: torch.Tensor       # [N, TK] int32
    schedulable: torch.Tensor  # [N] bool: false = cordoned
    valid: torch.Tensor        # [N] bool


@dataclasses.dataclass
class PodArrays(_Tree):
    requests: torch.Tensor         # [P, R] f32
    base_priority: torch.Tensor    # [P] f32
    slo_target: torch.Tensor       # [P] f32
    observed_avail: torch.Tensor   # [P] f32
    tolerated: torch.Tensor        # [P, VT] bool
    label_pairs: torch.Tensor      # [P, LP] int32
    label_keys: torch.Tensor       # [P, LP] int32
    req_term_atoms: torch.Tensor   # [P, T, AT] int32 (-1 pad)
    req_term_valid: torch.Tensor   # [P, T] bool
    pref_term_atoms: torch.Tensor  # [P, PT, AT] int32
    pref_term_valid: torch.Tensor  # [P, PT] bool
    pref_weight: torch.Tensor      # [P, PT] f32
    ts_key: torch.Tensor           # [P, C] int32
    ts_max_skew: torch.Tensor      # [P, C] f32
    ts_when: torch.Tensor          # [P, C] int8
    ts_sel_atoms: torch.Tensor     # [P, C, AT] int32
    ts_sig: torch.Tensor           # [P, C] int32
    ts_valid: torch.Tensor         # [P, C] bool
    ia_key: torch.Tensor           # [P, IT] int32
    ia_sel_atoms: torch.Tensor     # [P, IT, AT] int32
    ia_sig: torch.Tensor           # [P, IT] int32
    ia_anti: torch.Tensor          # [P, IT] bool
    ia_required: torch.Tensor      # [P, IT] bool
    ia_weight: torch.Tensor        # [P, IT] f32
    ia_valid: torch.Tensor         # [P, IT] bool
    group: torch.Tensor            # [P] int32 (-1 = none)
    namespace: torch.Tensor        # [P] int32
    tolerates_unsched: torch.Tensor  # [P] bool
    valid: torch.Tensor            # [P] bool


@dataclasses.dataclass
class RunningPodArrays(_Tree):
    node_idx: torch.Tensor     # [M] int32 (-1 pad)
    requests: torch.Tensor     # [M, R] f32
    priority: torch.Tensor     # [M] f32
    slack: torch.Tensor        # [M] f32
    label_pairs: torch.Tensor  # [M, LP] int32
    label_keys: torch.Tensor   # [M, LP] int32
    anti_sig: torch.Tensor     # [M, IT] int32
    namespace: torch.Tensor    # [M] int32
    pdb_group: torch.Tensor    # [M] int32 (-1 = none)
    valid: torch.Tensor        # [M] bool


@dataclasses.dataclass
class ClusterSnapshot(_Tree):
    nodes: NodeArrays
    pods: PodArrays
    running: RunningPodArrays
    atoms: AtomTable
    sigs: SigTable
    taint_effect: torch.Tensor      # [VT] int8
    group_min_member: torch.Tensor  # [G] int32
    pdb_allowed: torch.Tensor       # [GP] f32


@dataclasses.dataclass
class SnapshotMeta:
    """Host-side decode tables (index -> name); never on the device."""

    node_names: list[str]
    pod_names: list[str]
    n_nodes: int
    n_pods: int
    n_running: int
    buckets: Buckets
    group_names: list[str]
    running_names: list[str] | None = None


def snapshot_from_numpy(tree: Any, cls: type = ClusterSnapshot) -> Any:
    """The port's snapshot from any object with the `ClusterSnapshot`
    field tree and numpy (or array-like) leaves — for instance the JAX
    package's snapshot after `jax.device_get`. Leaves keep their dtype
    and shape; CPU tensors come out (`.to(device)` moves them)."""
    kw = {}
    for f in dataclasses.fields(cls):
        leaf = getattr(tree, f.name)
        sub = _NESTED.get(f.name) if cls is ClusterSnapshot else None
        if sub is not None:
            kw[f.name] = snapshot_from_numpy(leaf, sub)
        else:
            kw[f.name] = torch.from_numpy(np.array(leaf, copy=True))
    return cls(**kw)


_NESTED = {
    "nodes": NodeArrays, "pods": PodArrays, "running": RunningPodArrays,
    "atoms": AtomTable, "sigs": SigTable,
}


# ---------------------------------------------------------------------------
# Builder: interning + padding, in the JAX builder's order.
# ---------------------------------------------------------------------------


def _try_float(s: str) -> float:
    try:
        return float(s)
    except (TypeError, ValueError):
        return float("nan")


class _Interner:
    """String -> id state of one build. Ids are assigned in first-seen
    order, the JAX builder's order, so both give the same arrays."""

    def __init__(self):
        self.key_ids: dict[str, int] = {}
        self.pair_ids: dict[tuple[str, str], int] = {}
        self.taint_ids: dict[tuple[str, str, str], int] = {}
        self.atom_ids: dict[tuple, int] = {}
        self.atoms: list[tuple[int, int, tuple[int, ...], float]] = []
        self.topo_keys: list[str] = []
        self.domain_ids: list[dict[str, int]] = []  # per key: value -> id
        self.ns_ids: dict[str, int] = {}
        self.sig_ids: dict[tuple, int] = {}
        # (key index, ns scope: "*" or a sorted tuple of ns ids, atoms)
        self.sigs: list[tuple[int, Any, tuple[int, ...]]] = []

    def kid(self, k: str) -> int:
        return self.key_ids.setdefault(k, len(self.key_ids))

    def pid(self, k: str, v: str) -> int:
        return self.pair_ids.setdefault((k, v), len(self.pair_ids))

    def tid(self, k: str, v: str, effect: str) -> int:
        if effect not in TAINT_EFFECTS:
            raise ValueError(f"bad taint effect {effect!r}")
        return self.taint_ids.setdefault((k, v, effect), len(self.taint_ids))

    def topo_idx(self, k: str) -> int:
        if k not in self.topo_keys:
            self.topo_keys.append(k)
            self.domain_ids.append({})
        return self.topo_keys.index(k)

    def nsid(self, ns: str) -> int:
        return self.ns_ids.setdefault(ns, len(self.ns_ids))

    def aid(self, expr: MatchExpression) -> int:
        op = OPERATORS.index(expr.op)
        k = self.kid(expr.key)
        if expr.op in ("In", "NotIn"):
            pids = tuple(sorted(self.pid(expr.key, v) for v in expr.values))
            num = float("nan")
        elif expr.op in ("Gt", "Lt"):
            pids = ()
            num = float(expr.values[0])
        else:
            pids = ()
            num = float("nan")
        # NaN never equals itself, so non-numeric atoms dedup on None.
        sig = (k, op, pids, num if num == num else None)
        if sig not in self.atom_ids:
            self.atom_ids[sig] = len(self.atoms)
            self.atoms.append((k, op, pids, num))
        return self.atom_ids[sig]

    def sid(self, key_idx: int, atoms_list: list[int], ns_scope) -> int:
        sig = (key_idx, ns_scope, tuple(sorted(atoms_list)))
        if sig not in self.sig_ids:
            self.sig_ids[sig] = len(self.sigs)
            self.sigs.append(sig)
        return self.sig_ids[sig]

    def ns_scope_of(self, namespaces: Sequence[str], own_ns: str):
        """An affinity term's namespace list resolved against the owning
        pod's namespace (empty = own namespace). Names are interned in
        sorted order, so ids do not depend on set iteration."""
        if not namespaces:
            return (self.nsid(own_ns),)
        if "*" in namespaces:
            return "*"
        return tuple(sorted(self.nsid(x) for x in sorted(set(namespaces))))

    def compile_pod(self, p: Mapping) -> dict:
        """Intern everything one pending pod references, in the JAX
        builder's order. nodeSelector is ANDed into every required term
        (or stands alone as one term)."""
        aid = self.aid
        sel_atoms = [
            aid(MatchExpression(k, "In", (v,)))
            for k, v in sorted(p["node_selector"].items())
        ]
        req_terms = []
        for t in p["required_terms"]:
            if not t.expressions:
                continue  # empty term matches no objects -> drop
            req_terms.append([aid(e) for e in t.expressions] + sel_atoms)
        if not req_terms and sel_atoms:
            req_terms = [sel_atoms]
        pref_terms = [
            ([aid(e) for e in pt.term.expressions], float(pt.weight))
            for pt in p["preferred_terms"] if pt.term.expressions
        ]
        own_ns = p["namespace"]
        ts = [
            dict(key=self.topo_idx(c.topology_key),
                 max_skew=float(c.max_skew),
                 when=DO_NOT_SCHEDULE
                 if c.when_unsatisfiable == "DoNotSchedule"
                 else SCHEDULE_ANYWAY,
                 atoms=[aid(e) for e in c.selector])
            for c in p["topology_spread"]
        ]
        for c in ts:
            # Spread counts only pods in the incoming pod's namespace.
            c["sig"] = self.sid(c["key"], c["atoms"], (self.nsid(own_ns),))
        ia = [
            dict(key=self.topo_idx(t.topology_key),
                 atoms=[aid(e) for e in t.selector],
                 anti=t.anti, required=t.required, weight=float(t.weight),
                 ns=self.ns_scope_of(t.namespaces, own_ns))
            for t in p["pod_affinity"]
        ]
        for t in ia:
            t["sig"] = self.sid(t["key"], t["atoms"], t["ns"])
        return dict(req_terms=req_terms, pref_terms=pref_terms, ts=ts, ia=ia)

    def compile_running_anti(self, rrec: Mapping) -> tuple[list[int], int]:
        """A running pod's required anti-affinity terms (the symmetric
        rule), interned into the pending terms' signature table: (sig
        ids, widest selector atom count)."""
        sigs_of_pod: list[int] = []
        atom_max = 0
        for t in rrec["pod_affinity"]:
            if not (t.anti and t.required):
                continue
            alist = [self.aid(e) for e in t.selector]
            atom_max = max(atom_max, len(alist))
            sigs_of_pod.append(self.sid(
                self.topo_idx(t.topology_key), alist,
                self.ns_scope_of(t.namespaces, rrec["namespace"]),
            ))
        return sigs_of_pod, atom_max

    def intern_labels(self, labels: Mapping[str, str]) -> None:
        for k, v in labels.items():
            self.kid(k)
            self.pid(k, v)


class SnapshotBuilder:
    """Accumulates node/pod records and emits a padded ClusterSnapshot
    of CPU tensors. Interning happens in build(), so records may arrive
    in any order and buckets fit the observed counts."""

    def __init__(self, config: EngineConfig, buckets: Buckets | None = None):
        self.config = config
        self.buckets = buckets
        self._nodes: list[dict] = []
        self._pods: list[dict] = []
        self._running: list[dict] = []
        self._groups: dict[str, int] = {}  # name -> min_member
        # (namespace, name) -> disruptions allowed
        self._pdbs: dict[tuple[str, str], int] = {}

    def add_node(
        self,
        name: str,
        allocatable: Mapping[str, float],
        labels: Mapping[str, str] | None = None,
        taints: Sequence[tuple[str, str, str]] = (),
        used: Mapping[str, float] | None = None,
        unschedulable: bool = False,
    ) -> None:
        """unschedulable: node.spec.unschedulable (kubectl cordon)."""
        alloc = dict(allocatable)
        alloc.setdefault(RESOURCE_PODS, 110.0)  # upstream kubelet default
        self._nodes.append(
            dict(name=name, allocatable=alloc, labels=dict(labels or {}),
                 taints=list(taints), used=dict(used or {}),
                 unschedulable=bool(unschedulable))
        )

    def add_pod(
        self,
        name: str,
        requests: Mapping[str, float],
        priority: float = 0.0,
        slo_target: float = DEFAULT_SLO_TARGET,
        observed_avail: float = DEFAULT_OBSERVED_AVAIL,
        labels: Mapping[str, str] | None = None,
        node_selector: Mapping[str, str] | None = None,
        required_terms: Sequence[NodeSelectorTerm] = (),
        preferred_terms: Sequence[PreferredTerm] = (),
        tolerations: Sequence[Toleration] = (),
        topology_spread: Sequence[TopologySpreadConstraint] = (),
        pod_affinity: Sequence[PodAffinityTerm] = (),
        pod_group: str | None = None,
        pod_group_min_member: int = 0,
        namespace: str = "default",
    ) -> None:
        """pod_group names the pod's gang; its min_member is the largest
        pod_group_min_member given for it."""
        req = dict(requests)
        req.setdefault(RESOURCE_PODS, 1.0)
        if pod_group is not None:
            prev = self._groups.get(pod_group, 0)
            self._groups[pod_group] = max(prev, int(pod_group_min_member))
        self._pods.append(
            dict(name=name, requests=req, priority=float(priority),
                 slo_target=float(slo_target),
                 observed_avail=float(observed_avail),
                 labels=dict(labels or {}),
                 node_selector=dict(node_selector or {}),
                 required_terms=list(required_terms),
                 preferred_terms=list(preferred_terms),
                 tolerations=list(tolerations),
                 topology_spread=list(topology_spread),
                 pod_affinity=list(pod_affinity),
                 pod_group=pod_group,
                 namespace=str(namespace) or "default")
        )

    def add_running_pod(
        self,
        node: str,
        requests: Mapping[str, float],
        priority: float = 0.0,
        slack: float = 0.0,
        labels: Mapping[str, str] | None = None,
        count_into_used: bool = True,
        pod_affinity: Sequence[PodAffinityTerm] = (),
        namespace: str = "default",
        pdb_group: str | None = None,
        pdb_disruptions_allowed: int = 0,
    ) -> None:
        """Only a running pod's required anti-affinity terms affect
        scheduling (the symmetric rule); its other terms are accepted
        and ignored, as in the JAX builder. pdb_group names the
        PodDisruptionBudget covering the pod; budgets are namespaced, so
        the budget is (namespace, pdb_group), and its remaining
        disruptions are the largest pdb_disruptions_allowed given for
        it."""
        req = dict(requests)
        req.setdefault(RESOURCE_PODS, 1.0)
        ns = str(namespace) or "default"
        if pdb_group is not None:
            key = (ns, pdb_group)
            prev = self._pdbs.get(key, 0)
            self._pdbs[key] = max(prev, int(pdb_disruptions_allowed))
        self._running.append(
            dict(node=node, requests=req, priority=float(priority),
                 slack=float(slack), labels=dict(labels or {}),
                 count_into_used=count_into_used,
                 pod_affinity=list(pod_affinity),
                 namespace=ns,
                 pdb_group=(ns, pdb_group) if pdb_group is not None
                 else None)
        )

    def build(self) -> tuple[ClusterSnapshot, SnapshotMeta]:
        snap, meta, _ = self.build_state()
        return snap, meta

    def build_state(self) -> "tuple[ClusterSnapshot, SnapshotMeta, BuiltState]":
        """build() plus the host state (interner, numpy mirrors, index
        maps) that DeviceSnapshot needs to apply O(churn) deltas to the
        arrays this call made. The snapshot's CPU tensors share memory
        with the mirrors."""
        cfg = self.config
        R = len(cfg.resources)
        n_nodes, n_pods, n_running = (
            len(self._nodes), len(self._pods), len(self._running))

        intr = _Interner()
        pod_compiled = [intr.compile_pod(p) for p in self._pods]
        run_anti: list[list[int]] = []
        run_anti_atom_max = 0
        for rrec in self._running:
            sigs_of_pod, am = intr.compile_running_anti(rrec)
            run_anti_atom_max = max(run_anti_atom_max, am)
            run_anti.append(sigs_of_pod)
        for nrec in self._nodes:
            intr.intern_labels(nrec["labels"])
            for (k, v, e) in nrec["taints"]:
                intr.tid(k, v, e)
        for rrec in self._running:
            intr.intern_labels(rrec["labels"])
            intr.nsid(rrec["namespace"])
        for p in self._pods:
            intr.intern_labels(p["labels"])
            intr.nsid(p["namespace"])
        atoms, sigs = intr.atoms, intr.sigs

        # Buckets start minimal (size-0 feature axes) and grow only to
        # observed need, by the JAX builder's rules.
        bk = self.buckets
        if bk is None:
            bk = Buckets.minimal(n_pods, n_nodes, n_running)
        need = dict(
            node_labels=max((len(n["labels"]) for n in self._nodes), default=0),
            pod_labels=max(
                [len(p["labels"]) for p in self._pods]
                + [len(r["labels"]) for r in self._running] or [0]
            ),
            node_taints=max((len(n["taints"]) for n in self._nodes), default=0),
            atoms=len(atoms),
            atom_values=max((len(a[2]) for a in atoms), default=0),
            terms=max((len(pc["req_terms"]) for pc in pod_compiled), default=0),
            term_atoms=max(
                [run_anti_atom_max]
                + [len(t) for pc in pod_compiled for t in pc["req_terms"]]
                + [len(t[0]) for pc in pod_compiled for t in pc["pref_terms"]]
                + [len(c["atoms"]) for pc in pod_compiled for c in pc["ts"]]
                + [len(t["atoms"]) for pc in pod_compiled for t in pc["ia"]]
            ),
            pref_terms=max((len(pc["pref_terms"]) for pc in pod_compiled),
                           default=0),
            topo_keys=len(intr.topo_keys),
            spread_constraints=max((len(pc["ts"]) for pc in pod_compiled),
                                   default=0),
            affinity_terms=max(
                [len(pc["ia"]) for pc in pod_compiled]
                + [len(a) for a in run_anti] or [0]
            ),
            pod_groups=len(self._groups),
            taint_vocab=len(intr.taint_ids),
            signatures=len(sigs),
            sig_namespaces=max(
                (len(ns) for _, ns, _ in sigs if ns != "*"), default=0
            ),
            pdb_groups=len(self._pdbs),
        )
        grow = {
            f: max(getattr(bk, f), _ceil_bucket(v))
            for f, v in need.items() if v > getattr(bk, f)
        }
        if grow:
            bk = dataclasses.replace(bk, **grow)
        if n_pods > bk.pods or n_nodes > bk.nodes or n_running > bk.running_pods:
            bk = dataclasses.replace(
                bk,
                pods=max(bk.pods, _ceil_bucket(n_pods)),
                nodes=max(bk.nodes, _ceil_bucket(n_nodes)),
                running_pods=max(bk.running_pods, _ceil_bucket(n_running)),
            )

        t = _tables_np(bk)
        for i, atom in enumerate(atoms):
            _fill_atom_row(t, i, atom)
        for (k, v, e), tid in intr.taint_ids.items():
            t["taint_effect"][tid] = TAINT_EFFECTS.index(e)
        for i, sig in enumerate(sigs):
            _fill_sig_row(t, i, sig)

        nodes = _nodes_np(bk, R)
        node_index = {}
        for i, nrec in enumerate(self._nodes):
            node_index[nrec["name"]] = i
            _fill_node_row(nodes, i, nrec, intr, cfg)

        # Gangs and budgets are numbered in sorted name order.
        group_list = sorted(self._groups)
        group_idx = {g: i for i, g in enumerate(group_list)}
        for g, gname in enumerate(group_list):
            t["group_min"][g] = self._groups[gname]
        pdb_idx = {g: i for i, g in enumerate(sorted(self._pdbs))}
        for key, g in pdb_idx.items():
            t["pdb_allowed"][g] = float(self._pdbs[key])

        pods = _pods_np(bk, R)
        for i, (p, pc) in enumerate(zip(self._pods, pod_compiled)):
            _fill_pod_row(pods, i, p, pc, intr, cfg, group_idx)

        run = _running_np(bk, R)
        for i, rrec in enumerate(self._running):
            _fill_running_row(run, i, rrec, run_anti[i], intr, cfg,
                              node_index, pdb_idx)
            # Counted requests fold into the node's used row in record
            # order, the JAX builder's summation order (DeviceSnapshot
            # re-sums a touched node's members in the same order).
            if rrec["count_into_used"]:
                ni = node_index[rrec["node"]]
                for r, rn in enumerate(cfg.resources):
                    nodes["used"][ni, r] += float(
                        rrec["requests"].get(rn, 0.0))

        snap = _snapshot_from_arrays(nodes, pods, run, t)
        meta = SnapshotMeta(
            node_names=[n["name"] for n in self._nodes],
            pod_names=[p["name"] for p in self._pods],
            n_nodes=n_nodes, n_pods=n_pods, n_running=n_running,
            buckets=bk, group_names=group_list,
        )
        state = BuiltState(
            interner=intr, nodes_np=nodes, pods_np=pods, run_np=run,
            tables=t, buckets=bk, node_index=node_index,
            group_idx=group_idx, pdb_idx=pdb_idx,
        )
        return snap, meta, state


@dataclasses.dataclass
class BuiltState:
    """The host state of one build, kept by DeviceSnapshot to re-encode
    churned rows in place: the interner, the numpy mirrors (dicts of
    arrays by field name; `tables` holds the atom, signature, taint,
    group and budget tables) and the index maps."""

    interner: _Interner
    nodes_np: dict
    pods_np: dict
    run_np: dict
    tables: dict
    buckets: Buckets
    node_index: dict
    group_idx: dict
    pdb_idx: dict


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _dc(cls: type, arrays: dict) -> Any:
    return cls(**{k: _t(v) for k, v in arrays.items()})


def _ceil_bucket(x: int) -> int:
    return _next_bucket(max(x, 1))


def _tables_np(bk: Buckets) -> dict:
    return dict(
        atom_key=np.full(bk.atoms, -1, np.int32),
        atom_op=np.zeros(bk.atoms, np.int8),
        atom_pairs=np.full((bk.atoms, bk.atom_values), -1, np.int32),
        atom_num=np.full(bk.atoms, np.nan, np.float32),
        atom_valid=np.zeros(bk.atoms, bool),
        sig_key=np.full(bk.signatures, -1, np.int32),
        sig_atoms=np.full((bk.signatures, bk.term_atoms), -1, np.int32),
        sig_ns=np.full((bk.signatures, bk.sig_namespaces), -1, np.int32),
        sig_ns_all=np.zeros(bk.signatures, bool),
        sig_valid=np.zeros(bk.signatures, bool),
        taint_effect=np.zeros(bk.taint_vocab, np.int8),
        group_min=np.zeros(bk.pod_groups, np.int32),
        pdb_allowed=np.zeros(bk.pdb_groups, np.float32),
    )


def _nodes_np(bk: Buckets, R: int) -> dict:
    N = bk.nodes
    return dict(
        allocatable=np.zeros((N, R), np.float32),
        used=np.zeros((N, R), np.float32),
        label_pairs=np.full((N, bk.node_labels), -1, np.int32),
        label_keys=np.full((N, bk.node_labels), -1, np.int32),
        label_nums=np.full((N, bk.node_labels), np.nan, np.float32),
        taint_ids=np.full((N, bk.node_taints), -1, np.int32),
        domain=np.full((N, bk.topo_keys), -1, np.int32),
        schedulable=np.zeros(N, bool),
        valid=np.zeros(N, bool),
    )


def _pods_np(bk: Buckets, R: int) -> dict:
    P, C, IT, AT = (bk.pods, bk.spread_constraints, bk.affinity_terms,
                    bk.term_atoms)
    return dict(
        requests=np.zeros((P, R), np.float32),
        base_priority=np.zeros(P, np.float32),
        slo_target=np.zeros(P, np.float32),
        observed_avail=np.ones(P, np.float32),
        tolerated=np.zeros((P, bk.taint_vocab), bool),
        label_pairs=np.full((P, bk.pod_labels), -1, np.int32),
        label_keys=np.full((P, bk.pod_labels), -1, np.int32),
        req_term_atoms=np.full((P, bk.terms, AT), -1, np.int32),
        req_term_valid=np.zeros((P, bk.terms), bool),
        pref_term_atoms=np.full((P, bk.pref_terms, AT), -1, np.int32),
        pref_term_valid=np.zeros((P, bk.pref_terms), bool),
        pref_weight=np.zeros((P, bk.pref_terms), np.float32),
        ts_key=np.full((P, C), -1, np.int32),
        ts_max_skew=np.zeros((P, C), np.float32),
        ts_when=np.zeros((P, C), np.int8),
        ts_sel_atoms=np.full((P, C, AT), -1, np.int32),
        ts_sig=np.full((P, C), -1, np.int32),
        ts_valid=np.zeros((P, C), bool),
        ia_key=np.full((P, IT), -1, np.int32),
        ia_sel_atoms=np.full((P, IT, AT), -1, np.int32),
        ia_sig=np.full((P, IT), -1, np.int32),
        ia_anti=np.zeros((P, IT), bool),
        ia_required=np.zeros((P, IT), bool),
        ia_weight=np.zeros((P, IT), np.float32),
        ia_valid=np.zeros((P, IT), bool),
        group=np.full(P, -1, np.int32),
        namespace=np.full(P, -1, np.int32),
        tolerates_unsched=np.zeros(P, bool),
        valid=np.zeros(P, bool),
    )


def _running_np(bk: Buckets, R: int) -> dict:
    M = bk.running_pods
    return dict(
        node_idx=np.full(M, -1, np.int32),
        requests=np.zeros((M, R), np.float32),
        priority=np.zeros(M, np.float32),
        slack=np.zeros(M, np.float32),
        label_pairs=np.full((M, bk.pod_labels), -1, np.int32),
        label_keys=np.full((M, bk.pod_labels), -1, np.int32),
        anti_sig=np.full((M, bk.affinity_terms), -1, np.int32),
        namespace=np.full(M, -1, np.int32),
        pdb_group=np.full(M, -1, np.int32),
        valid=np.zeros(M, bool),
    )


# Row fills, shared by build and DeviceSnapshot's O(churn) re-encodes:
# each fill resets its row to padding first, so re-encoding a row in
# place gives what a fresh build gives.


def _fill_atom_row(t: dict, i: int, atom) -> None:
    k, op, pids, num = atom
    t["atom_key"][i] = k
    t["atom_op"][i] = op
    t["atom_pairs"][i] = -1
    t["atom_pairs"][i, : len(pids)] = pids
    t["atom_num"][i] = num
    t["atom_valid"][i] = True


def _fill_sig_row(t: dict, i: int, sig) -> None:
    k, ns_scope, alist = sig
    t["sig_key"][i] = k
    t["sig_atoms"][i] = -1
    t["sig_atoms"][i, : len(alist)] = alist
    t["sig_ns"][i] = -1
    t["sig_ns_all"][i] = ns_scope == "*"
    if ns_scope != "*":
        t["sig_ns"][i, : len(ns_scope)] = ns_scope
    t["sig_valid"][i] = True


def _fill_node_row(nodes: dict, i: int, nrec: dict, intr: _Interner,
                   cfg: EngineConfig) -> None:
    """Row i from one node record. `used` is the record's own usage;
    counted running pods are folded in by the caller, which owns the
    summation order."""
    nodes["valid"][i] = True
    nodes["schedulable"][i] = not nrec["unschedulable"]
    for r, rn in enumerate(cfg.resources):
        nodes["allocatable"][i, r] = float(nrec["allocatable"].get(rn, 0.0))
        nodes["used"][i, r] = float(nrec["used"].get(rn, 0.0))
    nodes["label_pairs"][i] = -1
    nodes["label_keys"][i] = -1
    nodes["label_nums"][i] = np.nan
    for j, (k, v) in enumerate(sorted(nrec["labels"].items())):
        nodes["label_keys"][i, j] = intr.key_ids[k]
        nodes["label_pairs"][i, j] = intr.pair_ids[(k, v)]
        nodes["label_nums"][i, j] = _try_float(v)
    nodes["taint_ids"][i] = -1
    for j, (k, v, e) in enumerate(nrec["taints"]):
        nodes["taint_ids"][i, j] = intr.taint_ids[(k, v, e)]
    # Domain ids per topology key, in node order (-1: the node lacks
    # the key).
    nodes["domain"][i] = -1
    for ti, tk in enumerate(intr.topo_keys):
        if tk in nrec["labels"]:
            nodes["domain"][i, ti] = intr.domain_ids[ti].setdefault(
                nrec["labels"][tk], len(intr.domain_ids[ti]))


def _fill_pod_row(pods: dict, i: int, p: dict, pc: dict, intr: _Interner,
                  cfg: EngineConfig, group_idx: dict) -> None:
    _pad_pod_row(pods, i)
    pods["valid"][i] = True
    for r, rn in enumerate(cfg.resources):
        pods["requests"][i, r] = float(p["requests"].get(rn, 0.0))
    pods["base_priority"][i] = p["priority"]
    pods["slo_target"][i] = p["slo_target"]
    pods["observed_avail"][i] = p["observed_avail"]
    for j, (k, v) in enumerate(sorted(p["labels"].items())):
        pods["label_keys"][i, j] = intr.key_ids[k]
        pods["label_pairs"][i, j] = intr.pair_ids[(k, v)]
    # Tolerations precompiled against the taint vocab.
    for (tk, tv, te), t in intr.taint_ids.items():
        pods["tolerated"][i, t] = any(
            _tolerates(tol, tk, tv, te) for tol in p["tolerations"]
        )
    for t, term in enumerate(pc["req_terms"]):
        pods["req_term_valid"][i, t] = True
        pods["req_term_atoms"][i, t, : len(term)] = term
    for t, (term, w) in enumerate(pc["pref_terms"]):
        pods["pref_term_valid"][i, t] = True
        pods["pref_term_atoms"][i, t, : len(term)] = term
        pods["pref_weight"][i, t] = w
    for c, con in enumerate(pc["ts"]):
        pods["ts_valid"][i, c] = True
        pods["ts_key"][i, c] = con["key"]
        pods["ts_max_skew"][i, c] = con["max_skew"]
        pods["ts_when"][i, c] = con["when"]
        pods["ts_sel_atoms"][i, c, : len(con["atoms"])] = con["atoms"]
        pods["ts_sig"][i, c] = con["sig"]
    for t, term in enumerate(pc["ia"]):
        pods["ia_valid"][i, t] = True
        pods["ia_key"][i, t] = term["key"]
        pods["ia_sel_atoms"][i, t, : len(term["atoms"])] = term["atoms"]
        pods["ia_sig"][i, t] = term["sig"]
        pods["ia_anti"][i, t] = term["anti"]
        pods["ia_required"][i, t] = term["required"]
        pods["ia_weight"][i, t] = term["weight"]
    if p["pod_group"] is not None:
        pods["group"][i] = group_idx[p["pod_group"]]
    pods["namespace"][i] = intr.ns_ids[p["namespace"]]
    pods["tolerates_unsched"][i] = any(
        _tolerates(tol, "node.kubernetes.io/unschedulable", "", "NoSchedule")
        for tol in p["tolerations"]
    )


def _fill_running_row(run: dict, i: int, rrec: dict, anti_sigs: list,
                      intr: _Interner, cfg: EngineConfig, node_index: dict,
                      pdb_idx: dict) -> None:
    _pad_running_row(run, i)
    run["node_idx"][i] = node_index[rrec["node"]]
    run["valid"][i] = True
    for r, rn in enumerate(cfg.resources):
        run["requests"][i, r] = float(rrec["requests"].get(rn, 0.0))
    run["priority"][i] = rrec["priority"]
    run["slack"][i] = rrec["slack"]
    for j, (k, v) in enumerate(sorted(rrec["labels"].items())):
        run["label_keys"][i, j] = intr.key_ids[k]
        run["label_pairs"][i, j] = intr.pair_ids[(k, v)]
    run["anti_sig"][i, : len(anti_sigs)] = anti_sigs
    run["namespace"][i] = intr.ns_ids[rrec["namespace"]]
    if rrec["pdb_group"] is not None:
        run["pdb_group"][i] = pdb_idx[rrec["pdb_group"]]


# Padding rows: the values _nodes_np / _pods_np / _running_np allocate.
_NODE_PAD = dict(allocatable=0.0, used=0.0, label_pairs=-1, label_keys=-1,
                 label_nums=np.nan, taint_ids=-1, domain=-1,
                 schedulable=False, valid=False)
_POD_PAD = dict(requests=0.0, base_priority=0.0, slo_target=0.0,
                observed_avail=1.0, tolerated=False, label_pairs=-1,
                label_keys=-1, req_term_atoms=-1, req_term_valid=False,
                pref_term_atoms=-1, pref_term_valid=False, pref_weight=0.0,
                ts_key=-1, ts_max_skew=0.0, ts_when=0, ts_sel_atoms=-1,
                ts_sig=-1, ts_valid=False, ia_key=-1, ia_sel_atoms=-1,
                ia_sig=-1, ia_anti=False, ia_required=False, ia_weight=0.0,
                ia_valid=False, group=-1, namespace=-1,
                tolerates_unsched=False, valid=False)
_RUN_PAD = dict(node_idx=-1, requests=0.0, priority=0.0, slack=0.0,
                label_pairs=-1, label_keys=-1, anti_sig=-1, namespace=-1,
                pdb_group=-1, valid=False)


def _pad_node_row(nodes: dict, i: int) -> None:
    for f, v in _NODE_PAD.items():
        nodes[f][i] = v


def _pad_pod_row(pods: dict, i: int) -> None:
    for f, v in _POD_PAD.items():
        pods[f][i] = v


def _pad_running_row(run: dict, i: int) -> None:
    for f, v in _RUN_PAD.items():
        run[f][i] = v


def _snapshot_from_arrays(nodes: dict, pods: dict, run: dict,
                          t: dict) -> ClusterSnapshot:
    """The snapshot of CPU tensors over the host mirrors. The tensors
    SHARE memory with the numpy arrays (no copy): a transfer to the
    device copies, after which the mirrors stay the mutable host side."""
    return ClusterSnapshot(
        nodes=_dc(NodeArrays, nodes),
        pods=_dc(PodArrays, pods),
        running=_dc(RunningPodArrays, run),
        atoms=AtomTable(key=_t(t["atom_key"]), op=_t(t["atom_op"]),
                        pairs=_t(t["atom_pairs"]), num=_t(t["atom_num"]),
                        valid=_t(t["atom_valid"])),
        sigs=SigTable(key=_t(t["sig_key"]), atoms=_t(t["sig_atoms"]),
                      ns=_t(t["sig_ns"]), ns_all=_t(t["sig_ns_all"]),
                      valid=_t(t["sig_valid"])),
        taint_effect=_t(t["taint_effect"]),
        group_min_member=_t(t["group_min"]),
        pdb_allowed=_t(t["pdb_allowed"]),
    )


def _tolerates(tol: Toleration, tk: str, tv: str, te: str) -> bool:
    """Upstream toleration matching: empty key + Exists tolerates
    everything; key must match otherwise; Exists ignores value, Equal
    compares it; empty effect matches all."""
    if tol.operator not in ("Exists", "Equal"):
        raise ValueError(f"bad toleration operator {tol.operator!r}")
    if tol.key == "":
        if tol.operator != "Exists":
            return False
        key_ok = True
    else:
        key_ok = tol.key == tk
    if not key_ok:
        return False
    if tol.operator == "Equal" and tol.value != tv:
        return False
    if tol.effect and tol.effect != te:
        return False
    return True
