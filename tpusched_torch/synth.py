"""Synthetic cluster snapshots: the port of `tpusched/synth.py`.

`make_cluster` draws from the numpy generator in exactly the JAX
generator's sequence, so the same seed gives the same cluster (and,
through the builders, identical arrays). The presets are BASELINE
configs 1-5.
"""

from __future__ import annotations

import numpy as np

from tpusched_torch.config import Buckets, EngineConfig
from tpusched_torch.snapshot import (
    ClusterSnapshot,
    MatchExpression,
    NodeSelectorTerm,
    PodAffinityTerm,
    PreferredTerm,
    SnapshotBuilder,
    SnapshotMeta,
    Toleration,
    TopologySpreadConstraint,
)

ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")
NODE_CLASSES = (
    # (cpu millicores, memory bytes)
    (4000, 16 << 30),
    (8000, 32 << 30),
    (16000, 64 << 30),
    (32000, 128 << 30),
)
_APPS = ("web", "db", "cache", "batch")
_ZONE_KEY = "topology.kubernetes.io/zone"


def make_cluster(
    rng: np.random.Generator,
    n_pods: int,
    n_nodes: int,
    config: EngineConfig | None = None,
    buckets: Buckets | None = None,
    initial_utilization: float = 0.3,
    n_running_per_node: int = 2,
    with_qos: bool = True,
    taint_frac: float = 0.0,
    toleration_frac: float = 0.0,
    selector_frac: float = 0.0,
    affinity_frac: float = 0.0,
    spread_frac: float = 0.0,
    interpod_frac: float = 0.0,
    run_anti_frac: float = 0.0,
    gang_frac: float = 0.0,
    gang_size: int = 4,
    keyless_node_frac: float = 0.0,
    namespace_count: int = 1,
    pdb_frac: float = 0.0,
    cordon_frac: float = 0.0,
    as_records: bool = False,
    tight_utilization: bool = False,
):
    """Random cluster; fractions set what share of pods/nodes carry
    each constraint type (the JAX generator's parameters). Returns
    (snapshot, meta), or with as_records=True the builder-style record
    lists (nodes, pods, running) that DeviceSnapshot.full_load takes,
    in the JAX generator's record dialect: a gang member carries its
    group's min_member, running pods are named run-<i> and carry their
    budget's bare name and aggregated allowance."""
    config = config or EngineConfig()
    b = SnapshotBuilder(config, buckets)

    zones = [ZONES[i % len(ZONES)] for i in range(n_nodes)]
    for i in range(n_nodes):
        cpu, mem = NODE_CLASSES[rng.integers(len(NODE_CLASSES))]
        labels = {
            _ZONE_KEY: zones[i],
            "kubernetes.io/hostname": f"node-{i}",
            "disktype": "ssd" if rng.random() < 0.5 else "hdd",
            "tier": str(rng.integers(0, 4)),
        }
        if rng.random() < keyless_node_frac:
            # A node without the topology key: spread DoNotSchedule
            # filters it; affinity's match-anywhere still counts it.
            del labels[_ZONE_KEY]
        taints = []
        if rng.random() < taint_frac:
            taints.append(("dedicated", "batch", "NoSchedule"))
        if rng.random() < taint_frac / 2:
            taints.append(("maintenance", "true", "PreferNoSchedule"))
        b.add_node(
            f"node-{i}",
            allocatable={"cpu": float(cpu), "memory": float(mem)},
            labels=labels,
            taints=taints,
            unschedulable=bool(rng.random() < cordon_frac),
        )

    # Background running pods: requests draw from the node's remaining
    # capacity, so the initial state is never overcommitted.
    for i in range(n_nodes):
        cap_cpu, cap_mem = b._nodes[i]["allocatable"]["cpu"], \
            b._nodes[i]["allocatable"]["memory"]
        rem = [cap_cpu, cap_mem]
        for _ in range(n_running_per_node):
            want_cpu = int(cap_cpu * initial_utilization
                           / max(n_running_per_node, 1))
            want_mem = int(cap_mem * initial_utilization
                           / max(n_running_per_node, 1))
            if tight_utilization:
                cpu_req, mem_req = float(max(100, want_cpu)), float(
                    max(1 << 28, want_mem)
                )
            else:
                cpu_req = float(rng.integers(100, max(101, want_cpu + 1)))
                mem_req = float(
                    rng.integers(1 << 28, max((1 << 28) + 1, want_mem + 1))
                )
            cpu_req = min(cpu_req, max(rem[0] - 100.0, 0.0))
            mem_req = min(mem_req, max(rem[1] - float(1 << 28), 0.0))
            if cpu_req <= 0 or mem_req <= 0:
                continue
            rem[0] -= cpu_req
            rem[1] -= mem_req
            run_kwargs: dict = {}
            if rng.random() < run_anti_frac:
                # A running pod whose required anti-affinity repels a
                # whole app from its zone (symmetric anti-affinity).
                run_kwargs["pod_affinity"] = [PodAffinityTerm(
                    topology_key=_ZONE_KEY,
                    selector=(MatchExpression(
                        "app", "In", (_APPS[int(rng.integers(len(_APPS)))],)
                    ),),
                    anti=True,
                    required=True,
                )]
            if rng.random() < pdb_frac:
                # A budget per (app-ish) group of running pods, with 0-2
                # remaining disruptions.
                g = int(rng.integers(8))
                run_kwargs["pdb_group"] = f"pdb-{g}"
                run_kwargs["pdb_disruptions_allowed"] = int(rng.integers(0, 3))
            b.add_running_pod(
                node=f"node-{i}",
                requests={"cpu": cpu_req, "memory": mem_req},
                priority=float(rng.integers(0, 100)),
                slack=float(rng.uniform(-0.2, 0.3)),
                labels={"app": _APPS[int(rng.integers(len(_APPS)))]},
                namespace=f"ns-{rng.integers(namespace_count)}",
                **run_kwargs,
            )

    for i in range(n_pods):
        app = _APPS[int(rng.integers(len(_APPS)))]
        kwargs: dict = {}
        if rng.random() < toleration_frac:
            kwargs["tolerations"] = [
                Toleration("dedicated", "Equal", "batch", "NoSchedule")]
        if rng.random() < selector_frac:
            kwargs["node_selector"] = {"disktype": "ssd"}
        if rng.random() < affinity_frac:
            kwargs["required_terms"] = [NodeSelectorTerm(
                (MatchExpression("tier", "In", ("0", "1", "2")),))]
            kwargs["preferred_terms"] = [PreferredTerm(
                weight=float(rng.integers(1, 100)),
                term=NodeSelectorTerm(
                    (MatchExpression("disktype", "In", ("ssd",)),)),
            )]
        if rng.random() < spread_frac:
            kwargs["topology_spread"] = [TopologySpreadConstraint(
                topology_key=_ZONE_KEY,
                max_skew=2,
                when_unsatisfiable=(
                    "DoNotSchedule" if rng.random() < 0.5
                    else "ScheduleAnyway"),
                selector=(MatchExpression("app", "In", (app,)),),
            )]
        if rng.random() < interpod_frac:
            anti = rng.random() < 0.5
            # Namespace scope: mostly the pod's own namespace, sometimes
            # an explicit list of 1-3 namespaces or all of them ("*").
            ns_roll = rng.random()
            if namespace_count > 1 and ns_roll < 0.2:
                term_ns = ("*",)
            elif namespace_count > 1 and ns_roll < 0.5:
                term_ns = tuple(
                    f"ns-{k}" for k in rng.choice(
                        namespace_count,
                        size=int(rng.integers(
                            1, min(namespace_count, 3) + 1)),
                        replace=False,
                    )
                )
            else:
                term_ns = ()
            kwargs["pod_affinity"] = [PodAffinityTerm(
                topology_key=_ZONE_KEY,
                selector=(MatchExpression(
                    "app", "In", ("db" if not anti else app,)),),
                anti=anti,
                required=bool(rng.random() < 0.3),
                weight=float(rng.integers(1, 100)),
                namespaces=term_ns,
            )]
        if gang_frac > 0 and rng.random() < gang_frac:
            kwargs["pod_group"] = f"gang-{i // gang_size}"
            kwargs["pod_group_min_member"] = gang_size
        slo = float(rng.choice([0.0, 0.9, 0.95, 0.99])) if with_qos else 0.0
        b.add_pod(
            f"pod-{i}",
            requests={
                "cpu": float(rng.integers(100, 4000)),
                "memory": float(rng.integers(1 << 28, 8 << 30)),
            },
            priority=float(rng.integers(0, 1000)),
            slo_target=slo,
            observed_avail=float(rng.uniform(0.5, 1.0)),
            labels={"app": app},
            namespace=f"ns-{rng.integers(namespace_count)}",
            **kwargs,
        )
    if as_records:
        pod_recs = []
        for p in b._pods:
            q = dict(p)
            if q.get("pod_group"):
                q["pod_group_min_member"] = b._groups[q["pod_group"]]
            pod_recs.append(q)
        run_recs = []
        for i, r in enumerate(b._running):
            q = dict(r)
            q["name"] = f"run-{i}"
            if q.get("pdb_group"):
                q["pdb_disruptions_allowed"] = b._pdbs[q["pdb_group"]]
                q["pdb_group"] = q["pdb_group"][1]
            run_recs.append(q)
        return b._nodes, pod_recs, run_recs
    return b.build()


def warm_churn_stream(rng: np.random.Generator, nodes: list, pods: list,
                      running: list, cycles: int, churn_frac: float = 0.05,
                      structural_every: int = 5):
    """Seeded delta cycles for warm lineages (the JAX package's
    `divergence.warm_churn_stream`, the same draws): mutates the record
    lists in place and yields DeviceSnapshot.apply kwargs. Each cycle
    redraws observed availability (and now and then priority) of
    ~churn_frac of the pending pods and one node's cpu allocatable;
    every structural_every-th cycle also adds a pod and removes one (a
    row reorder), removes a running pod (a completion) and toggles a
    node's cordon."""
    seq = 0
    for cyc in range(cycles):
        n_churn = max(1, int(round(churn_frac * len(pods))))
        picks = rng.choice(len(pods), size=min(n_churn, len(pods)),
                           replace=False)
        up_pods = []
        for i in picks:
            rec = pods[int(i)]
            rec["observed_avail"] = float(rng.uniform(0.3, 1.0))
            if rng.random() < 0.3:
                rec["priority"] = float(rng.integers(0, 1000))
            up_pods.append(rec)
        ni = int(rng.integers(len(nodes)))
        nrec = nodes[ni]
        alloc = dict(nrec.get("allocatable", {}))
        if "cpu" in alloc:
            alloc["cpu"] = float(max(1000.0, alloc["cpu"]
                                     * float(rng.uniform(0.9, 1.1))))
        nrec["allocatable"] = alloc
        delta = dict(upsert_pods=up_pods, upsert_nodes=[nrec])
        if structural_every and cyc % structural_every == structural_every - 1:
            seq += 1
            newp = dict(
                name=f"warm-audit-{seq:04d}",
                requests={"cpu": float(rng.integers(100, 800))},
                priority=float(rng.integers(0, 1000)),
                observed_avail=float(rng.uniform(0.5, 1.0)),
                labels={"app": "web"},
            )
            pods.append(newp)
            gone = pods.pop(int(rng.integers(len(pods) - 1)))
            delta["upsert_pods"] = [
                r for r in delta["upsert_pods"] if r["name"] != gone["name"]
            ] + [newp]
            delta["remove_pods"] = [gone["name"]]
            if running:
                done = running.pop(int(rng.integers(len(running))))
                delta["remove_running"] = [done["name"]]
            cn = int(rng.integers(len(nodes)))
            crec = nodes[cn]
            crec["unschedulable"] = not crec.get("unschedulable", False)
            if crec["name"] != nrec["name"]:
                delta["upsert_nodes"] = delta["upsert_nodes"] + [crec]
        yield delta


def config1_kind_like(rng: np.random.Generator, **kw):
    """QoS-weighted LeastRequested: 100 pods x 10 nodes (BASELINE
    config 1, kind-cluster scale)."""
    return make_cluster(rng, 100, 10, with_qos=True, **kw)


def config2_scale(rng: np.random.Generator, n_pods: int = 10_000,
                  n_nodes: int = 5_000, **kw):
    """NodeResourcesFit + BalancedAllocation at 10k x 5k (BASELINE
    config 2)."""
    return make_cluster(rng, n_pods, n_nodes, n_running_per_node=1, **kw)


def config3_pairwise(rng: np.random.Generator, n_pods: int = 2_000,
                     n_nodes: int = 500, **kw):
    """PodTopologySpread + InterPodAffinity (BASELINE config 3): half the
    pods carry a zone spread constraint, half an inter-pod term."""
    kw.setdefault("spread_frac", 0.5)
    kw.setdefault("interpod_frac", 0.5)
    return make_cluster(rng, n_pods, n_nodes, **kw)


def config4_gangs(rng: np.random.Generator, n_groups: int = 1_000,
                  gang_size: int = 4, n_nodes: int = 1_000, **kw):
    """Gang bin-pack (BASELINE config 4): n_groups pod groups of
    gang_size members, each all-or-nothing at min_member = gang_size."""
    return make_cluster(rng, n_groups * gang_size, n_nodes, gang_frac=1.0,
                        gang_size=gang_size, **kw)


def config5_preemption(rng: np.random.Generator, n_pods: int = 1_000,
                       n_nodes: int = 200, **kw):
    """Preemption pressure (BASELINE config 5): nodes filled to 90 % by
    eight running pods each, sized at the target, a third of them under
    a PodDisruptionBudget, so most pending pods need victims."""
    kw.setdefault("initial_utilization", 0.9)
    kw.setdefault("n_running_per_node", 8)
    kw.setdefault("pdb_frac", 0.3)
    kw.setdefault("tight_utilization", True)
    return make_cluster(rng, n_pods, n_nodes, **kw)
