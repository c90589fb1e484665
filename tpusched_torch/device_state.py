"""Device-resident cluster state: the port of `tpusched/device_state.py`.

After the first upload, delta cycles change the snapshot ON THE DEVICE
instead of rebuilding and re-uploading the cluster. Per delta cycle the
host
  * normalizes and interns only the churned records against the
    lineage's interner (vocabulary appends; ids already in device
    arrays stay valid),
  * re-encodes only the churned rows into the numpy mirror (the row
    fills of `snapshot.py`),
  * ships those rows (and, when an insertion or removal shifted the
    name-sorted row order, one int32 permutation per collection) and
    applies them with `kernels.assign.scatter_rows` / `permute_rows`,
    torch indexing over whole row groups.

Anything the row model cannot express falls back to a full rebuild and
re-upload, counted with its reason: bucket overflow (rows or any feature
axis), a NEW taint (the [P, VT] tolerated matrix gains a column for every
pod), a NEW topology key (the [N, TK] domain matrix gains a column for
every node), or a topology domain id reaching the node bucket.

Invariants (the tests hold them against a fresh build and against the
JAX package's DeviceSnapshot fed the same records):
  * Row order is always name-sorted per collection, so index tie-breaks
    are a function of the cluster state, not of the delta history.
  * Value-only churn gives arrays byte-identical to a fresh
    `SnapshotBuilder.build()` of the same records at the same buckets.
    Vocabulary-growing churn may give other (opaque) intern ids than a
    fresh build; solve results are unaffected.
  * A node's `used` row is re-summed over its counted running pods in
    name order on every touch, never drifting through += / -= pairs.

The lineage also carries the warm solve's state: the tableau handle
(`warm_state`, an engine.WarmState), the dirty rows since it was built
(`warm_delta`) and the last warm result's placements (`carry_arrays`),
which `Engine.solve_warm_async` reads and commits.

`DeviceQueue` is the persistent pending table the JAX host builds with
`device_queue=True`: a numpy mirror on the host, its twin on the device,
dirty rows shipped in one scatter a cycle and the solve window ranked by
kernel K21 (`kernels/queue.py`).

On a mesh (`DeviceSnapshot(..., mesh=...)`) the lineage lives whole on
the rank's device, as every rank's engine solves the whole snapshot;
JAX's sharded layout of the lineage (pods over p, nodes over n) waits for
the sharded solve (ROADMAP A14b).
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import traceback
from typing import Iterable, Mapping

import numpy as np
import torch

from tpusched_torch.config import Buckets, EngineConfig
from tpusched_torch.kernels import queue as kqueue
from tpusched_torch.kernels.assign import permute_rows, scatter_rows
from tpusched_torch.mesh import mesh_device
from tpusched_torch.qos import pressure_of
from tpusched_torch.snapshot import (
    ClusterSnapshot,
    SnapshotBuilder,
    SnapshotMeta,
    _fill_atom_row,
    _fill_node_row,
    _fill_pod_row,
    _fill_running_row,
    _fill_sig_row,
    _pad_node_row,
    _pad_pod_row,
    _pad_running_row,
    _snapshot_from_arrays,
)


@dataclasses.dataclass
class ApplyStats:
    """What one apply() did and what it cost on the wire to the device."""

    path: str                 # "delta" | "rebuild"
    reason: str = ""          # rebuild trigger ("" on the delta path)
    h2d_bytes: int = 0        # bytes shipped host -> device
    rows_scattered: int = 0   # churned and pad rows written
    reordered: bool = False   # a permutation gather ran
    churn_records: int = 0    # upsert + remove records of the apply


@dataclasses.dataclass
class WarmDelta:
    """The dirty work of one warm solve, from everything applied since
    the last committed tableau. Index lists are positions in the CURRENT
    name-sorted row order; perms map tableau-order rows to current order
    (None: order unchanged). needs_cold forces a full tableau build."""

    needs_cold: bool = False
    reason: str = ""
    dirty_pods: "list[int] | None" = None     # pod tableau rows
    dirty_nodes: "list[int] | None" = None    # node tableau columns
    dirty_members: "list[int] | None" = None  # [running | pod] columns
    pod_perm: "np.ndarray | None" = None      # int32 [pod bucket]
    node_perm: "np.ndarray | None" = None     # int32 [node bucket]
    member_perm: "np.ndarray | None" = None   # int32 [run + pod buckets]


class _NeedsRebuild(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _pad_pow2(idx: list[int]) -> np.ndarray:
    """A scatter index list padded to the next power of two by repeating
    its first index (the repeated writes carry identical rows)."""
    n = len(idx)
    cap = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
    out = np.full(cap, idx[0], np.int32)
    out[:n] = idx
    return out


def _require_device(device, what: str) -> torch.device:
    """The device a resident structure lives on: CUDA by default (raises
    without it), the CPU only when asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device: the {what} lives on the GPU; pass "
                "device='cpu' explicitly to keep it on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceSnapshot:
    """One snapshot lineage resident on the device.

    `full_load()` takes builder-style record dicts (the kwargs
    SnapshotBuilder.add_* accept, plus 'name'; running records carry
    both 'name' and 'node'), sorts them by name, builds and uploads.
    `apply()` upserts and removes records and updates the device arrays
    in O(churn); `snap` / `meta` always reflect the latest applied
    state. device: "cuda" by default (raises without CUDA), or "cpu"
    when asked. mesh: a `mesh.Mesh`; the lineage then lives on the mesh
    rank's device (a `device` that differs raises). Not thread-safe: one
    caller applies and solves."""

    def __init__(self, config: EngineConfig | None = None,
                 buckets: Buckets | None = None,
                 device: "str | torch.device | None" = None, mesh=None):
        self.config = config or EngineConfig()
        self._floor_buckets = buckets
        self.mesh = mesh
        self.device = _require_device(mesh_device(mesh, device), "lineage")
        # Raw record kwargs by name (the rebuild's source of truth) and
        # the normalized forms the row fills read.
        self._nodes: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        self._running: dict[str, dict] = {}
        self._norm_nodes: dict[str, dict] = {}
        self._norm_pods: dict[str, dict] = {}
        self._norm_running: dict[str, dict] = {}
        self._run_anti: dict[str, list[int]] = {}   # name -> anti sig ids
        self._pod_pc: dict[str, dict] = {}          # name -> compiled pod
        # Name-sorted row orders.
        self._node_order: list[str] = []
        self._pod_order: list[str] = []
        self._run_order: list[str] = []
        # name -> row of the current orders (node rows: BuiltState's
        # node_index), kept with the orders for warm_delta.
        self._pod_index: dict[str, int] = {}
        self._run_index: dict[str, int] = {}
        # group -> {pod: min_member}; pdb key -> {running pod: allowed}
        self._group_members: dict[str, dict[str, int]] = {}
        self._pdb_members: dict[tuple, dict[str, int]] = {}
        # Reverse maps of the previous state (_refresh_prev_maps).
        self._run_node_name: dict[str, str] = {}
        self._pod_group_name: dict[str, str] = {}
        self._run_pdb_key: dict[str, tuple] = {}
        self._state = None          # snapshot.BuiltState
        self._meta: SnapshotMeta | None = None
        self._device: ClusterSnapshot | None = None
        # Transfer accounting.
        self.full_uploads = 0
        self.delta_updates = 0
        self.rebuilds = 0
        self.rebuild_reasons: list[str] = []
        self.h2d_bytes_total = 0
        self.h2d_bytes_last = 0
        # Warm residency: the tableau handle lives with the arrays it was
        # built from; the lineage token is what a handle is pinned to.
        self.warm_lineage: object = object()
        self.warm_state = None            # engine.WarmState (opaque here)
        self._warm_orders = None          # (node, pod, run) orders at sync
        self._warm_vocab = None           # (n_atoms, n_sigs) at sync
        self._warm_pressure = None        # np [pod bucket] pressure at sync
        self._warm_dirty_nodes: set[str] = set()
        self._warm_dirty_pods: set[str] = set()
        self._warm_dirty_runs: set[str] = set()
        self._warm_cold_reason: "str | None" = "never_built"
        self.warm_solves = 0
        self.cold_solves = 0
        self.incremental_solves = 0
        self.warm_cold_reasons: list[str] = []
        self.last_warm_rows = (0, 0, 0)   # (pod, node, member) dirty rows
        # The last warm result's placements, by name.
        self._carry = None  # (pod_names, node_names, assign np, chosen np)

    # -- views --------------------------------------------------------------

    @property
    def snap(self) -> ClusterSnapshot:
        if self._device is None:
            raise ValueError("DeviceSnapshot: full_load() first")
        return self._device

    @property
    def meta(self) -> SnapshotMeta:
        if self._meta is None:
            raise ValueError("DeviceSnapshot: full_load() first")
        return self._meta

    @property
    def full_bytes(self) -> int:
        """Size of one full snapshot upload at current buckets."""
        return self.snap.nbytes

    # -- load / rebuild -----------------------------------------------------

    def full_load(self, nodes: Iterable[Mapping], pods: Iterable[Mapping],
                  running: Iterable[Mapping]) -> ApplyStats:
        """Replace all state with these records and upload."""
        self._nodes = self._keyed(nodes, "node")
        self._pods = self._keyed(pods, "pod")
        self._running = self._keyed(running, "running pod")
        self._rebuild_members()
        return self._rebuild("full_load")

    @staticmethod
    def _keyed(records: Iterable[Mapping], kind: str) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for rec in records:
            name = rec.get("name")
            if not name or name in out:
                raise ValueError(
                    f"device-resident state needs unique non-empty {kind} "
                    f"names (offending: {name!r})")
            out[name] = dict(rec)
        return out

    def _rebuild_members(self) -> None:
        self._group_members = {}
        for name, rec in self._pods.items():
            g = rec.get("pod_group")
            if g:
                self._group_members.setdefault(g, {})[name] = int(
                    rec.get("pod_group_min_member", 0))
        self._pdb_members = {}
        for name, rec in self._running.items():
            g = rec.get("pdb_group")
            if g:
                key = (str(rec.get("namespace", "default")) or "default", g)
                self._pdb_members.setdefault(key, {})[name] = int(
                    rec.get("pdb_disruptions_allowed", 0))

    def _refresh_prev_maps(self) -> None:
        """Reverse maps the next apply needs to find what a churned
        record used to reference (old node, old group, old budget)."""
        self._run_node_name = {
            name: rec["node"] for name, rec in self._running.items()}
        self._pod_group_name = {
            name: rec.get("pod_group") for name, rec in self._pods.items()
            if rec.get("pod_group")}
        self._run_pdb_key = {}
        for key, members in self._pdb_members.items():
            for name in members:
                self._run_pdb_key[name] = key

    def _rebuild(self, reason: str) -> ApplyStats:
        """Full host rebuild and device re-upload. Buckets floor at the
        previous state's, so a lineage's shapes never shrink."""
        floor = self._state.buckets if self._state is not None \
            else self._floor_buckets
        b = SnapshotBuilder(self.config, floor)
        self._node_order = sorted(self._nodes)
        self._pod_order = sorted(self._pods)
        self._run_order = sorted(self._running)
        for name in self._node_order:
            b.add_node(**self._nodes[name])
        for name in self._pod_order:
            b.add_pod(**self._pods[name])
        for name in self._run_order:
            b.add_running_pod(**{k: v for k, v in self._running[name].items()
                                 if k != "name"})
        snap_np, meta, state = b.build_state()
        meta.running_names = list(self._run_order)
        self._pod_index = {nm: i for i, nm in enumerate(self._pod_order)}
        self._run_index = {nm: i for i, nm in enumerate(self._run_order)}
        self._state = state
        self._meta = meta
        # The builder's normalized records, so later re-encodes match a
        # build exactly.
        self._norm_nodes = dict(zip(self._node_order, b._nodes))
        self._norm_pods = dict(zip(self._pod_order, b._pods))
        self._norm_running = dict(zip(self._run_order, b._running))
        self._pod_pc = {}
        self._run_anti = {}
        self._refresh_prev_maps()
        # copy: a CPU lineage must not share memory with the mirror.
        self._device = snap_np.to(self.device, copy=True)
        # A carried tableau was built on the old arrays: drop it.
        self.invalidate_warm(reason)
        nbytes = snap_np.nbytes
        self.full_uploads += 1
        if reason != "full_load":
            self.rebuilds += 1
            self.rebuild_reasons.append(reason)
        self.h2d_bytes_last = nbytes
        self.h2d_bytes_total += nbytes
        return ApplyStats(path="rebuild", reason=reason, h2d_bytes=nbytes)

    # -- incremental apply --------------------------------------------------

    def apply(
        self,
        upsert_nodes: Iterable[Mapping] = (),
        remove_nodes: Iterable[str] = (),
        upsert_pods: Iterable[Mapping] = (),
        remove_pods: Iterable[str] = (),
        upsert_running: Iterable[Mapping] = (),
        remove_running: Iterable[str] = (),
    ) -> ApplyStats:
        if self._device is None:
            raise ValueError("DeviceSnapshot: full_load() first")
        upsert_nodes = [dict(r) for r in upsert_nodes]
        upsert_pods = [dict(r) for r in upsert_pods]
        upsert_running = [dict(r) for r in upsert_running]
        remove_nodes = list(remove_nodes)
        remove_pods = list(remove_pods)
        remove_running = list(remove_running)
        for coll, kind in ((upsert_nodes, "node"), (upsert_pods, "pod"),
                           (upsert_running, "running pod")):
            seen = set()
            for rec in coll:
                name = rec.get("name")
                if not name or name in seen:
                    raise ValueError(
                        f"delta upserts need unique non-empty {kind} names "
                        f"(offending: {name!r})")
                seen.add(name)
        # Validate before committing anything: a running pod whose node
        # is gone cannot be encoded.
        nodes_after = (set(self._nodes) | {r["name"] for r in upsert_nodes}
                       ) - set(remove_nodes)
        removed_r = set(remove_running)
        upserted_r = {u["name"] for u in upsert_running}
        check = list(upsert_running)
        if remove_nodes:
            check += [rec for name, rec in self._running.items()
                      if name not in removed_r and name not in upserted_r]
        for rec in check:
            if rec["node"] not in nodes_after:
                raise ValueError(
                    f"running pod {rec.get('name')!r} references missing "
                    f"node {rec['node']!r}")
        # Records first: if the incremental path cannot express the
        # change, _rebuild() regenerates everything from them.
        for rec in upsert_nodes:
            self._nodes[rec["name"]] = rec
        for name in remove_nodes:
            self._nodes.pop(name, None)
        for rec in upsert_pods:
            self._pods[rec["name"]] = rec
        for name in remove_pods:
            self._pods.pop(name, None)
        for rec in upsert_running:
            self._running[rec["name"]] = rec
        for name in remove_running:
            self._running.pop(name, None)
        self._rebuild_members()
        churn = (len(upsert_nodes) + len(remove_nodes) + len(upsert_pods)
                 + len(remove_pods) + len(upsert_running)
                 + len(remove_running))
        try:
            stats = self._apply_incremental(
                upsert_nodes, remove_nodes, upsert_pods, remove_pods,
                upsert_running, remove_running)
        except _NeedsRebuild as e:
            stats = self._rebuild(e.reason)
        except Exception:  # noqa: BLE001 - heal, the records are committed
            logging.getLogger("tpusched_torch.device_state").warning(
                "incremental delta apply failed; rebuilding this "
                "lineage:\n%s", traceback.format_exc(limit=4))
            stats = self._rebuild("incremental_error")
        stats.churn_records = churn
        return stats

    def _apply_incremental(self, upsert_nodes, remove_nodes, upsert_pods,
                           remove_pods, upsert_running, remove_running
                           ) -> ApplyStats:
        st = self._state
        intr = st.interner
        bk = st.buckets
        cfg = self.config

        if (len(self._pods) > bk.pods or len(self._nodes) > bk.nodes
                or len(self._running) > bk.running_pods):
            raise _NeedsRebuild("row_bucket")

        # Normalize churned records through a scratch builder: the same
        # defaulting as a full build.
        nb = SnapshotBuilder(cfg)
        for rec in upsert_nodes:
            nb.add_node(**rec)
        for rec in upsert_pods:
            nb.add_pod(**rec)
        for rec in upsert_running:
            nb.add_running_pod(**{k: v for k, v in rec.items()
                                  if k != "name"})
        norm_nodes = dict(zip([r["name"] for r in upsert_nodes], nb._nodes))
        norm_pods = dict(zip([r["name"] for r in upsert_pods], nb._pods))
        norm_running = dict(zip([r["name"] for r in upsert_running],
                                nb._running))

        # Vocabulary growth with a column-wide blast radius rebuilds.
        n_topo0 = len(intr.topo_keys)
        for rec in norm_nodes.values():
            for (k, v, e) in rec["taints"]:
                if (k, v, e) not in intr.taint_ids:
                    raise _NeedsRebuild("new_taint")

        n_atoms0, n_sigs0 = len(intr.atoms), len(intr.sigs)
        new_pcs: dict[str, dict] = {}
        for name, rec in norm_pods.items():
            pc = intr.compile_pod(rec)
            intr.intern_labels(rec["labels"])
            intr.nsid(rec["namespace"])
            new_pcs[name] = pc
            if (len(pc["req_terms"]) > bk.terms
                    or len(pc["pref_terms"]) > bk.pref_terms
                    or len(pc["ts"]) > bk.spread_constraints
                    or len(pc["ia"]) > bk.affinity_terms
                    or len(rec["labels"]) > bk.pod_labels
                    or any(len(t) > bk.term_atoms for t in pc["req_terms"])
                    or any(len(t[0]) > bk.term_atoms
                           for t in pc["pref_terms"])):
                raise _NeedsRebuild("pod_feature_bucket")
        new_anti: dict[str, list[int]] = {}
        for name, rec in norm_running.items():
            sigs_of_pod, am = intr.compile_running_anti(rec)
            intr.intern_labels(rec["labels"])
            intr.nsid(rec["namespace"])
            new_anti[name] = sigs_of_pod
            if (len(sigs_of_pod) > bk.affinity_terms or am > bk.term_atoms
                    or len(rec["labels"]) > bk.pod_labels):
                raise _NeedsRebuild("running_feature_bucket")
        for rec in norm_nodes.values():
            intr.intern_labels(rec["labels"])
            if (len(rec["labels"]) > bk.node_labels
                    or len(rec["taints"]) > bk.node_taints):
                raise _NeedsRebuild("node_feature_bucket")
        # Domain ids only ever append on a long-lived interner, but the
        # pairwise kernels index [S, N] by them: rebuild (which compacts
        # them) before one reaches the node bucket.
        new_domains: dict[int, set] = {}
        for rec in norm_nodes.values():
            for ti, tk in enumerate(intr.topo_keys):
                v = rec["labels"].get(tk)
                if v is not None and v not in intr.domain_ids[ti]:
                    new_domains.setdefault(ti, set()).add(v)
        for ti, vals in new_domains.items():
            if len(intr.domain_ids[ti]) + len(vals) > bk.nodes:
                raise _NeedsRebuild("domain_vocab")
        if len(intr.topo_keys) > n_topo0:
            raise _NeedsRebuild("new_topo_key")
        if len(intr.atoms) > bk.atoms or len(intr.sigs) > bk.signatures:
            raise _NeedsRebuild("table_bucket")
        for a in range(n_atoms0, len(intr.atoms)):
            if len(intr.atoms[a][2]) > bk.atom_values:
                raise _NeedsRebuild("atom_values_bucket")
        for s in range(n_sigs0, len(intr.sigs)):
            _, ns_scope, alist = intr.sigs[s]
            if len(alist) > bk.term_atoms or (
                    ns_scope != "*" and len(ns_scope) > bk.sig_namespaces):
                raise _NeedsRebuild("sig_bucket")

        # Groups and budgets: new ids append (ids are opaque tokens). A
        # touched slot's value is the max over its current members.
        touched_groups = set()
        for rec in upsert_pods:
            g = rec.get("pod_group")
            if g:
                touched_groups.add(g)
            old_g = self._pod_group_name.get(rec["name"])
            if old_g:
                touched_groups.add(old_g)
        for name in remove_pods:
            old_g = self._pod_group_name.get(name)
            if old_g:
                touched_groups.add(old_g)
        for g in touched_groups:
            if g in self._group_members and g not in st.group_idx:
                if len(st.group_idx) >= bk.pod_groups:
                    raise _NeedsRebuild("group_bucket")
                st.group_idx[g] = len(st.group_idx)
        touched_groups &= set(st.group_idx)
        touched_pdbs = set()
        for rec in norm_running.values():
            if rec["pdb_group"] is not None:
                touched_pdbs.add(rec["pdb_group"])
        for rec in upsert_running:
            old_key = self._run_pdb_key.get(rec["name"])
            if old_key:
                touched_pdbs.add(old_key)
        for name in remove_running:
            old_key = self._run_pdb_key.get(name)
            if old_key:
                touched_pdbs.add(old_key)
        for key in touched_pdbs:
            if key in self._pdb_members and key not in st.pdb_idx:
                if len(st.pdb_idx) >= bk.pdb_groups:
                    raise _NeedsRebuild("pdb_bucket")
                st.pdb_idx[key] = len(st.pdb_idx)
        touched_pdbs &= set(st.pdb_idx)

        # Commit normalized forms and compiled caches.
        for name in remove_nodes:
            self._norm_nodes.pop(name, None)
        for name in remove_pods:
            self._norm_pods.pop(name, None)
            self._pod_pc.pop(name, None)
        for name in remove_running:
            self._norm_running.pop(name, None)
            self._run_anti.pop(name, None)
        self._norm_nodes.update(norm_nodes)
        self._norm_pods.update(norm_pods)
        self._norm_running.update(norm_running)
        self._pod_pc.update(new_pcs)
        self._run_anti.update(new_anti)

        # Churn sets: a running upsert or removal dirties its node's
        # `used` row (old node and new node when the pod moved).
        node_churn = set(norm_nodes)
        run_churn = set(norm_running)
        pod_churn = set(norm_pods)
        for rec in upsert_running:
            node_churn.add(rec["node"])
            old_node = self._run_node_name.get(rec["name"])
            if old_node is not None:
                node_churn.add(old_node)
        for name in remove_running:
            old_node = self._run_node_name.get(name)
            if old_node is not None:
                node_churn.add(old_node)
        node_churn &= set(self._nodes)
        self._refresh_prev_maps()

        new_node_order = sorted(self._nodes)
        new_pod_order = sorted(self._pods)
        new_run_order = sorted(self._running)
        node_perm, node_pads = self._perm(self._node_order, new_node_order,
                                          bk.nodes)
        pod_perm, pod_pads = self._perm(self._pod_order, new_pod_order,
                                        bk.pods)
        run_perm, run_pads = self._perm(self._run_order, new_run_order,
                                        bk.running_pods)
        node_reorder = node_perm is not None
        if node_reorder:
            # Node rows moved: every running row's node_idx is remapped
            # (one [M] int32 column, not a per-row re-encode).
            old_pos = {nm: i for i, nm in enumerate(self._node_order)}
            remap = np.full(bk.nodes, -1, np.int32)
            for new_i, nm in enumerate(new_node_order):
                if nm in old_pos:
                    remap[old_pos[nm]] = new_i

        # Reorder the mirror (fancy indexing makes new arrays), then
        # re-encode churned rows at their new positions, then pad the
        # vacated tail rows.
        for holder, perm in ((st.nodes_np, node_perm), (st.pods_np, pod_perm),
                             (st.run_np, run_perm)):
            if perm is None:
                continue
            for f, arr in list(holder.items()):
                holder[f] = np.ascontiguousarray(arr[perm])
        if node_reorder:
            ni = st.run_np["node_idx"]
            st.run_np["node_idx"] = np.where(
                ni >= 0, remap[ni], ni).astype(np.int32)
        mirror = _snapshot_from_arrays(st.nodes_np, st.pods_np, st.run_np,
                                       st.tables)
        st.node_index = {nm: i for i, nm in enumerate(new_node_order)}
        pod_index = {nm: i for i, nm in enumerate(new_pod_order)}
        run_index = {nm: i for i, nm in enumerate(new_run_order)}

        run_by_node: dict[str, list[str]] = {}
        for name in new_run_order:
            run_by_node.setdefault(self._norm_running[name]["node"],
                                   []).append(name)
        for nm in node_churn:
            i = st.node_index[nm]
            _fill_node_row(st.nodes_np, i, self._norm_nodes[nm], intr, cfg)
            # Re-sum counted members in name order, as a build does.
            for member in run_by_node.get(nm, ()):
                rrec = self._norm_running[member]
                if rrec["count_into_used"]:
                    for r, rn in enumerate(cfg.resources):
                        st.nodes_np["used"][i, r] += float(
                            rrec["requests"].get(rn, 0.0))
        for nm in pod_churn:
            _fill_pod_row(st.pods_np, pod_index[nm], self._norm_pods[nm],
                          self._pod_pc[nm], intr, cfg, st.group_idx)
        for nm in run_churn:
            _fill_running_row(st.run_np, run_index[nm],
                              self._norm_running[nm], self._run_anti[nm],
                              intr, cfg, st.node_index, st.pdb_idx)
        for i in node_pads:
            _pad_node_row(st.nodes_np, i)
        for i in pod_pads:
            _pad_pod_row(st.pods_np, i)
        for i in run_pads:
            _pad_running_row(st.run_np, i)

        # New atom and signature rows, touched group and budget values.
        for a in range(n_atoms0, len(intr.atoms)):
            _fill_atom_row(st.tables, a, intr.atoms[a])
        for s in range(n_sigs0, len(intr.sigs)):
            _fill_sig_row(st.tables, s, intr.sigs[s])
        for g in touched_groups:
            members = self._group_members.get(g, {})
            st.tables["group_min"][st.group_idx[g]] = (
                max(members.values()) if members else 0)
        for key in touched_pdbs:
            members = self._pdb_members.get(key, {})
            st.tables["pdb_allowed"][st.pdb_idx[key]] = float(
                max(members.values()) if members else 0)

        # Device updates: permutation gathers, then row scatters.
        dev = self.device
        h2d = 0
        rows_written = 0
        old = self._device
        nodes_dev, pods_dev, run_dev = old.nodes, old.pods, old.running
        for perm, attr in ((node_perm, "nodes"), (pod_perm, "pods"),
                           (run_perm, "running")):
            if perm is None:
                continue
            h2d += perm.nbytes
            perm_dev = torch.from_numpy(perm).to(dev)
            if attr == "nodes":
                nodes_dev = permute_rows(nodes_dev, perm_dev)
            elif attr == "pods":
                pods_dev = permute_rows(pods_dev, perm_dev)
            else:
                run_dev = permute_rows(run_dev, perm_dev)
        if node_reorder:
            # The remapped node_idx column, whole.
            run_dev = dataclasses.replace(
                run_dev, node_idx=torch.from_numpy(
                    st.run_np["node_idx"].copy()).to(dev))
            h2d += st.run_np["node_idx"].nbytes

        def scatter(dev_tree, mirror_tree, rows):
            nonlocal h2d, rows_written
            rows = sorted(set(rows))
            if not rows:
                return dev_tree
            idx = torch.from_numpy(_pad_pow2(rows))
            row_data = permute_rows(mirror_tree, idx)
            h2d += idx.nbytes + row_data.nbytes
            rows_written += len(rows)
            return scatter_rows(dev_tree, idx.to(dev), row_data.to(dev))

        nodes_dev = scatter(
            nodes_dev, mirror.nodes,
            [st.node_index[nm] for nm in node_churn] + list(node_pads))
        pods_dev = scatter(
            pods_dev, mirror.pods,
            [pod_index[nm] for nm in pod_churn] + list(pod_pads))
        run_dev = scatter(
            run_dev, mirror.running,
            [run_index[nm] for nm in run_churn] + list(run_pads))
        atoms_dev = scatter(old.atoms, mirror.atoms,
                            list(range(n_atoms0, len(intr.atoms))))
        sigs_dev = scatter(old.sigs, mirror.sigs,
                           list(range(n_sigs0, len(intr.sigs))))
        group_dev = scatter(old.group_min_member, mirror.group_min_member,
                            [st.group_idx[g] for g in touched_groups])
        pdb_dev = scatter(old.pdb_allowed, mirror.pdb_allowed,
                          [st.pdb_idx[k] for k in touched_pdbs])
        self._device = dataclasses.replace(
            old, nodes=nodes_dev, pods=pods_dev, running=run_dev,
            atoms=atoms_dev, sigs=sigs_dev, group_min_member=group_dev,
            pdb_allowed=pdb_dev)
        self._node_order = new_node_order
        self._pod_order = new_pod_order
        self._run_order = new_run_order
        self._pod_index = pod_index
        self._run_index = run_index
        # Every name whose row this apply re-encoded goes stale in the
        # carried tableau (reorders and vacated rows come from the order
        # diff in warm_delta). Only while a tableau is committed, so a
        # lineage that never warm-solves does not grow these sets.
        if self._warm_orders is not None:
            self._warm_dirty_nodes |= node_churn
            self._warm_dirty_pods |= pod_churn
            self._warm_dirty_runs |= run_churn
        self._meta = SnapshotMeta(
            node_names=list(new_node_order),
            pod_names=list(new_pod_order),
            n_nodes=len(new_node_order), n_pods=len(new_pod_order),
            n_running=len(new_run_order), buckets=bk,
            # Id order: group_names[i] names group id i.
            group_names=[g for g, _ in sorted(st.group_idx.items(),
                                              key=lambda kv: kv[1])],
            running_names=list(new_run_order),
        )
        self.delta_updates += 1
        self.h2d_bytes_last = h2d
        self.h2d_bytes_total += h2d
        return ApplyStats(
            path="delta", h2d_bytes=h2d, rows_scattered=rows_written,
            reordered=(node_perm is not None or pod_perm is not None
                       or run_perm is not None))

    # -- warm residency -----------------------------------------------------

    def invalidate_warm(self, reason: str) -> None:
        """Drop the carried tableau and the carry: the next warm solve
        goes cold, and an incremental one falls back until a new carry
        lands. Called on every rebuild, and by an owner whose cycle
        failed after dispatch."""
        self.warm_state = None
        self._warm_cold_reason = reason
        self._warm_orders = None
        self._warm_dirty_nodes = set()
        self._warm_dirty_pods = set()
        self._warm_dirty_runs = set()
        self._carry = None

    def warm_delta(self) -> WarmDelta:
        """The dirty work since the last committed tableau: churned rows
        at their current positions, rows vacated by shrinkage, one
        reorder perm per axis (tableau order -> current order), and the
        pods whose QoS pressure drifted since the commit (defensive: the
        solve recomputes every pressure-dependent value each time).
        Vocabulary growth forces needs_cold: new atoms or signatures
        change cells of unchurned rows."""
        if self._warm_cold_reason is not None:
            return WarmDelta(needs_cold=True, reason=self._warm_cold_reason)
        st = self._state
        bk = st.buckets
        if (len(st.interner.atoms), len(st.interner.sigs)) != self._warm_vocab:
            return WarmDelta(needs_cold=True, reason="vocab_growth")
        o_nodes, o_pods, o_runs = self._warm_orders
        node_perm, node_pads = self._perm(o_nodes, self._node_order,
                                          bk.nodes)
        pod_perm, pod_pads = self._perm(o_pods, self._pod_order, bk.pods)
        run_perm, run_pads = self._perm(o_runs, self._run_order,
                                        bk.running_pods)
        pod_index, run_index = self._pod_index, self._run_index
        d_nodes = {st.node_index[nm] for nm in self._warm_dirty_nodes
                   if nm in st.node_index} | set(node_pads)
        d_pods = {pod_index[nm] for nm in self._warm_dirty_pods
                  if nm in pod_index} | set(pod_pads)
        d_runs = {run_index[nm] for nm in self._warm_dirty_runs
                  if nm in run_index} | set(run_pads)
        cur = np.asarray(pressure_of(st.pods_np["slo_target"],
                                     st.pods_np["observed_avail"]))
        prev = self._warm_pressure
        prev_at_cur = prev[pod_perm] if pod_perm is not None else prev
        drift = np.nonzero((cur != prev_at_cur) & st.pods_np["valid"])[0]
        d_pods |= {int(i) for i in drift}
        # A pod is a tableau row and a member column; a running pod a
        # member column only. Members: [running bucket | pod bucket].
        d_members = {int(i) for i in d_runs} | {
            bk.running_pods + int(i) for i in d_pods}
        member_perm = None
        if run_perm is not None or pod_perm is not None:
            rp = run_perm if run_perm is not None else np.arange(
                bk.running_pods, dtype=np.int32)
            pp = pod_perm if pod_perm is not None else np.arange(
                bk.pods, dtype=np.int32)
            member_perm = np.concatenate([rp, bk.running_pods + pp])
        return WarmDelta(
            dirty_pods=sorted(d_pods) or None,
            dirty_nodes=sorted(d_nodes) or None,
            dirty_members=sorted(d_members) or None,
            pod_perm=pod_perm, node_perm=node_perm,
            member_perm=member_perm,
        )

    def warm_marker(self) -> "tuple[int, int]":
        """(warm_solves, incremental_solves) before a warm dispatch; with
        warm_path_taken, what the dispatch served."""
        return (self.warm_solves, self.incremental_solves)

    def warm_path_taken(self, marker: "tuple[int, int]") -> str:
        """The path the dispatch since `marker` took: incremental | warm
        | cold."""
        if self.incremental_solves > marker[1]:
            return "incremental"
        if self.warm_solves > marker[0]:
            return "warm"
        return "cold"

    def commit_warm(self, state, path: str, reason: str, rows) -> None:
        """Engine callback at dispatch: store the new handle and anchor
        the dirty accumulation on the state the dispatch reads."""
        st = self._state
        self.warm_state = state
        self._warm_orders = (list(self._node_order), list(self._pod_order),
                             list(self._run_order))
        self._warm_vocab = (len(st.interner.atoms), len(st.interner.sigs))
        self._warm_pressure = np.array(pressure_of(
            st.pods_np["slo_target"], st.pods_np["observed_avail"]))
        self._warm_dirty_nodes = set()
        self._warm_dirty_pods = set()
        self._warm_dirty_runs = set()
        self._warm_cold_reason = None
        self.last_warm_rows = tuple(rows)
        if path == "warm":
            self.warm_solves += 1
        elif path == "incremental":
            self.incremental_solves += 1
        else:
            self.cold_solves += 1
            self.warm_cold_reasons.append(reason)

    def commit_carry(self, pod_names, node_names, assignment, chosen,
                     ) -> None:
        """Store a finished solve's placements as the next incremental
        cycle's seed, keyed by the names of the snapshot it solved."""
        self._carry = (list(pod_names), list(node_names),
                       np.asarray(assignment), np.asarray(chosen))

    def carry_arrays(self):
        """The carry in the current row order: (carry [pod bucket] int32
        node index or -1, chosen [pod bucket] f32), or None. Pods and
        nodes gone since the carried solve drop out (-1)."""
        if self._carry is None:
            return None
        prev_pods, prev_nodes, a, c = self._carry
        bk = self._state.buckets
        if (prev_pods == self._pod_order and prev_nodes == self._node_order
                and a.shape[0] == bk.pods):
            return (np.asarray(a, np.int32).copy(),
                    np.asarray(c, np.float32).copy())
        carry = np.full(bk.pods, -1, np.int32)
        chos = np.full(bk.pods, -np.inf, np.float32)
        prev_idx = {nm: i for i, nm in enumerate(prev_pods)}
        node_now = self._state.node_index
        for i, nm in enumerate(self._pod_order):
            j = prev_idx.get(nm)
            if j is None or j >= len(a):
                continue
            n = int(a[j])
            if n < 0 or n >= len(prev_nodes):
                continue
            ni = node_now.get(prev_nodes[n], -1)
            if ni >= 0:
                carry[i] = ni
                chos[i] = np.float32(c[j])
        return carry, chos

    @staticmethod
    def _perm(old_order: list[str], new_order: list[str], bucket: int):
        """(perm int32 [bucket] | None, vacated row indices); None when
        the order is unchanged."""
        if old_order == new_order:
            return None, []
        old_pos = {nm: i for i, nm in enumerate(old_order)}
        perm = np.arange(bucket, dtype=np.int32)
        for i, nm in enumerate(new_order):
            perm[i] = old_pos.get(nm, i)
        pads = list(range(len(new_order), len(old_order)))
        return perm, pads


# ---------------------------------------------------------------------------
# The device-resident pending queue
# ---------------------------------------------------------------------------


class DeviceQueue:
    """The persistent [Q] pending table (JAX `DeviceQueue`): a numpy
    mirror on the host and its twin on the device.

    Every mutation (upsert / remove / park) touches only the mirror and
    marks the slot dirty; `window()` ships the dirty rows in one
    pow2-padded scatter (`_pad_pow2`, `scatter_rows`) and ranks the whole
    table on the device (K21, `kernels/queue.window_select`), so a
    cycle's device traffic is O(mutations) and its read-back O(window).

    Times are rebased against the first submission (the epoch), so wall
    clocks survive the f32 table. `bound` caps admission: an upsert of a
    NEW name into a full bounded queue returns False (the caller sheds);
    an unbounded queue doubles its capacity, which drops the device twin
    for one full upload.

    device: "cuda" by default (raises without CUDA), or "cpu" when
    asked. Not thread-safe: the ingest gate serialises access under its
    lock; the host drives it from the cycle loop."""

    def __init__(self, capacity: int = 1024, bound: int | None = None,
                 qos_gain: float = 1000.0,
                 device: "str | torch.device | None" = None):
        self.device = _require_device(device, "queue")
        cap = 1 << max(int(capacity) - 1, 0).bit_length()
        self.bound = int(bound) if bound else None
        self.qos_gain = float(qos_gain)
        self._host = kqueue.empty_table(cap)
        self._dev: kqueue.QueueTable | None = None   # None = stale
        self._slot: dict[str, int] = {}      # name -> slot
        self._names: list[str | None] = [None] * cap
        self._free: list[int] = list(range(cap))   # min-heap
        heapq.heapify(self._free)
        self._dirty: set[int] = set()
        self._epoch: float | None = None
        self._seq = 0
        self.scatters = 0
        self.scatter_rows_total = 0
        self.windows = 0

    # -- inspection -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return len(self._names)

    @property
    def depth(self) -> int:
        return len(self._slot)

    def __contains__(self, name: str) -> bool:
        return name in self._slot

    def names(self) -> list[str]:
        return list(self._slot)

    def _rebase(self, t: float) -> np.float32:
        if self._epoch is None:
            self._epoch = float(t)
        return np.float32(t - self._epoch)

    # -- mutation (the host mirror only) --------------------------------------

    def upsert(self, name: str, *, base_priority: float = 0.0,
               slo_target: float = 0.0, submitted: float = 0.0,
               run_seconds: float = 0.0, parked_until: float = 0.0,
               tenant: int = 0, seq: int | None = None) -> bool:
        """Insert or update one pending row. False (nothing changed) when
        the queue is bounded and full and `name` is new."""
        slot = self._slot.get(name)
        if slot is None:
            if self.bound is not None and len(self._slot) >= self.bound:
                return False
            if not self._free:
                self._grow()
            slot = heapq.heappop(self._free)
            self._slot[name] = slot
            self._names[slot] = name
        if seq is None:
            seq = self._seq
        self._seq = max(self._seq, int(seq)) + 1
        h = self._host
        h.valid[slot] = True
        h.base_priority[slot] = np.float32(base_priority)
        h.slo_target[slot] = np.float32(slo_target)
        h.submitted[slot] = self._rebase(submitted)
        h.run_seconds[slot] = np.float32(run_seconds)
        h.parked_until[slot] = (self._rebase(parked_until) if parked_until
                                else np.float32(0.0))
        h.tenant[slot] = np.int32(tenant)
        h.seq[slot] = np.uint32(seq)
        self._dirty.add(slot)
        return True

    def remove(self, names) -> int:
        """Invalidate slots; unknown names are ignored."""
        n = 0
        for name in names:
            slot = self._slot.pop(name, None)
            if slot is None:
                continue
            self._host.valid[slot] = False
            self._names[slot] = None
            heapq.heappush(self._free, slot)
            self._dirty.add(slot)
            n += 1
        return n

    def park(self, name: str, until: float) -> bool:
        """Ineligible until `until` (same clock as upsert and window); the
        row keeps its place and its priority keeps decaying."""
        slot = self._slot.get(name)
        if slot is None:
            return False
        self._host.parked_until[slot] = self._rebase(until)
        self._dirty.add(slot)
        return True

    # -- device sync and window -----------------------------------------------

    def _grow(self) -> None:
        old = self._host
        old_cap = len(self._names)
        new_cap = old_cap * 2
        self._host = kqueue.empty_table(new_cap)
        for f, arr in zip(self._host._fields, self._host):
            arr[:old_cap] = getattr(old, f)
        self._names.extend([None] * old_cap)
        for s in range(old_cap, new_cap):
            heapq.heappush(self._free, s)
        self._dev = None            # full upload on the next flush

    def _flush(self) -> None:
        """Ship the dirty mirror rows to the device twin: one pow2-padded
        scatter (or the whole table after growth)."""
        if self._dev is None:
            self._dev = kqueue.to_device(self._host, self.device)
            self._dirty.clear()
            return
        if not self._dirty:
            return
        rows = sorted(self._dirty)
        idx = _pad_pow2(rows)
        data = kqueue.to_device(
            kqueue.QueueTable(*[np.ascontiguousarray(a[idx])
                                for a in self._host]), self.device)
        idx_t = torch.from_numpy(idx).to(self.device)
        self._dev = kqueue.QueueTable(*[
            scatter_rows(d, idx_t, r) for d, r in zip(self._dev, data)])
        self.scatters += 1
        self.scatter_rows_total += len(rows)
        self._dirty.clear()

    def window(self, now: float, w: int):
        """The top-`w` solve window ranked on the device: flush the dirty
        rows, rank (K21), read back the pow2 window's slots and the
        counts, map slots to names. Returns (names in pop order,
        n_eligible, depth) with len(names) == min(w, n_eligible)."""
        self._flush()
        if self._epoch is None:
            return [], 0, 0
        cap = self.capacity
        kb = kqueue.k_bucket(min(max(int(w), 1), cap), cap)
        win, _prio, n_elig, depth = kqueue.window_select(
            self._dev, self._rebase(now), self.qos_gain, kb)
        self.windows += 1
        got = torch.cat([win, n_elig[None], depth[None]]).cpu().numpy()
        n_elig, depth = int(got[-2]), int(got[-1])
        take = min(int(w), n_elig, kb)
        names = []
        for s in got[:take]:
            nm = self._names[int(s)]
            if nm is not None:
                names.append(nm)
        return names, n_elig, depth

    def stats(self) -> dict:
        return {
            "depth": self.depth,
            "capacity": self.capacity,
            "bound": self.bound,
            "scatters": self.scatters,
            "scatter_rows_total": self.scatter_rows_total,
            "windows": self.windows,
        }
