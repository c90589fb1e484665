"""One rank of the port's mesh on the CPU, for tests/test_torch_ring.py.

    python tests/torch_ring_worker.py STORE WORLD RANK P N WHAT OUT

joins a gloo process group of WORLD ranks through the FileStore file
STORE, makes the (P, N) mesh on the CPU and runs one case (WHAT):

  counts   `ring.ring_sig_counts` over the mesh on the ring test's
           snapshots (tests/test_ring.py:22), with no pod placed and with
           half the pods placed, and with three namespaces;
  engine   `Engine(EngineConfig(mode, ring_counts=True), mesh=...)` in
           parity and fast mode on make_cluster(rng(77), 48, 16, ...);
  tenants  `solve_many` over the mesh on tests/test_tenants.py's eight
           stacked tenants.

and saves its outputs, as numpy arrays, to OUT (an .npz file). It imports
nothing of JAX: the parent test holds the outputs against the JAX
package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpusched_torch import Engine, EngineConfig, solve_many  # noqa: E402
from tpusched_torch import synth as tsynth  # noqa: E402
from tpusched_torch.engine import _sat_tables  # noqa: E402
from tpusched_torch.mesh import init_distributed, make_mesh  # noqa: E402
from tpusched_torch.ring import ring_sig_counts  # noqa: E402

RING_MIX = dict(spread_frac=0.5, interpod_frac=0.4, run_anti_frac=0.2)


def ring_snap(seed: int, **kw):
    """tests/test_ring.py's snapshot: make_cluster(rng(seed), 48, 16)."""
    return tsynth.make_cluster(np.random.default_rng(seed), 48, 16,
                               **dict(RING_MIX, **kw))[0]


# The `counts` cases: name, seed, namespace_count (0: make_cluster's
# default), half the pods placed (assigned_half) or none.
COUNT_CASES = (("none", 102, 0, False), ("half", 104, 0, True),
               ("ns", 321, 3, False))


def assigned_half(snap) -> np.ndarray:
    """tests/test_ring.py's assignment: half the pods on random nodes."""
    P = snap.pods.valid.shape[0]
    N = snap.nodes.valid.shape[0]
    rng = np.random.default_rng(7)
    return np.where(rng.random(P) < 0.5, rng.integers(0, N, P),
                    -1).astype(np.int32)


def atomless(m, config):
    """A snapshot from `m`'s SnapshotBuilder (m: the port's snapshot
    module or the JAX package's) with one spread constraint with an empty
    selector and nothing else that interns an atom: A = 0 (and no term
    atoms)."""
    zone = "topology.kubernetes.io/zone"
    b = m.SnapshotBuilder(config)
    for i in range(4):
        b.add_node(f"n{i}", {"cpu": 4000, "memory": 16 << 30},
                   labels={zone: "ab"[i % 2]})
    for i in range(3):
        b.add_running_pod(f"n{i}", {"cpu": 100, "memory": 1 << 28})
    b.add_pod("p", {"cpu": 100, "memory": 1 << 28}, topology_spread=[
        m.TopologySpreadConstraint(zone, max_skew=1,
                                   when_unsatisfiable="DoNotSchedule",
                                   selector=())])
    return b.build()[0]


# tests/test_tenants.py's tenants: TENANTS clusters of 20 + 5 b pods on 10
# nodes under one floor with 16 signature slots.
TENANTS = 8
TENANT_BUCKETS = dict(atoms=16, signatures=16, taint_vocab=8, topo_keys=4,
                      node_labels=8, pod_labels=4, sig_namespaces=2,
                      term_atoms=4)
TENANT_MIX = dict(spread_frac=0.3, interpod_frac=0.3, taint_frac=0.2,
                  toleration_frac=0.3)


def tenant_stack():
    """The TENANTS tenants, stacked."""
    from tpusched_torch import stack_snapshots
    from tpusched_torch.config import Buckets

    bk = Buckets.fit(64, 16, 64, **TENANT_BUCKETS)
    return stack_snapshots([tsynth.make_cluster(
        np.random.default_rng(8800 + b), 20 + 5 * b, 10, buckets=bk,
        **TENANT_MIX)[0] for b in range(TENANTS)])


def ring_records():
    """ring_snap(77)'s cluster as records (nodes, pods, running), for a
    DeviceSnapshot."""
    return tsynth.make_cluster(np.random.default_rng(77), 48, 16,
                               as_records=True, **RING_MIX)


def run(what: str, mesh) -> dict:
    out = {}
    if what == "counts":
        for name, seed, ns, half in COUNT_CASES:
            snap = ring_snap(seed, **(dict(namespace_count=ns) if ns else {}))
            _, msat = _sat_tables(snap)
            P = snap.pods.valid.shape[0]
            a = (assigned_half(snap) if half
                 else np.full(P, -1, np.int32))
            out[name] = ring_sig_counts(snap, msat, torch.from_numpy(a),
                                        mesh).numpy()
    elif what == "engine":
        snap = ring_snap(77)
        for mode in ("parity", "fast"):
            eng = Engine(EngineConfig(mode=mode, ring_counts=True),
                         mesh=mesh)
            res = eng.solve(snap)
            eng.close()
            for field in ("assignment", "order", "commit_key",
                          "chosen_score", "final_used"):
                out[f"{mode}_{field}"] = getattr(res, field)
    elif what == "tenants":
        a, c, u, o, rounds, ev = solve_many(EngineConfig(mode="fast"),
                                            tenant_stack(), mesh=mesh)
        out.update(a=a.numpy(), c=c.numpy(), u=u.numpy(), o=o.numpy(),
                   rounds=rounds.numpy(), ev=ev.numpy())
    else:
        raise ValueError(f"unknown case {what!r}")
    return out


def main() -> int:
    store, world, rank, p, n, what, dest = sys.argv[1:8]
    torch.set_num_threads(1)
    init_distributed(num_processes=int(world), process_id=int(rank),
                     store_path=store, device="cpu", timeout_s=180.0)
    mesh = make_mesh((int(p), int(n)), devices="cpu")
    out = run(what, mesh)
    out["coords"] = np.asarray(mesh.coords)
    np.savez(dest, **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
