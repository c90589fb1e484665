"""The JAX package's multi-device references for tests/test_torch_ring.py,
each in a process of its own:

    python tests/jax_ring_reference.py engine P N OUT
    python tests/jax_ring_reference.py counts SPEC OUT

`engine` solves the ring test's snapshot (make_cluster(rng(77), 48, 16,
...), as tests/torch_ring_worker.py's `engine` case builds it) with
`Engine(EngineConfig(mode, ring_counts=True), mesh=make_mesh((P, N)))` in
parity and fast mode and saves each result's fields (keys
`<mode>_<field>`). `counts` takes SPEC, a JSON object {name: [seed,
namespace_count, half, [p, n]]} (seed null: the atom-less snapshot,
torch_ring_worker.atomless; namespace_count 0: make_cluster's default;
half: torch_ring_worker.assigned_half, else no pod placed), and saves
JAX's `ring_sig_counts` on a (p, n) mesh for each name, and under the
keys `tenants_<field>` JAX's `solve_many` on the eight tenants of
tests/test_tenants.py with the tenant axis sharded over a (2, 1) mesh.
OUT is an .npz file.

Every multi-device collective of the ring tests runs here, on virtual
CPU devices, and not in the test's own process. Here XLA:CPU gets
rendezvous limits that hold while other test processes load every core
(XLA's defaults abort the whole process when a participant is 40 s late),
and a failure leaves this process's exit code and log instead of taking
the test's worker down.
"""

from __future__ import annotations

import json
import os
import sys

FIELDS = ("assignment", "order", "commit_key", "chosen_score", "final_used")
# XLA:CPU's collective rendezvous: warn after 60 s, abort after 150 s
# (defaults 20 and 40); the abort comes well before the parent test stops
# waiting for this process (RANK_LIMIT_S, counted from its start), so a
# stuck rendezvous ends as this process's own exit code and log.
RENDEZVOUS_FLAGS = ("--xla_cpu_collective_call_warn_stuck_timeout_seconds=60"
                    " --xla_cpu_collective_call_terminate_timeout_seconds=150")
DEVICES = 8  # the most any mesh of the ring tests needs


def main() -> int:
    what, *args, dest = sys.argv[1:]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{DEVICES} {RENDEZVOUS_FLAGS}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from tpusched import Engine
    from tpusched import snapshot
    from tpusched import synth
    from tpusched import tenants
    from tpusched.config import Buckets, EngineConfig
    from tpusched.engine import _sat_tables
    from tpusched.mesh import make_mesh
    from tpusched.ring import ring_sig_counts

    sys.path.insert(0, os.path.join(repo, "tests"))
    import torch_ring_worker as worker

    def mesh(p, n):
        return make_mesh((p, n), devices=jax.devices()[:p * n])

    def ring_snap(seed, **kw):
        return synth.make_cluster(np.random.default_rng(seed), 48, 16,
                                  **dict(worker.RING_MIX, **kw))[0]

    out = {}
    if what == "engine":
        p, n = int(args[0]), int(args[1])
        snap = ring_snap(77)
        for mode in ("parity", "fast"):
            eng = Engine(EngineConfig(mode=mode, ring_counts=True),
                         mesh=mesh(p, n))
            try:
                res = eng.solve(snap)
            finally:
                eng.close()
            for field in FIELDS:
                out[f"{mode}_{field}"] = np.asarray(getattr(res, field))
    elif what == "counts":
        for name, (seed, ns, half, (p, n)) in json.loads(args[0]).items():
            snap = (worker.atomless(snapshot, EngineConfig()) if seed is None
                    else ring_snap(seed, **(dict(namespace_count=ns)
                                            if ns else {})))
            P = np.asarray(snap.pods.valid).shape[0]
            a = (worker.assigned_half(snap) if half
                 else np.full(P, -1, np.int32))
            _, msat = _sat_tables(snap)
            m = mesh(p, n)
            out[name] = np.asarray(jax.jit(
                lambda s, t, x: ring_sig_counts(s, t, x, m))(snap, msat, a))
        bk = Buckets.fit(64, 16, 64, **worker.TENANT_BUCKETS)
        st = tenants.stack_snapshots([synth.make_cluster(
            np.random.default_rng(8800 + b), 20 + 5 * b, 10, buckets=bk,
            **worker.TENANT_MIX)[0] for b in range(worker.TENANTS)])
        sharded = jax.device_put(st, tenants.tenant_sharding(mesh(2, 1), st))
        res = tenants.solve_many_jit(EngineConfig(mode="fast"))(sharded)
        for key, x in zip(("a", "c", "u", "o", "rounds", "ev"), res):
            out[f"tenants_{key}"] = np.asarray(x)
    else:
        raise ValueError(f"unknown reference {what!r}")
    np.savez(dest, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
