"""The device mesh: the port of `tpusched/mesh.py`.

A mesh lays the ranks of a `torch.distributed` process group out as a
(p, n) grid, row-major, as `np.asarray(devices).reshape(shape)` lays out
JAX's devices: POD_AXIS first, NODE_AXIS second. Each rank drives one
device, `cuda:<local rank>` (the rank modulo the host's card count)
unless the caller asks for the CPU. The ranks of one n coordinate form a
p ring: the pairwise count ring (`ring.ring_sig_counts`) rotates its
signature blocks around it and gathers them back over it, and the tenant
batch (`tenants.solve_many`) splits its tenants over it.

What JAX's SPMD partitioner does to the rest of the solve (the [P, N]
passes sharded over p and n) is not here: every rank runs the rest of
the solve whole on its own device.

Process groups come from `init_distributed`, with an explicit rendezvous
(a FileStore path, or an address with the world size and this rank):
NCCL for CUDA devices, gloo for the CPU. Without a process group,
`make_mesh()` is a one-rank mesh on the default card, as JAX's is on one
device.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

POD_AXIS = "p"
NODE_AXIS = "n"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     store_path: str | None = None, device=None,
                     timeout_s: float = 300.0) -> None:
    """Join this process to a process group of `num_processes` ranks as
    rank `process_id` (JAX `jax.distributed.initialize`'s arguments).
    The rendezvous is explicit: `coordinator_address` ("host:port", a TCP
    store served by rank 0) or `store_path` (a FileStore file every rank
    can reach), exactly one of them. device: None for the rank's card
    (NCCL; raises without CUDA), "cpu" for gloo. One all-reduce on the
    rank's device follows, so a backend that cannot connect raises here
    and not at the first solve."""
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and "
                         "process_id: the port has no cluster auto-detection")
    if (coordinator_address is None) == (store_path is None):
        raise ValueError("init_distributed: give exactly one rendezvous, "
                         "coordinator_address or store_path")
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh runs NCCL on the GPU; pass "
                "device='cpu' explicitly for gloo")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = dict(backend="gloo" if cpu else "nccl", world_size=num_processes,
              rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, num_processes)
    else:
        kw["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(**kw)
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    if int(one.item()) != num_processes:
        raise RuntimeError(f"init_distributed: the all-reduce gave "
                           f"{one.item()} over {num_processes} ranks")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (p, n) mesh. `shape` maps each axis name to
    its size (JAX `Mesh.shape`); `ranks` [p, n] holds the global ranks.
    `p_groups` holds the process group of each n coordinate's p ring, in
    n order (empty at one rank)."""

    shape: dict
    ranks: np.ndarray
    rank: int
    device: torch.device
    p_groups: tuple

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coords(self) -> tuple[int, int]:
        """(p index, n index) of this rank."""
        p, n = np.argwhere(self.ranks == self.rank)[0]
        return int(p), int(n)

    def p_shift(self, buf: torch.Tensor) -> torch.Tensor:
        """Send buf to the next rank of this rank's p ring and return what
        the previous one sent (JAX `ppermute` with perm i -> i + 1); the
        identity on a ring of one."""
        p, n = self.coords
        ring = self.ranks[:, n]
        if ring.shape[0] == 1:
            return buf
        out = torch.empty_like(buf)
        nxt = int(ring[(p + 1) % ring.shape[0]])
        prv = int(ring[(p - 1) % ring.shape[0]])
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, nxt),
                dist.P2POp(dist.irecv, out, prv)]):
            req.wait()
        return out

    def p_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t of this rank's p ring, concatenated along dim 0
        in p order (JAX's gather of a PS('p') output); t itself on a ring
        of one. bool goes over the wire as uint8."""
        p, n = self.coords
        if self.ranks.shape[0] == 1:
            return t
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.ranks.shape[0])]
        dist.all_gather(parts, wire, group=self.p_groups[n])
        out = torch.cat(parts)
        return out.bool() if t.dtype == torch.bool else out


def mesh_device(mesh: Mesh | None, device):
    """The device of a caller on `mesh`: `device` as given without a
    mesh; with one, the mesh rank's device, which a `device` given and
    different contradicts (ValueError)."""
    if mesh is None:
        return device
    if device is not None:
        want = torch.device(device)
        if (want.type == mesh.device.type == "cuda"
                and want.index is None):
            want = torch.device("cuda", torch.cuda.current_device())
        if want != mesh.device:
            raise ValueError(f"device={device!r}: the mesh's rank runs on "
                             f"{mesh.device}")
    return mesh.device


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """The (p, n) mesh of this process group's ranks, row-major. Default
    shape: every rank on the p axis, (world, 1). devices: None for each
    rank's card (cuda:<local rank>), or this rank's device ("cpu" for
    the plain versions, as the tests run). Without a process group the mesh
    has one rank, on the default card. Every rank must call it, with the
    same shape: it creates each n coordinate's p-ring group, in order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world, 1)
    p, n = (int(x) for x in shape)
    if p * n != world:
        raise ValueError(f"mesh shape {(p, n)} needs {p * n} ranks, the "
                         f"process group has {world}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh runs on the GPU; pass "
                "devices='cpu' explicitly to run the plain versions")
        device = torch.device("cuda", (rank % torch.cuda.device_count())
                              if dist.is_initialized()
                              else torch.cuda.current_device())
    else:
        device = torch.device(devices)
    if world > 1 and (dist.get_backend() == "nccl") != (device.type == "cuda"):
        raise ValueError(f"a {dist.get_backend()} process group cannot drive "
                         f"{device}: NCCL for CUDA devices, gloo for the CPU")
    ranks = np.arange(world).reshape(p, n)
    groups = tuple(dist.new_group(ranks=ranks[:, j].tolist())
                   for j in range(n)) if world > 1 else ()
    return Mesh(shape={POD_AXIS: p, NODE_AXIS: n}, ranks=ranks, rank=rank,
                device=device, p_groups=groups)
