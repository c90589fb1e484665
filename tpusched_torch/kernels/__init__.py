"""Device programs of the port, one module per JAX counterpart.

Each hand-written CUDA kernel has a wrapper that launches it on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor (the CPU is
where the tests run; there is no fallback from CUDA to the plain
version). Each wrapper counts its launches in a `launches` attribute.
The helpers below are what the wrappers share: argument checks, the
current stream and the pointers for the ctypes call, and the tenant loop
of the plain versions.

The kernels of the multi-tenant batch (tpusched_torch/tenants.py) take
a leading tenant axis [B, ...] on every per-snapshot tensor; a wrapper
given the solo shapes launches the same kernel with B = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


def check(kernel: str, device: torch.device, t: torch.Tensor,
          dtype: torch.dtype, shape: Sequence[int]) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape on
    this device: the kernels index raw row-major memory."""
    if t.device != device:
        raise ValueError(f"{kernel}: tensor on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: tensor is not contiguous")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptrs(args: Sequence) -> tuple:
    """The C arguments of a launch: each tensor as its data pointer, the
    rest as they are. A wrapper keeps the tensors themselves until the
    launch, so that no temporary is freed (and its memory reused) before
    the kernel is enqueued."""
    return tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _tenant_of(arg, b: int):
    if isinstance(arg, torch.Tensor):
        return arg[b]
    if isinstance(arg, tuple):
        return tuple(_tenant_of(a, b) for a in arg)
    if hasattr(arg, "tenant"):
        return arg.tenant(b)
    return arg


def stack_tenants(outs: list):
    """Stack per-tenant values on a new leading tenant axis: tensors,
    and tuples or dataclasses of them (None stays None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_tenants([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(first)})
    return type(first)(stack_tenants([o[i] for o in outs])
                       for i in range(len(first)))


def per_tenant(fn: Callable, B: int, *args, shared: Sequence[int] = ()):
    """fn once for each of B tenants, its outputs (tensors, or tuples of
    tensors and None) stacked on a new leading tenant axis. Call b gets
    the b-th tenant of each argument: a tensor's b-th slice, a tree's
    `tenant(b)`, each element of a tuple so; the positions in `shared`,
    None and plain values pass as they are. The plain versions take a
    batch this way (they are the reference, not the main path)."""
    return stack_tenants([fn(*(a if i in shared else _tenant_of(a, b)
                        for i, a in enumerate(args))) for b in range(B)])
