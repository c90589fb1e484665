"""Device programs of the port, one module per JAX counterpart.

Each hand-written CUDA kernel has a wrapper that launches it on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor (the CPU is
where the tests run; there is no fallback from CUDA to the plain
version). Each wrapper counts its launches in a `launches` attribute.
The helpers below are what the wrappers share: argument checks, the
current stream and the pointers for the ctypes call.
"""

from __future__ import annotations

from typing import Sequence

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
