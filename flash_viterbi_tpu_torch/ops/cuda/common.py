"""Dispatch and argument checks shared by the kernel wrappers.

A wrapper runs its plain PyTorch version only because its tensors lie on
the CPU; on CUDA tensors it launches the hand-written kernel or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ...runtime import build

# dynamic shared memory one H100 block can use (227 KB)
SMEM_LIMIT = 232448


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise or
    when the tensors do not share one device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel and no plain version for device {dev}")


def expect(name: str, t: torch.Tensor, dtype: torch.dtype | tuple, shape: tuple) -> None:
    """Raise unless ``t`` has this dtype (or one of a tuple of them) and shape."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def expect_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def launch(fn_name: str, counter, device: torch.device, *args) -> None:
    """Call C entry point ``fn_name`` on ``device``'s current stream; add
    the launches it made to ``counter.launches``; raise on a CUDA error."""
    lib = build.kernels()
    n = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream, ctypes.byref(n))
    counter.launches += n.value
    build.check(rc, fn_name)
