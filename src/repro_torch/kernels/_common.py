"""Argument checks shared by the kernel wrappers, and the scope through
which a FLOP count sees them."""

from __future__ import annotations

import contextvars

import torch

# Set by a FLOP count (`roofline.flops.count`) while it runs a step on
# meta tensors: the public wrappers of `kernels/ops.py` hand each call to
# it, to be charged as its kernel's work and not as the plain version's.
KERNEL_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "kernel_scope", default=None)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises on a mix. A wrapper takes its plain
    version only in the False case."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
