"""NFP004 fixture (bad): a ctypes kernel launch that passes an unchecked
tensor's pointer, drops its return code, launches on the legacy stream
and ignores which card the tensors are on."""

import ctypes

import torch

from repro_torch.kernels import _build, _common

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def scale_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    m, n = x.shape
    _common.expect(x, "x", torch.float32, (m, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("scale_rows", "scale_rows", _ARGS)
    fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, 0)  # expect: NFP004 NFP004 NFP004 NFP004
    return out
