"""NFP004 fixture (good): every pointer checked or allocated, the return
code checked, the current stream, the tensors' own card; a query entry
(argtypes without a stream) launches nothing and is not held to it."""

import ctypes

import torch

from repro_torch.kernels import _build, _common

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _check(x, scale):
    m, n = x.shape
    _common.expect(x, "x", torch.float32, (m, n))
    _common.expect(scale, "scale", torch.float32, (m, 1))


def _scratch(m, device):
    if m <= 1:
        return None
    return torch.empty(m, dtype=torch.float32, device=device)


def scale_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    m, n = x.shape
    _check(x, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = _scratch(m, x.device)
    fn = _build.function("scale_rows", "scale_rows", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(),
                 0 if part is None else part.data_ptr(), m, n,
                 _common.stream_handle(x.device))
    _build.check(err, "scale_rows")
    return out


def smem_bytes(x: torch.Tensor) -> int:
    fn = _build.function("scale_rows", "scale_rows_smem",
                         [ctypes.c_void_p] + [ctypes.c_int] * 2)
    return int(fn(x.data_ptr(), *x.shape))
