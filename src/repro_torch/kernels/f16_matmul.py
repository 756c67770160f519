"""K3: plain f16 GEMM (exception tensors; the reconstruction baseline).

Port of `repro/kernels/f16_matmul.py::f16_matmul` (a Pallas TPU kernel)
to the CUDA kernel in `csrc/f16_matmul.cu`, which runs K1's body (and its
shape rule) without the rebuild. CPU tensors take the plain version
(`ref.matmul_f16_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def f16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) f16 @ (K,N) f16 -> (M,N) f32."""
    if not _common.on_cuda(x, w):
        return ref.matmul_f16_ref(x, w)
    m, k = x.shape
    n = w.shape[1]
    _common.expect(x, "x", torch.float16, (m, k))
    _common.expect(w, "w", torch.float16, (k, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("f16_matmul", "f16_matmul", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                 _common.stream_handle(x.device))
    _build.check(err, "f16_matmul")
    f16_matmul.launches += 1
    return out


f16_matmul.launches = 0


def dynamic_smem_bytes(x: torch.Tensor, w: torch.Tensor) -> int:
    """Dynamic shared memory of the body the C entry picks for these
    operands: 0 for the WMMA body, whose tiles are static."""
    fn = _build.function("f16_matmul", "f16_matmul_smem",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
    k, n = w.shape
    return int(fn(x.data_ptr(), w.data_ptr(), x.shape[0], n, k))
