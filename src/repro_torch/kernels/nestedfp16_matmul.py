"""K1: FP16-mode GEMM with in-kernel NestedFP reconstruction.

Port of `repro/kernels/nestedfp16_matmul.py::nestedfp16_matmul` (a Pallas
TPU kernel) to the CUDA kernel in `csrc/nestedfp16_matmul.cu`: a TMA +
wgmma body (`csrc/wgmma_gemm.cuh`) when N % 16 == 0, K % 8 == 0 and the
operands are 16-byte aligned, else the WMMA body of `csrc/gemm_tile.cuh`
(the shape rule is decided in C before any launch). The wrapper takes the
plain version (`ref.nestedfp16_matmul_ref`) for CPU tensors only; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def nestedfp16_matmul(x: torch.Tensor, upper: torch.Tensor,
                      lower: torch.Tensor) -> torch.Tensor:
    """(M,K) f16 @ nested[(K,N) u8 upper, lower] -> (M,N) f32."""
    if not _common.on_cuda(x, upper, lower):
        return ref.nestedfp16_matmul_ref(x, upper, lower)
    m, k = x.shape
    n = upper.shape[1]
    _common.expect(x, "x", torch.float16, (m, k))
    _common.expect(upper, "upper", torch.uint8, (k, n))
    _common.expect(lower, "lower", torch.uint8, (k, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("nestedfp16_matmul", "nestedfp16_matmul", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), upper.data_ptr(), lower.data_ptr(),
                 out.data_ptr(), m, n, k, _common.stream_handle(x.device))
    _build.check(err, "nestedfp16_matmul")
    nestedfp16_matmul.launches += 1
    return out


nestedfp16_matmul.launches = 0


def dynamic_smem_bytes(x: torch.Tensor, upper: torch.Tensor,
                       lower: torch.Tensor) -> int:
    """Dynamic shared memory of the body the C entry picks for these
    operands: 0 for the WMMA body, whose tiles are static."""
    fn = _build.function("nestedfp16_matmul", "nestedfp16_matmul_smem",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)
    k, n = upper.shape
    return int(fn(x.data_ptr(), upper.data_ptr(), lower.data_ptr(),
                  x.shape[0], n, k))
