"""K2: FP8-mode GEMM on the NestedFP upper plane.

Port of `repro/kernels/nestedfp8_matmul.py::nestedfp8_matmul` (a Pallas
TPU kernel) to the CUDA kernel in `csrc/nestedfp8_matmul.cu`, which runs
the TMA + `mma.sync` e4m3 body it shares with K7 (`csrc/fp8_mma_gemm.cuh`).
The kernel reads only `upper` (1 byte a weight) and folds the activation
scale — one scalar, or one factor a row — and 2^-8 into its epilogue.
Shapes with K or N not a multiple of 16, or an `upper` or `x_q` that is
not 16-byte aligned (a view into a larger buffer), take the WMMA body of
`csrc/gemm_tile.cuh` instead; the C entry decides before it launches.
CPU tensors take the plain version (`ref.nestedfp8_matmul_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def nestedfp8_matmul(x_q: torch.Tensor, upper: torch.Tensor,
                     x_scale: torch.Tensor) -> torch.Tensor:
    """(M,K) e4m3 @ upper[(K,N) u8 read as e4m3] * x_scale * 2^-8 ->
    (M,N) f32. x_scale: f32 with one element (per-tensor) or M elements
    (per-token, shape (M,1))."""
    if not _common.on_cuda(x_q, upper, x_scale):
        return ref.nestedfp8_matmul_ref(x_q, upper, x_scale)
    m, k = x_q.shape
    n = upper.shape[1]
    _common.expect(x_q, "x_q", torch.float8_e4m3fn, (m, k))
    _common.expect(upper, "upper", torch.uint8, (k, n))
    if x_scale.dtype != torch.float32 or not x_scale.is_contiguous():
        raise TypeError("x_scale: contiguous float32 expected")
    if x_scale.numel() == 1:
        stride = 0
    elif x_scale.numel() == m and x_scale.shape[-1] == 1:
        stride = 1
    else:
        raise ValueError(f"x_scale: shape {tuple(x_scale.shape)} is neither "
                         f"a scalar nor ({m}, 1)")
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    fn = _build.function("nestedfp8_matmul", "nestedfp8_matmul", _ARGS)
    with torch.cuda.device(x_q.device):
        err = fn(x_q.data_ptr(), upper.data_ptr(), x_scale.data_ptr(), stride,
                 out.data_ptr(), m, n, k, _common.stream_handle(x_q.device))
    _build.check(err, "nestedfp8_matmul")
    nestedfp8_matmul.launches += 1
    return out


nestedfp8_matmul.launches = 0


def dynamic_smem_bytes(x_q: torch.Tensor, upper: torch.Tensor) -> int:
    """Dynamic shared memory of the body the C entry picks for these
    operands: 0 for the WMMA body, whose tiles are static."""
    fn = _build.function("nestedfp8_matmul", "nestedfp8_matmul_smem",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
    m = x_q.shape[0]
    k, n = upper.shape
    return int(fn(x_q.data_ptr(), upper.data_ptr(), m, n, k))
