"""K7: FP8-mode GEMM that quantizes its f16/bf16/f32 activations itself.

Port of `repro/kernels/nestedfp8_matmul.py::nestedfp8_matmul_fused_quant`
(a Pallas TPU kernel) to the CUDA kernel in
`csrc/nestedfp8_matmul_fused_quant.cu`. The per-tensor amax is taken
outside the kernel, as the JAX wrapper expects. The C entry quantizes x
once into a scratch of e4m3 codes that this wrapper allocates, then runs
the FP8 tensor-core GEMM (`mma.sync` e4m3); shapes with K or N not a
multiple of 16, or an `upper` that is not 16-byte aligned, take the
in-register body instead (the shape rule at the top of the source). CPU
tensors take the plain version (`ref.nestedfp8_matmul_fused_quant_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_X_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def nestedfp8_matmul_fused_quant(x: torch.Tensor, upper: torch.Tensor,
                                 amax: torch.Tensor) -> torch.Tensor:
    """(M,K) f16/bf16/f32 x, quantized in the kernel to e4m3 with
    448/amax, @ upper[(K,N) u8 read as e4m3] * (amax/448) * 2^-8 ->
    (M,N) f32. amax: one f32 element, the absmax of x (> 0)."""
    if not _common.on_cuda(x, upper, amax):
        return ref.nestedfp8_matmul_fused_quant_ref(x, upper, amax)
    m, k = x.shape
    n = upper.shape[1]
    if x.dtype not in _X_TYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected f32, f16 or bf16")
    _common.expect(x, "x", x.dtype, (m, k))
    _common.expect(upper, "upper", torch.uint8, (k, n))
    _common.expect(amax, "amax", torch.float32, (1,))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    mma_body = dynamic_smem_bytes(upper, m) > 0
    codes = torch.empty((m, k) if mma_body else (0,), dtype=torch.uint8,
                        device=x.device)
    fn = _build.function("nestedfp8_matmul_fused_quant",
                         "nestedfp8_matmul_fused_quant", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _X_TYPES[x.dtype], upper.data_ptr(),
                 amax.data_ptr(), codes.data_ptr(), out.data_ptr(), m, n, k,
                 _common.stream_handle(x.device))
    _build.check(err, "nestedfp8_matmul_fused_quant")
    nestedfp8_matmul_fused_quant.launches += 1
    return out


nestedfp8_matmul_fused_quant.launches = 0


def dynamic_smem_bytes(upper: torch.Tensor, m: int) -> int:
    """Dynamic shared memory of the body the C entry picks for m rows of
    x against this (K, N) `upper`: 0 for the in-register body, whose tiles
    are static."""
    fn = _build.function("nestedfp8_matmul_fused_quant",
                         "nestedfp8_matmul_fused_quant_smem",
                         [ctypes.c_void_p] + [ctypes.c_int] * 3)
    k, n = upper.shape
    return int(fn(upper.data_ptr(), m, n, k))
