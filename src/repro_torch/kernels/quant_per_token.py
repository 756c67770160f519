"""Per-token e4m3 activation quantizer, in one launch, in front of K2.

The CUDA kernel in `csrc/quant_per_token.cu` computes what
`core/quant.py::quantize_act_per_token` computes (the JAX package's
`repro/core/quant.py::quantize_act_per_token`, which XLA fuses under jit;
no Pallas kernel): one block a row reads the row for its f32 absmax, then
writes the e4m3 codes of x / (amax / 448) and the row's scale, with IEEE
divisions, so codes and scales are bitwise the plain version's. CPU
tensors take the plain version (`ref.quantize_per_token_ref`).

A serving mesh's row-parallel layers quantize column slices of rows under
the whole row's scale, in two launches of the same kernel's other entry
points: `row_absmax` (each slice's absmax; the mesh takes the max across
shards) and `quant_per_token_scaled` (the slice's codes under the row
scale from `quant.scale_from_amax`), bitwise the one-launch codes at those
columns. Plain versions: `ref.row_absmax_ref`, `ref.quantize_scaled_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_AMAX_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
              + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_X_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check_x(x: torch.Tensor) -> tuple[int, int]:
    m, k = x.shape
    if x.dtype not in _X_TYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected f32, f16 or bf16")
    _common.expect(x, "x", x.dtype, (m, k))
    return m, k


def quant_per_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,K) f32/f16/bf16 x -> (codes (M,K) e4m3, dequant scales (M,1)
    f32): scale = max(absmax of the row, 1e-12) / 448, codes =
    e4m3(clip(x / scale, +-448))."""
    if not _common.on_cuda(x):
        return ref.quantize_per_token_ref(x)
    m, k = _check_x(x)
    codes = torch.empty((m, k), dtype=torch.uint8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = _build.function("quant_per_token", "quant_per_token", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _X_TYPES[x.dtype], codes.data_ptr(),
                 scale.data_ptr(), m, k, _common.stream_handle(x.device))
    _build.check(err, "quant_per_token")
    quant_per_token.launches += 1
    return codes.view(torch.float8_e4m3fn), scale


quant_per_token.launches = 0


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """(M,K) f32/f16/bf16 x -> (M,1) f32 max |x| of each row (not
    clamped), one launch."""
    if not _common.on_cuda(x):
        return ref.row_absmax_ref(x)
    m, k = _check_x(x)
    amax = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = _build.function("quant_per_token", "row_absmax", _AMAX_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _X_TYPES[x.dtype], amax.data_ptr(), m, k,
                 _common.stream_handle(x.device))
    _build.check(err, "row_absmax")
    row_absmax.launches += 1
    return amax


row_absmax.launches = 0


def quant_per_token_scaled(x: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    """(M,K) f32/f16/bf16 x and (M,1) f32 row scales -> (M,K) e4m3 codes
    e4m3(clip(x / scale, +-448)), one launch."""
    if not _common.on_cuda(x, scale):
        return ref.quantize_scaled_ref(x, scale)
    m, k = _check_x(x)
    _common.expect(scale, "scale", torch.float32, (m, 1))
    codes = torch.empty((m, k), dtype=torch.uint8, device=x.device)
    fn = _build.function("quant_per_token", "quant_per_token_scaled", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _X_TYPES[x.dtype], codes.data_ptr(),
                 scale.data_ptr(), m, k, _common.stream_handle(x.device))
    _build.check(err, "quant_per_token_scaled")
    quant_per_token_scaled.launches += 1
    return codes.view(torch.float8_e4m3fn)


quant_per_token_scaled.launches = 0
