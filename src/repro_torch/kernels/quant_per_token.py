"""Per-token e4m3 activation quantizer, in one launch, in front of K2.

The CUDA kernel in `csrc/quant_per_token.cu` computes what
`core/quant.py::quantize_act_per_token` computes (the JAX package's
`repro/core/quant.py::quantize_act_per_token`, which XLA fuses under jit;
no Pallas kernel): one block a row reads the row for its f32 absmax, then
writes the e4m3 codes of x / (amax / 448) and the row's scale, with IEEE
divisions, so codes and scales are bitwise the plain version's. CPU
tensors take the plain version (`ref.quantize_per_token_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_X_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def quant_per_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,K) f32/f16/bf16 x -> (codes (M,K) e4m3, dequant scales (M,1)
    f32): scale = max(absmax of the row, 1e-12) / 448, codes =
    e4m3(clip(x / scale, +-448))."""
    if not _common.on_cuda(x):
        return ref.quantize_per_token_ref(x)
    m, k = x.shape
    if x.dtype not in _X_TYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected f32, f16 or bf16")
    _common.expect(x, "x", x.dtype, (m, k))
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
