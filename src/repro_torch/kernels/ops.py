"""Public wrappers over the kernels: leading-dim flattening and scales.

The device of the inputs picks the route: each kernel wrapper launches
its CUDA kernel for CUDA tensors and takes its plain version for CPU
tensors (`kernels/ref.py`). There is no backend switch and no fallback.
The CUDA kernels mask ragged M, N and K themselves, so nothing is padded
here (the JAX package padded to the Pallas block shape).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.f16_matmul import f16_matmul
from repro_torch.kernels.flash_prefill_attention import (
    flash_prefill_attention as _flash_prefill_attention)
from repro_torch.kernels.nestedfp16_matmul import nestedfp16_matmul
from repro_torch.kernels.nestedfp8_matmul import nestedfp8_matmul
from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
    nestedfp8_matmul_fused_quant)
from repro_torch.kernels.nestedfp_encode import nestedfp_encode
from repro_torch.kernels.planar_decode_attention import (
    paged_planar_decode_attention)
from repro_torch.kernels.planar_decode_attention import (
    planar_decode_attention as _planar_decode_attention)
from repro_torch.kernels.quant_per_token import (quant_per_token,
                                                 quant_per_token_scaled,
                                                 row_absmax)

# the eight kernels that replace a Pallas kernel, then the per-token
# quantizer in front of K2 (which replaces an XLA-fused function) and its
# two halves for a mesh's row-parallel layers
KERNEL_FNS = (nestedfp16_matmul, nestedfp8_matmul, f16_matmul,
              paged_planar_decode_attention, _planar_decode_attention,
              _flash_prefill_attention, nestedfp8_matmul_fused_quant,
              nestedfp_encode, quant_per_token, row_absmax,
              quant_per_token_scaled)


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.reshape(-1, k).contiguous()


def matmul_nested_f16(x: torch.Tensor, upper: torch.Tensor,
                      lower: torch.Tensor) -> torch.Tensor:
    """FP16-mode GEMM: x (..., K) f16 @ nested[(K, N)] -> (..., N) f32."""
    k, n = upper.shape
    out = nestedfp16_matmul(_rows(x, k), upper, lower)
    return out.reshape(*x.shape[:-1], n)


def quantize_act_per_token(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax e4m3 quant in one kernel launch: x (..., K)
    f32/f16/bf16 -> (codes (..., K) e4m3, dequant scales (..., 1) f32),
    bitwise `quant.quantize_act_per_token`."""
    k = x.shape[-1]
    q, s = quant_per_token(_rows(x, k))
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def act_row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each row's f32 absmax of x (..., K) -> (..., 1), not clamped, in one
    launch (a row-parallel layer's slice, before the mesh's max)."""
    k = x.shape[-1]
    return row_absmax(_rows(x, k)).reshape(*x.shape[:-1], 1)


def quantize_act_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e4m3 codes of x (..., K) under given row scales (..., 1) f32, in one
    launch, bitwise `quant.quantize_act_scaled`."""
    k = x.shape[-1]
    q = quant_per_token_scaled(_rows(x, k),
                               scale.to(torch.float32).reshape(-1, 1)
                               .contiguous())
    return q.reshape(x.shape)


def matmul_nested_fp8(x_q: torch.Tensor, upper: torch.Tensor,
                      x_scale: torch.Tensor) -> torch.Tensor:
    """FP8-mode GEMM: x_q (..., K) e4m3 @ upper (K, N) -> (..., N) f32.
    x_scale: a scalar per-tensor dequant scale, or (M, 1) per-token row
    scales (M = prod of x_q's leading dims), folded into the kernel's
    epilogue."""
    k, n = upper.shape
    scale = x_scale.to(torch.float32).contiguous()
    if scale.dim() >= 2:
        scale = scale.reshape(-1, 1)
    out = nestedfp8_matmul(_rows(x_q, k), upper, scale)
    return out.reshape(*x_q.shape[:-1], n)


def matmul_f16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain f16 GEMM (exception tensors): (..., K) @ (K, N) -> (..., N)."""
    k, n = w.shape
    out = f16_matmul(_rows(x, k), w)
    return out.reshape(*x.shape[:-1], n)


def paged_decode_attention(q, planes: dict, tables, lens, *, fp8: bool,
                           window=None) -> torch.Tensor:
    """Single-query decode over a paged planar pool: q (B, H, D); planes
    {"k_hi","k_lo","v_hi","v_lo"} of (NB, BS, Hkv, D) -> (B, H, D) f32."""
    return paged_planar_decode_attention(
        q.contiguous(), planes["k_hi"], planes["k_lo"], planes["v_hi"],
        planes["v_lo"], tables.contiguous(), lens.contiguous(), fp8=fp8,
        window=window)


def matmul_nested_fp8_fused_quant(x: torch.Tensor, upper: torch.Tensor,
                                  amax: torch.Tensor) -> torch.Tensor:
    """FP8-mode GEMM with per-tensor activation quantization inside the
    kernel: x (..., K) f16/bf16/f32, amax the absmax of x -> (..., N) f32."""
    k, n = upper.shape
    out = nestedfp8_matmul_fused_quant(
        _rows(x, k), upper, amax.to(torch.float32).reshape(1).contiguous())
    return out.reshape(*x.shape[:-1], n)


def encode(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NestedFP encode of an applicable f16 tensor -> (upper, lower) u8."""
    return nestedfp_encode(w.to(torch.float16).contiguous())


def planar_decode_attention(q, planes: dict, lens, *, fp8: bool,
                            window=None) -> torch.Tensor:
    """Single-query decode over dense per-slot planes: q (B, H, D); planes
    {"k_hi","k_lo","v_hi","v_lo"} of (B, Cap, Hkv, D); lens (B,) >= 1 ->
    (B, H, D) f32."""
    return _planar_decode_attention(
        q.float().contiguous(), planes["k_hi"], planes["k_lo"],
        planes["v_hi"], planes["v_lo"], lens.to(torch.int32).contiguous(),
        fp8=fp8, window=window)


def flash_prefill_attention(q, k, v) -> torch.Tensor:
    """Causal prefill attention: q (B, S, H, D), k/v (B, S, Hkv, D) ->
    (B, S, H, D) f32."""
    return _flash_prefill_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous())


def all_launch_counters() -> dict[str, int]:
    """Launch count of every kernel wrapper (CUDA launches only)."""
    return {f.__name__: f.launches for f in KERNEL_FNS}


def add_launches(counts: dict[str, int]) -> None:
    """Add launches made without a wrapper call: a CUDA graph's replay
    runs the launches that its capture recorded."""
    for f in KERNEL_FNS:
        f.launches += counts.get(f.__name__, 0)


def reset_launch_counters() -> None:
    for f in KERNEL_FNS:
        f.launches = 0
