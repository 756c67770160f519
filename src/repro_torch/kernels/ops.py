"""Public wrappers over the kernels: leading-dim flattening and scales.

The device of the inputs picks the route: each kernel wrapper launches
its CUDA kernel for CUDA tensors and takes its plain version for CPU
tensors (`kernels/ref.py`). There is no backend switch and no fallback.
The CUDA kernels mask ragged M, N and K themselves, so nothing is padded
here (the JAX package padded to the Pallas block shape).

On meta tensors (a reckoning's run, `launch/dryrun.py`) a public
wrapper runs nothing: it returns its kernel's outputs as meta tensors,
and under a FLOP count (`roofline/flops.py`) charges one call of its
kernel: its own FLOPs, in the dtype class the kernel computes in (K1 /
K3 / K4 / K5 / K6 f16 tensor-core work, K2 / K7 e4m3), and whether the
JAX package computes the same as a dot.
The attention kernels are charged every position the JAX step's masked
full-score einsums compute: K5 the cache's capacity, K4 the block
table's, K6 the whole S x S square.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _common
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


def dtype_class(dtype: torch.dtype) -> str:
    """The FLOP class of work on `dtype`: "f16" (f16 and bf16), "e4m3",
    "f32" or "other"."""
    return {torch.float16: "f16", torch.bfloat16: "f16",
            torch.float8_e4m3fn: "e4m3", torch.float32: "f32"}.get(dtype,
                                                                   "other")


def _charged(flops, meta):
    """A public wrapper that meta tensors do not run (its first argument
    on the meta device; the kernel wrapper raises on a mix): meta(*args,
    **kwargs) gives its outputs' shapes and dtypes, the kernel's, and a
    FLOP count (`_common.KERNEL_SCOPE`) charges the call as one launch of
    its kernel, flops(*args, **kwargs) -> (FLOPs, class, is a dot)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not args[0].is_meta:
                return fn(*args, **kwargs)
            scope = _common.KERNEL_SCOPE.get()
            if scope is None:
                return meta(*args, **kwargs)
            return scope(fn.__name__, flops(*args, **kwargs),
                         lambda: meta(*args, **kwargs))
        return call
    return wrap


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _gemm_out(x, w, *_, **__):
    return _empty((*x.shape[:-1], w.shape[1]), torch.float32)


def _like_q(q, *_, **__):
    return _empty(q.shape, torch.float32)


def _gemm(x, w, *_, **__):
    k, n = w.shape
    return 2 * (x.numel() // k) * k * n


def _gemm_f16(*a, **kw):
    return _gemm(*a, **kw), "f16", True


def _gemm_e4m3(*a, **kw):
    return _gemm(*a, **kw), "e4m3", True


def _elementwise(x, *_, **__):
    return x.numel(), dtype_class(x.dtype), False


def _decode_attention(q, planes: dict, keys_of, **_):
    b, h, d = q.shape
    return 4 * b * h * keys_of(planes) * d, "f16", True


@_charged(_gemm_f16, _gemm_out)
def matmul_nested_f16(x: torch.Tensor, upper: torch.Tensor,
                      lower: torch.Tensor) -> torch.Tensor:
    """FP16-mode GEMM: x (..., K) f16 @ nested[(K, N)] -> (..., N) f32."""
    k, n = upper.shape
    out = nestedfp16_matmul(_rows(x, k), upper, lower)
    return out.reshape(*x.shape[:-1], n)


@_charged(lambda x: (2 * x.numel(), dtype_class(x.dtype), False),
          lambda x: (_empty(x.shape, torch.float8_e4m3fn),
                     _empty((*x.shape[:-1], 1), torch.float32)))
def quantize_act_per_token(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax e4m3 quant in one kernel launch: x (..., K)
    f32/f16/bf16 -> (codes (..., K) e4m3, dequant scales (..., 1) f32),
    bitwise `quant.quantize_act_per_token`."""
    k = x.shape[-1]
    q, s = quant_per_token(_rows(x, k))
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


@_charged(_elementwise,
          lambda x: _empty((*x.shape[:-1], 1), torch.float32))
def act_row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each row's f32 absmax of x (..., K) -> (..., 1), not clamped, in one
    launch (a row-parallel layer's slice, before the mesh's max)."""
    k = x.shape[-1]
    return row_absmax(_rows(x, k)).reshape(*x.shape[:-1], 1)


@_charged(_elementwise,
          lambda x, scale: _empty(x.shape, torch.float8_e4m3fn))
def quantize_act_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e4m3 codes of x (..., K) under given row scales (..., 1) f32, in one
    launch, bitwise `quant.quantize_act_scaled`."""
    k = x.shape[-1]
    q = quant_per_token_scaled(_rows(x, k),
                               scale.to(torch.float32).reshape(-1, 1)
                               .contiguous())
    return q.reshape(x.shape)


@_charged(_gemm_e4m3, _gemm_out)
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


@_charged(_gemm_f16, _gemm_out)
def matmul_f16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain f16 GEMM (exception tensors): (..., K) @ (K, N) -> (..., N)."""
    k, n = w.shape
    out = f16_matmul(_rows(x, k), w)
    return out.reshape(*x.shape[:-1], n)


@_charged(lambda q, planes, tables, lens, **kw: _decode_attention(
    q, planes, lambda p: tables.shape[1] * p["k_hi"].shape[1]), _like_q)
def paged_decode_attention(q, planes: dict, tables, lens, *, fp8: bool,
                           window=None) -> torch.Tensor:
    """Single-query decode over a paged planar pool: q (B, H, D); planes
    {"k_hi","k_lo","v_hi","v_lo"} of (NB, BS, Hkv, D) -> (B, H, D) f32."""
    return paged_planar_decode_attention(
        q.contiguous(), planes["k_hi"], planes["k_lo"], planes["v_hi"],
        planes["v_lo"], tables.contiguous(), lens.contiguous(), fp8=fp8,
        window=window)


@_charged(_gemm_e4m3, _gemm_out)
def matmul_nested_fp8_fused_quant(x: torch.Tensor, upper: torch.Tensor,
                                  amax: torch.Tensor) -> torch.Tensor:
    """FP8-mode GEMM with per-tensor activation quantization inside the
    kernel: x (..., K) f16/bf16/f32, amax the absmax of x -> (..., N) f32."""
    k, n = upper.shape
    out = nestedfp8_matmul_fused_quant(
        _rows(x, k), upper, amax.to(torch.float32).reshape(1).contiguous())
    return out.reshape(*x.shape[:-1], n)


@_charged(lambda w: (w.numel(), "other", False),
          lambda w: (_empty(w.shape, torch.uint8), _empty(w.shape, torch.uint8)))
def encode(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NestedFP encode of an applicable f16 tensor -> (upper, lower) u8."""
    return nestedfp_encode(w.to(torch.float16).contiguous())


@_charged(lambda q, planes, lens, **kw: _decode_attention(
    q, planes, lambda p: p["k_hi"].shape[1]), _like_q)
def planar_decode_attention(q, planes: dict, lens, *, fp8: bool,
                            window=None) -> torch.Tensor:
    """Single-query decode over dense per-slot planes: q (B, H, D); planes
    {"k_hi","k_lo","v_hi","v_lo"} of (B, Cap, Hkv, D); lens (B,) >= 1 ->
    (B, H, D) f32."""
    return _planar_decode_attention(
        q.float().contiguous(), planes["k_hi"], planes["k_lo"],
        planes["v_hi"], planes["v_lo"], lens.to(torch.int32).contiguous(),
        fp8=fp8, window=window)


@_charged(lambda q, k, v: (4 * math.prod(q.shape) * k.shape[1],
                           dtype_class(q.dtype), True), _like_q)
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
