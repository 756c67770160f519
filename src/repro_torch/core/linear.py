"""NestedLinear: a linear layer readable at two precisions (paper §4).

One weight copy (2 bytes/weight) serves both modes:
  mode="fp16": lossless path — f16 GEMM on the weights rebuilt inside the
               kernel from the two byte planes (K1).
  mode="fp8":  fast path — dynamic absmax activation quant, GEMM on the
               upper byte alone, dequant by act_scale * 2^-8.
               `act_quant` picks the scale granularity: "per_tensor" (the
               paper's scheme; one torch reduction for the amax, then K7
               quantizes inside the GEMM) or "per_token" (one scale per
               activation row, which makes every token's result
               independent of what shares the batch — the serving
               engine's choice; one launch of the per-token quantizer,
               then K2).
Exception tensors (any |w| > 1.75) always run the f16 path (K3), in both
modes (paper §4.2 "Handling Exception Layers").
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import nestedfp as nf
from repro_torch.core import quant
from repro_torch.kernels import ops

Mode = Literal["fp16", "fp8"]


@dataclasses.dataclass
class NestedLinearParams:
    """Weight (K,N) in NestedFP form + optional f32 bias (N,)."""
    weight: nf.NestedTensor
    bias: torch.Tensor | None

    def tensors(self) -> list[torch.Tensor]:
        return self.weight.tensors() + ([self.bias] if self.bias is not None
                                        else [])

    def to(self, device) -> "NestedLinearParams":
        return NestedLinearParams(
            self.weight.to(device),
            None if self.bias is None else self.bias.to(device))


def nested_linear(params: NestedLinearParams, x: torch.Tensor, *,
                  mode: Mode = "fp16", out_dtype=None,
                  fast_accum: bool = False,
                  act_quant: str = "per_tensor") -> torch.Tensor:
    """y = x @ W (+ b) at the selected precision. x: (..., K) -> (..., N)
    in out_dtype (default x.dtype). fast_accum rounds the GEMM output to
    bf16 before the bias, as the JAX package's bf16 accumulation does."""
    out_dtype = out_dtype or x.dtype
    w = params.weight
    if w.is_exception:
        y = ops.matmul_f16(x.to(torch.float16), w.raw)
    elif mode == "fp16":
        y = ops.matmul_nested_f16(x.to(torch.float16), w.upper, w.lower)
    elif mode == "fp8":
        if act_quant == "per_token":
            xq, scale = ops.quantize_act_per_token(x)
            y = ops.matmul_nested_fp8(xq, w.upper, scale.reshape(-1, 1))
        elif act_quant == "per_tensor":
            y = ops.matmul_nested_fp8_fused_quant(x, w.upper,
                                                  quant.absmax(x))
        else:
            raise ValueError(f"unknown act_quant {act_quant!r}")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if fast_accum:
        y = y.to(torch.bfloat16)
    if params.bias is not None:
        y = y + params.bias
    return y.to(out_dtype)
