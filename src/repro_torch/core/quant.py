"""Dynamic FP8 (E4M3) activation quantization for NestedFP's FP8 mode.

Per-tensor absmax is the paper's scheme; per-token absmax gives every
activation row its own scale, which the serving engine uses so that a
token's FP8 result does not depend on what else shares the batch.
"""

from __future__ import annotations

import torch

from repro_torch.core.nestedfp import E4M3_MAX

_EPS = 1e-12


def _to_e4m3(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)


def _dequant_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 448 as an IEEE division on every device, as the JAX package
    and the quantizer kernel compute it. Divided by a Python number, a
    CUDA tensor is multiplied by the number's reciprocal instead, one f32
    ulp away for about half the amax values (1/448 is not a power of 2)."""
    return amax / torch.full_like(amax, E4M3_MAX)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor absmax in f32, at least 1e-12 (an all-zero x). The max
    is taken in x's own type and only the result is cast: abs and max are
    exact, so this equals casting first, without an f32 copy of x."""
    return torch.clamp(x.abs().max().to(torch.float32), min=_EPS)


def quantize_act_per_tensor(x: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor absmax E4M3 quant. Returns (q, dequant scale ())."""
    scale = _dequant_scale(absmax(x))
    return _to_e4m3(x.to(torch.float32) / scale), scale


def quantize_act_per_token(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token absmax E4M3 quant. x: (..., tokens, features);
    returns (q, dequant scale (..., tokens, 1))."""
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=_EPS)
    scale = _dequant_scale(amax)
    return _to_e4m3(xf / scale), scale
