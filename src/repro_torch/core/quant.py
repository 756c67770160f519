"""FP8 (E4M3) quantization: NestedFP's activation quant and the paper's
FP8 baseline.

Per-tensor absmax is the paper's activation scheme; per-token absmax
gives every activation row its own scale, which the serving engine uses
so that a token's FP8 result does not depend on what else shares the
batch. The baseline ("FP8(B)", paper Table 2) quantizes weights with
per-channel absmax scales; NestedFP ("FP8(N)") uses one global weight
scale (2^8, `nestedfp.encode`). `quant_error_metrics` compares a weight
with its quantized form, as the JAX package's accuracy benchmark does.
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
    scale = scale_from_amax(xf.abs().amax(dim=-1, keepdim=True))
    return quantize_act_scaled(xf, scale), scale


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """The per-token dequant scale from a row's f32 absmax: max(amax,
    1e-12) / 448. A serving mesh's row-parallel layer takes the max of
    its shards' slice absmaxes first, so each shard quantizes its slice
    under the whole row's scale."""
    return _dequant_scale(torch.clamp(amax, min=_EPS))


def quantize_act_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e4m3(clip(x / scale)) under given row scales (..., tokens, 1):
    `quantize_act_per_token`'s codes, for a column slice of the rows too."""
    return _to_e4m3(x.to(torch.float32) / scale)


# -- weights (baseline only; NestedFP weights come from nestedfp.encode) ------

def quantize_weight_per_channel(w: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Static per-output-channel absmax E4M3 quant. w: (in, out); returns
    (q, dequant scale (1, out))."""
    amax = torch.clamp(w.to(torch.float32).abs().amax(dim=0, keepdim=True),
                       min=_EPS)
    scale = _dequant_scale(amax)
    return _to_e4m3(w.to(torch.float32) / scale), scale


def quantize_weight_per_tensor(w: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Static per-tensor absmax E4M3 quant; returns (q, dequant scale ())."""
    scale = _dequant_scale(absmax(w))
    return _to_e4m3(w.to(torch.float32) / scale), scale


def quant_error_metrics(w: torch.Tensor, w_hat: torch.Tensor
                        ) -> dict[str, float]:
    """MSE, SQNR (dB), cosine similarity and max |error| of w_hat against
    w, summed in f32 as the JAX package does by default."""
    w = w.to(torch.float32)
    w_hat = w_hat.to(torch.float32)
    err = w - w_hat
    mse = torch.mean(err * err)
    sig = torch.mean(w * w)
    eps = torch.tensor(_EPS)
    cos = torch.sum(w * w_hat) / torch.maximum(
        torch.linalg.vector_norm(w.reshape(-1))
        * torch.linalg.vector_norm(w_hat.reshape(-1)), eps)
    return {
        "mse": float(mse),
        "sqnr_db": float(10.0 * torch.log10(torch.maximum(sig, eps)
                                            / torch.maximum(mse, eps))),
        "cosine": float(cos),
        "max_abs_err": float(err.abs().max()),
    }
