"""The yardstick's arithmetic: the card's published peaks, a GEMM call's
FLOPs and bytes, and the model FLOPs of a token.

Peaks are one NVIDIA H100 SXM's data sheet figures (dense, without
sparsity, at its 700 W power limit): 989 TFLOP/s in f16, 1979 in e4m3,
3.35 TB/s of HBM3. A run prints the card's power limit beside them.
Bytes count each input byte read once and each output byte written
once; rows count what the inputs need (active rows, real chunk tokens),
never a bucket's pads.
"""

from __future__ import annotations

from portbench.spec import Model

PEAK_FLOPS = {"fp16": 989e12, "fp8": 1979e12}
HBM_BYTES_S = 3.35e12


def linear_shapes(m: Model) -> list[tuple[int, int]]:
    """(K, N) of each nested linear of one layer (the attention
    projections, and a dense layer's SwiGLU)."""
    d, hd = m.d_model, m.head_dim
    out = [(d, m.n_heads * hd), (d, m.n_kv_heads * hd),
           (d, m.n_kv_heads * hd), (m.n_heads * hd, d)]
    if not m.moe:
        out += [(d, m.d_ff), (d, m.d_ff), (m.d_ff, d)]
    return out


def k1_call(rows: int, k: int, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K1 call: x (rows, K) f16, both u8 planes of
    W (K, N), out (rows, N) f32."""
    return 2.0 * rows * k * n, 2.0 * k * n + 2.0 * rows * k + 4.0 * rows * n


def k1_bound_s(m: Model, rows: int) -> float:
    """Least time of one dispatch's K1 calls (every layer's nested
    linears at `rows` rows): each call the larger of its FLOPs at the f16
    peak and its bytes at the HBM rate."""
    one = 0.0
    for k, n in linear_shapes(m):
        f, b = k1_call(rows, k, n)
        one += max(f / PEAK_FLOPS["fp16"], b / HBM_BYTES_S)
    return m.n_layers * one


def decode_floor_s(m: Model, rows: int) -> float:
    """Least time of one decode dispatch at `rows` rows: every layer's
    nested linears at their bound (`k1_bound_s`), the experts that `rows`
    tokens can choose read once, and the f32 LM head read once."""
    s = k1_bound_s(m, rows)
    if m.moe:
        experts = min(m.n_experts, rows * m.top_k)
        s += m.n_layers * experts * 3 * m.d_model * m.d_ff_expert * 2 \
            / HBM_BYTES_S
    return s + 4.0 * m.d_model * m.vocab / HBM_BYTES_S


def params_per_token(m: Model) -> int:
    """Weights one token multiplies: every layer's linears (an MoE's
    router and its top-k experts only) and the LM head."""
    per = sum(k * n for k, n in linear_shapes(m))
    if m.moe:
        per += m.d_model * m.n_experts + m.top_k * 3 * m.d_model * m.d_ff_expert
    return m.n_layers * per + m.d_model * m.vocab


def attn_flops(m: Model, keys: int) -> float:
    """Attention FLOPs of one query over `keys` keys, every layer: the
    scores and the weighted sum, 2 * 2 * keys * heads * head_dim."""
    return 4.0 * keys * m.n_heads * m.head_dim * m.n_layers


def token_flops(m: Model, position: int) -> float:
    """Model FLOPs of the token at `position` (it attends position + 1
    keys)."""
    return 2.0 * params_per_token(m) + attn_flops(m, position + 1)


def prompt_flops(m: Model, n: int) -> float:
    """Model FLOPs of prefilling an n-token prompt (positions 0..n-1)."""
    return 2.0 * params_per_token(m) * n + attn_flops(m, 1) * n * (n + 1) / 2
