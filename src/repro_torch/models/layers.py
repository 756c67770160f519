"""Building blocks of the dense decoder, on torch tensors (paged phase).

Param conventions, as in the JAX package: every linear is a dict
{"w": (K,N)[, "b": (N,)]} in training form, or a NestedLinearParams after
`to_serving`. Activations run in `rt.dtype`; matmuls accumulate in f32.

Only the "paged" attention phase is ported: the serving engine runs
every prefill chunk and every decode step through it. The block pool is
updated IN PLACE (the JAX package returned a new pool from a donated
one). Single-token decode over a byte-planar pool goes through K4
(`ops.paged_decode_attention`) with the block table handed over as is;
prefill chunks and non-planar pools gather keys in logical order and run
`attn_core_paged` as plain torch ops.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.linear import NestedLinearParams, nested_linear
from repro_torch.core.nestedfp import e5m2_view, join_bytes, split_bytes
from repro_torch.kernels import ops

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through all apply functions."""
    mode: str = "fp16"                   # "fp16" | "fp8"
    dtype: torch.dtype = torch.float32   # activation dtype
    act_quant: str = "per_tensor"        # fp8 scale granularity


def apply_linear(rt: Runtime, p, x: torch.Tensor) -> torch.Tensor:
    """Dispatch a linear layer: plain (LM head) or NestedFP (serving)."""
    if isinstance(p, NestedLinearParams):
        mode = "fp8" if rt.mode == "fp8" else "fp16"
        return nested_linear(p, x, mode=mode, out_dtype=rt.dtype,
                             act_quant=rt.act_quant)
    y = x.to(rt.dtype).float() @ p["w"].to(rt.dtype).float()
    if p.get("b") is not None:
        y = y + p["b"]
    return y.to(rt.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S). Split-half convention."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (B,S,half)
    cos = torch.cos(ang)[..., None, :]                          # (B,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def swiglu(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = apply_linear(rt, p["gate"], x)
    up = apply_linear(rt, p["up"], x)
    return apply_linear(rt, p["down"], F.silu(gate) * up)


def _apply_window(mask, qpos, kpos, window):
    """window: None (global) or an int where values <= 0 mean global."""
    if window is None or window <= 0:
        return mask
    return mask & (kpos > qpos - window)


def attn_core_paged(q, k, v, *, q_offset, kv_len, window=None):
    """Chunked attention over keys gathered from the block pool in logical
    order. q: (B,C,H,Dq); k/v: (B,Cap,Hkv,·); q_offset: (B,) position of
    each row's first query; kv_len: (B,) valid keys per row. Positions at
    or beyond kv_len hold trash-block garbage and are masked."""
    b, c, h, dq = q.shape
    cap, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = (q.reshape(b, c, hkv, g, dq) * (dq ** -0.5)).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    qpos = q_offset[:, None] + torch.arange(c, device=q.device)[None, :]
    kpos = torch.arange(cap, device=q.device)
    mask = kpos[None, None, :] <= qpos[..., None]            # (B,C,Cap) causal
    mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
    mask = _apply_window(mask, qpos[..., None], kpos[None, None, :], window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, c, h, v.shape[-1])


def _qkv(rt, p, cfg, x, positions):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = apply_linear(rt, p["wq"], x).reshape(b, s, h, hd)
    k = apply_linear(rt, p["wk"], x).reshape(b, s, hkv, hd)
    v = apply_linear(rt, p["wv"], x).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_paged(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                    positions, cache: dict, kv_len, paged, window=None):
    """GQA attention of one layer over its block pool.

    cache: this layer's pool planes, each (NB, BS, Hkv, ·) — {"k","v"}
    f16, or the byte-planar {"k_hi","k_lo","v_hi","v_lo"} u8 — written in
    place. paged: (phys_write (B,C), phys_read (B,Cap), q_offset (B,),
    tables (B,MB) int32) — flat physical indices into the pool (pad and
    inactive columns point at the trash block) plus the block table."""
    b, c = x.shape[0], x.shape[1]
    phys_write, phys_read, q_offset, tables = paged
    q, k, v = _qkv(rt, p, cfg, x, positions)
    wf = phys_write.reshape(-1)

    def flat(a):     # (NB, BS, ...) pool -> (NB*BS, ...) view
        return a.view(-1, *a.shape[2:])

    if "k_hi" in cache:
        for (hi, lo), val in ((("k_hi", "k_lo"), k), (("v_hi", "v_lo"), v)):
            vh, vl = split_bytes(val.reshape(-1, *val.shape[2:]))
            flat(cache[hi])[wf] = vh
            flat(cache[lo])[wf] = vl
        if c == 1:
            # single-token decode: K4 reads the planes in place through
            # the block table (fp8 mode touches only the hi planes)
            o = ops.paged_decode_attention(
                q[:, 0], cache, tables, kv_len, fp8=rt.mode == "fp8",
                window=window)[:, None]
            o = o.reshape(b, c, -1).to(rt.dtype)
            return apply_linear(rt, p["wo"], o)
        if rt.mode == "fp8":
            kc = e5m2_view(flat(cache["k_hi"])[phys_read], torch.float16)
            vc = e5m2_view(flat(cache["v_hi"])[phys_read], torch.float16)
        else:
            kc = join_bytes(flat(cache["k_hi"])[phys_read],
                            flat(cache["k_lo"])[phys_read])
            vc = join_bytes(flat(cache["v_hi"])[phys_read],
                            flat(cache["v_lo"])[phys_read])
    else:
        kf, vf = flat(cache["k"]), flat(cache["v"])
        kf[wf] = k.reshape(-1, *k.shape[2:]).to(kf.dtype)
        vf[wf] = v.reshape(-1, *v.shape[2:]).to(vf.dtype)
        kc, vc = kf[phys_read], vf[phys_read]
    o = attn_core_paged(q, kc, vc, q_offset=q_offset, kv_len=kv_len,
                        window=window)
    o = o.reshape(b, c, -1).to(rt.dtype)
    return apply_linear(rt, p["wo"], o)
