"""Building blocks of the dense decoder, on torch tensors.

Param conventions, as in the JAX package: every linear is a dict
{"w": (K,N)[, "b": (N,)]} in training form, or a NestedLinearParams after
`to_serving`. Activations run in `rt.dtype`; matmuls accumulate in f32.

Three attention phases are ported, each its own function (the JAX
package's `attention(phase=...)`):

- `attention_paged`, the serving engine's: every prefill chunk and decode
  step over the block pool. Single-token decode over a byte-planar pool
  goes through K4 (`ops.paged_decode_attention`) with the block table
  handed over as is; prefill chunks and non-planar pools gather keys in
  logical order and run `attn_core_paged` as plain torch ops.
- `attention_prefill`, the dense-slot prompt pass: K6
  (`ops.flash_prefill_attention`) for global layers.
- `attention_decode`, the dense-slot decode step: over byte-planar
  caches K5 (`ops.planar_decode_attention`), over f16 caches the plain
  `attn_core_decode`, as in the JAX package.

An encoder-decoder (seamless) adds two more, both plain torch ops over
materialized scores (`attn_core_train`), as the JAX package computes them
outside any Pallas kernel: `attention_encode`, the encoder's
bidirectional self-attention, and `cross_attention`, the decoder's
attention over the encoder's memory or over its cached projections.

Caches and pools are updated IN PLACE (the JAX package returned new ones
from donated buffers). The `attn_core_*` functions are the plain torch
references of the JAX package's attention cores.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.linear import NestedLinearParams, nested_linear
from repro_torch.core.nestedfp import e5m2_view, join_bytes, split_bytes
from repro_torch.kernels import ops, ref

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers (random draws from a seeded generator)
# ---------------------------------------------------------------------------

def randn(gen, shape) -> torch.Tensor:
    """f32 normal draws from `gen`; a meta device in its place gives the
    shape alone (no data, no draw)."""
    if isinstance(gen, torch.device):
        return torch.empty(shape, dtype=torch.float32, device=gen)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def device_of(gen) -> torch.device:
    return gen if isinstance(gen, torch.device) else gen.device


def keep(w: torch.Tensor):
    """The identity: a weight kept as drawn (see `init_linear`'s `put`)."""
    return w


def init_linear(gen, d_in: int, d_out: int, *, bias: bool = False,
                put=keep) -> dict:
    """{"w": (d_in, d_out) normal * d_in^-0.5[, "b": 0]}. `put(w)`
    receives the weight as soon as it is drawn and returns what the dict
    keeps (the streamed serving build nests it there)."""
    p = {"w": put(randn(gen, (d_in, d_out)).mul_(d_in ** -0.5))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32,
                             device=device_of(gen))
    return p


def init_rms_norm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def init_swiglu(gen, d_model: int, d_ff: int, put=keep) -> dict:
    return {"gate": init_linear(gen, d_model, d_ff, put=put),
            "up": init_linear(gen, d_model, d_ff, put=put),
            "down": init_linear(gen, d_ff, d_model, put=put)}


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through all apply functions."""
    mode: str = "fp16"                   # "fp16" | "fp8"
    dtype: torch.dtype = torch.float32   # activation dtype
    act_quant: str = "per_tensor"        # fp8 scale granularity
    fast_accum: bool = False             # bf16-rounded GEMM outputs


def apply_linear(rt: Runtime, p, x: torch.Tensor) -> torch.Tensor:
    """Dispatch a linear layer: plain (LM head) or NestedFP (serving)."""
    if isinstance(p, NestedLinearParams):
        mode = "fp8" if rt.mode == "fp8" else "fp16"
        return nested_linear(p, x, mode=mode, out_dtype=rt.dtype,
                             fast_accum=rt.fast_accum,
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


def attn_core_train(q, k, v, *, q_offset=0, window=None, kv_len=None,
                    cross: bool = False, causal: bool = True):
    """Materialized-scores attention. q: (B,Sq,H,Dq), k/v: (B,Sk,Hkv,·).
    Causal within `window` unless `cross` or not `causal`; keys at or
    past `kv_len` (an int or a tensor broadcast against the scores) are
    masked."""
    b, sq, h, dq = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = (q.reshape(b, sq, hkv, h // hkv, dq) * (dq ** -0.5)).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    kpos = torch.arange(sk, device=q.device)
    if not cross and causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = _apply_window(kpos[None, :] <= qpos, qpos, kpos[None, :],
                             window)
        s = torch.where(mask, s, NEG_INF)
    if kv_len is not None:    # restrict to the valid cache prefix
        s = torch.where(kpos < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1])


def attn_core_prefill(q, k, v, *, q_offset=0, window=None, block_k=1024):
    """Streaming softmax over key blocks of `block_k` (forward only), as
    the JAX package's reference prefill. q: (B,S,H,Dq); k/v: (B,Sk,Hkv,·)."""
    b, sq, h, dq = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    qg = (q.reshape(b, sq, hkv, h // hkv, dq) * (dq ** -0.5)).float() \
        .permute(0, 2, 3, 1, 4)                            # (B,Hkv,G,S,Dq)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    state = ref.softmax_state(qg, dv)
    for k0 in range(0, sk, block_k):
        kb, vb = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        keep = _apply_window(kpos <= qpos, qpos, kpos, window)
        state = ref.tile_update(state, qg, kb, vb, keep)
    return ref.softmax_out(state).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)


def attn_core_decode(q, k_cache, v_cache, kv_len, *, window=None):
    """One query token against a fixed-capacity cache. q: (B,1,H,D);
    k/v_cache: (B,Cap,Hkv,·); kv_len: (B,) valid keys per row (the new
    token's k/v already written at kv_len-1)."""
    b, _, h, dq = q.shape
    cap, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    lens = kv_len.to(torch.int64)[:, None, None, None, None]
    qg = (q.reshape(b, 1, hkv, g, dq) * (dq ** -0.5)).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
    kpos = torch.arange(cap, device=q.device)[None, None, None, None, :]
    mask = _apply_window(kpos < lens, lens - 1, kpos, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return o.reshape(b, 1, h, v_cache.shape[-1])


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
    inactive columns point at the trash block) plus the block table, all
    of this layer's window group. window: None (global) or the layer's
    sliding window. A local group's table points slide-freed blocks at
    the trash block; they lie wholly before the window of every query of
    the step, so K4 never reads them (it reads only the kept keys) and
    the gathered path masks them out."""
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


def attention_prefill(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                      positions, window=None):
    """Causal GQA attention over the whole prompt. Returns (out, {"k","v"})
    with this layer's keys and values (B, S, Hkv, D) in rt.dtype, for the
    caller's cache. Global layers run K6; a windowed layer runs the plain
    `attn_core_prefill`."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = _qkv(rt, p, cfg, x, positions)
    if window is None:
        o = ops.flash_prefill_attention(q, k, v)
    else:
        o = attn_core_prefill(q, k, v, window=window)
    o = o.reshape(b, s, -1).to(rt.dtype)
    return apply_linear(rt, p["wo"], o), {"k": k, "v": v}


def attention_encode(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                     positions):
    """An encoder layer's bidirectional self-attention over the whole
    input (the JAX package's "train" phase with causal=False)."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = _qkv(rt, p, cfg, x, positions)
    o = attn_core_train(q, k, v, causal=False).reshape(b, s, -1).to(rt.dtype)
    return apply_linear(rt, p["wo"], o)


def cross_attention(rt: Runtime, p: dict, cfg, x: torch.Tensor,
                    memory: torch.Tensor | None, *, cache: dict | None = None):
    """A decoder layer's attention over the encoder's memory (B, Senc, D).
    When `cache` {"k","v"} (B, Senc, Hkv, D) is given, the memory's
    projections are taken from it and `memory` is not read. Returns (out,
    {"k","v"}) in rt.dtype, the cache the call used or made."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = apply_linear(rt, p["wq"], x).reshape(b, s, h, hd)
    if cache is None:
        cache = {"k": apply_linear(rt, p["wk"], memory).reshape(b, -1, hkv, hd),
                 "v": apply_linear(rt, p["wv"], memory).reshape(b, -1, hkv, hd)}
    o = attn_core_train(q, cache["k"], cache["v"], cross=True)
    o = o.reshape(b, s, -1).to(rt.dtype)
    return apply_linear(rt, p["wo"], o), cache


def attention_decode(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                     positions, cache: dict, kv_len, window=None):
    """One token per row against this layer's dense per-slot cache.

    cache: {"k","v"} f16 or the byte-planar {"k_hi","k_lo","v_hi","v_lo"}
    u8, each (B, Cap, Hkv, D). The new token's k/v are written IN PLACE at
    position kv_len-1 of each row; then planar caches run K5 (fp8 mode
    reads the hi planes only) and f16 caches the plain `attn_core_decode`."""
    b = x.shape[0]
    q, k, v = _qkv(rt, p, cfg, x, positions)
    rows = torch.arange(b, device=x.device)
    at = kv_len.to(torch.int64) - 1
    if "k_hi" in cache:
        for (hi, lo), val in ((("k_hi", "k_lo"), k), (("v_hi", "v_lo"), v)):
            vh, vl = split_bytes(val[:, 0])
            cache[hi][rows, at] = vh
            cache[lo][rows, at] = vl
        o = ops.planar_decode_attention(q[:, 0], cache, kv_len,
                                        fp8=rt.mode == "fp8",
                                        window=window)[:, None]
    else:
        cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
        o = attn_core_decode(q, cache["k"], cache["v"], kv_len, window=window)
    o = o.reshape(b, 1, -1).to(rt.dtype)
    return apply_linear(rt, p["wo"], o)
