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

Training runs a fourth, `attention_train`: causal (within a window)
or, for an encoder, bidirectional attention over materialized scores
(`attn_core_train`), as plain torch ops, as the JAX package computes it
outside any Pallas kernel; an encoder-decoder (seamless) adds
`cross_attention`, the decoder's attention over the encoder's memory or
over its cached projections, computed the same way. No cache is written
while training.

Caches and pools are updated IN PLACE (the JAX package returned new ones
from donated buffers). The `attn_core_*` functions are the plain torch
references of the JAX package's attention cores.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import quant
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
    mode: str = "fp16"                   # "train" | "fp16" | "fp8"
    dtype: torch.dtype = torch.float32   # activation dtype
    act_quant: str = "per_tensor"        # fp8 scale granularity
    fast_accum: bool = False             # bf16-rounded GEMM outputs

    @property
    def serving(self) -> bool:
        return self.mode in ("fp16", "fp8")


def apply_linear(rt: Runtime, p, x: torch.Tensor) -> torch.Tensor:
    """Dispatch a linear layer: plain (training form, the LM head) or
    NestedFP (serving). A plain product takes both operands in rt.dtype
    and sums in f32. On the card in bf16 training that is a bf16 cuBLAS
    GEMM with f32 accumulation (under PyTorch's default, split-K partials
    may be reduced in bf16), whose output is rounded to bf16 before the
    bias is added (the reference adds the bias to the f32 sum, then
    rounds: qwen1.5's qkv biases round twice here); everywhere else, the
    serving steps' plain linears (router, frontend_proj) included, the
    operands are upcast and multiplied in f32."""
    if isinstance(p, NestedLinearParams):
        mode = "fp8" if rt.mode == "fp8" else "fp16"
        return nested_linear(p, x, mode=mode, out_dtype=rt.dtype,
                             fast_accum=rt.fast_accum,
                             act_quant=rt.act_quant)
    # (on meta tensors, a reckoning of the card's run: the card's branch)
    if rt.mode == "train" and rt.dtype == torch.bfloat16 \
            and x.device.type in ("cuda", "meta"):
        y = x.to(rt.dtype) @ p["w"].to(rt.dtype)
        if p.get("b") is not None:
            y = (y.float() + p["b"]).to(rt.dtype)
        return y
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


def _qkv(rt, p, cfg, x, positions, project=None):
    """q, k, v (B, S, heads, D) of one layer: the three projections (or
    `project(name)`'s results, a mesh's reduced ones), then the q/k norms
    and RoPE. The head counts come from the projections' widths, so a
    shard's column slices give its own heads."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if project is None:
        def project(name):
            return apply_linear(rt, p[name], x)
    q, k, v = (project(n).reshape(b, s, -1, hd) for n in ("wq", "wk", "wv"))
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
    q, k, v = _qkv(rt, p, cfg, x, positions)
    o = _attend_paged(rt, q, k, v, cache=cache, kv_len=kv_len, paged=paged,
                      window=window)
    return apply_linear(rt, p["wo"], o)


def _attend_paged(rt: Runtime, q, k, v, *, cache: dict, kv_len, paged,
                  window=None) -> torch.Tensor:
    """Write this chunk's k, v into the pool planes `cache` and attend q
    over the pool: (B, C, H * D) in rt.dtype. Single-token decode over a
    byte-planar pool runs K4 on the planes in place; everything else
    gathers the keys in logical order (`attn_core_paged`)."""
    b, c = q.shape[0], q.shape[1]
    phys_write, phys_read, q_offset, tables = paged
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
            return o.reshape(b, c, -1).to(rt.dtype)
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
    return o.reshape(b, c, -1).to(rt.dtype)


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


def attention_train(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                    positions, window=None, causal: bool = True):
    """One layer's GQA attention over the whole input, for training (the
    JAX package's "train" phase): causal within `window` (None: global),
    or bidirectional with `causal=False` (an encoder's), over
    materialized scores. No cache."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = _qkv(rt, p, cfg, x, positions)
    o = attn_core_train(q, k, v, window=window, causal=causal)
    return apply_linear(rt, p["wo"], o.reshape(b, s, -1).to(rt.dtype))


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


# ---------------------------------------------------------------------------
# a serving mesh's layers (serving/shard.py drives them)
# ---------------------------------------------------------------------------
#
# Each function takes one entry a shard: that shard's params (its slices,
# `shard.shard_serving_params`), its input, its pool. An input that every
# shard holds whole (the residual stream, its norms) is a list whose
# entries are the same values; `lay` (`sharding.serving_layout`) says how
# each weight is split, and the data flow follows it.

def _col_slices(xs: list, m: int) -> list:
    """Shard s's slice s of the last dim of each shard's whole input: the
    operand of a row-parallel weight when the input is whole."""
    c = xs[0].shape[-1] // m
    return [x[..., s * c:(s + 1) * c] for s, x in enumerate(xs)]


def linear_row_parallel(rt: Runtime, mesh, ps: list, xs: list) -> list:
    """A row-parallel nested linear: shard s multiplies its slice of the
    contraction, x_s (..., K/m), by its rows of the weight; the mesh sums
    the f32 partials in shard order (`Mesh.all_reduce`), and the bias is
    added once, after. Returns the whole output on every shard.

    FP8 quantizes each activation row under the WHOLE row's scale, as the
    unsharded layer does: per token, each shard's slice absmax (one
    launch), their max across shards, then the slice's codes under the
    scale from it (one launch), bitwise the unsharded codes at the
    slice's columns; per tensor (the dense-slot scheme), the max of the
    slices' absmax into K7. An exception tensor is one in every shard and
    runs K3 in both modes."""
    w0 = ps[0].weight
    mode = "fp8" if rt.mode == "fp8" else "fp16"
    if mode == "fp8" and not w0.is_exception:
        if rt.act_quant == "per_token":
            amax = mesh.all_reduce([ops.act_row_absmax(x) for x in xs],
                                   op="max")
            parts = []
            for p, x, a in zip(ps, xs, amax):
                scale = quant.scale_from_amax(a)
                parts.append(ops.matmul_nested_fp8(
                    ops.quantize_act_scaled(x, scale), p.weight.upper, scale))
        elif rt.act_quant == "per_tensor":
            amax = mesh.all_reduce([quant.absmax(x).reshape(1) for x in xs],
                                   op="max")
            parts = [ops.matmul_nested_fp8_fused_quant(x, p.weight.upper, a)
                     for p, x, a in zip(ps, xs, amax)]
        else:
            raise ValueError(f"unknown act_quant {rt.act_quant!r}")
    else:
        parts = [nested_linear(NestedLinearParams(p.weight, None), x,
                               mode=mode, out_dtype=torch.float32)
                 for p, x in zip(ps, xs)]
    out = []
    for p, y in zip(ps, mesh.all_reduce(parts)):
        if rt.fast_accum:
            y = y.to(torch.bfloat16)
        if p.bias is not None:
            y = y + p.bias
        out.append(y.to(rt.dtype))
    return out


def apply_linear_mesh(rt: Runtime, mesh, kind: str, ps: list,
                      xs: list) -> list:
    """One linear on a mesh, from the whole input on every shard: "col"
    gives each shard its output columns, "row" the reduced whole output
    (`linear_row_parallel` on the input's slices), "whole" each shard the
    whole output from its whole weight."""
    if kind == "row":
        return linear_row_parallel(rt, mesh, ps, _col_slices(xs, mesh.size))
    return [apply_linear(rt, p, x) for p, x in zip(ps, xs)]


def attention_paged_mesh(rt: Runtime, mesh, lay, ps: list, cfg, xs: list, *,
                         positions: list, caches: list, kv_len: list,
                         paged: list, window=None) -> list:
    """`attention_paged` on a mesh: the counterpart of the JAX package's
    GSPMD-partitioned paged attention and of its `shard_map` around the
    Pallas decode kernel. Returns the attention output, whole on every
    shard.

    Head-parallel (lay.q == "col"): shard s projects its q heads (qwen's
    q/k/v bias sliced with its columns) and its kv heads, writes them into
    its own pool, and attends over it: single-token decode over planar
    pools runs K4 on the shard's pool planes and q heads, chunks the
    gathered path; `wo` is then row-parallel and reduced. gemma3's kv
    heads do not divide the axis (one kv head): every shard computes that
    head whole and writes its own copy of the pool, and K4 runs per shard
    over that copy (the JAX package's guard `hkv % msz == 0` sends this
    case to its gathered path; over a whole pool of one kv head, K4 on a
    shard's q heads computes the same function).

    The row-parallel fallback (lay.q == "row": the head count does not
    divide, d_model does): q, k and v are reduced whole on every shard,
    each shard attends over its whole copy of the pool, and `wo` splits
    its output columns, gathered after. lay.q == "whole" runs the layer
    whole on every shard."""
    if lay.q == "col":
        qkv = [_qkv(rt, p, cfg, x, pos)
               for p, x, pos in zip(ps, xs, positions)]
    else:
        red = {n: apply_linear_mesh(rt, mesh, getattr(lay, "q" if n == "wq"
                                                      else "kv"),
                                    [p[n] for p in ps], xs)
               for n in ("wq", "wk", "wv")}
        qkv = [_qkv(rt, p, cfg, x, pos, project=lambda n, s=s: red[n][s])
               for s, (p, x, pos) in enumerate(zip(ps, xs, positions))]
    outs = [_attend_paged(rt, q, k, v, cache=cache, kv_len=kv_len[s],
                          paged=paged[s], window=window)
            for s, ((q, k, v), cache) in enumerate(zip(qkv, caches))]
    wo = [p["wo"] for p in ps]
    if lay.wo == "row":
        return linear_row_parallel(rt, mesh, wo, outs)
    if lay.wo == "col":
        return mesh.all_gather(
            [apply_linear(rt, p, o) for p, o in zip(wo, outs)], dim=-1)
    return [apply_linear(rt, p, o) for p, o in zip(wo, outs)]


def swiglu_mesh(rt: Runtime, mesh, kind: str, ps: list, xs: list) -> list:
    """`swiglu` on a mesh: gate and up by columns, down row-parallel and
    reduced (kind "col", `ServingLayout.mlp` or `.shared`), or whole on
    every shard."""
    if kind == "whole":
        return [swiglu(rt, p, x) for p, x in zip(ps, xs)]
    h = [F.silu(apply_linear(rt, p["gate"], x)) * apply_linear(rt, p["up"], x)
         for p, x in zip(ps, xs)]
    return linear_row_parallel(rt, mesh, [p["down"] for p in ps], h)
