"""Multi-head Latent Attention (DeepSeek-V2/V3) [arXiv:2412.19437].

Port of the JAX package's `models/mla.py`, in four phases:

- "paged": the serving engine's chunks and decode steps over the block
  pool, in the ABSORBED form (one arithmetic path for both);
- "prefill": the dense-slot prompt pass, per-head K/V materialized from
  the latent, then the plain `attn_core_prefill` (q/k head dim
  nope + rope, v head dim v_head_dim), as the reference does;
- "decode": the dense-slot decode step, absorbed;
- "train": per-head K/V materialized as in "prefill", then the plain
  `attn_core_train` over materialized scores, with no cache.

The cache holds only the compressed latent c_kv (kv_lora_rank) and the
shared RoPE key (qk_rope_dim) per token, in f16, never byte-planar.
Absorbed attention folds W_uk into the query and W_uv into the output:

    score_h(t) = (q_nope_h W_uk_h^T) . c_kv[t] + q_rope_h . k_rope[t]
    ctx_h      = (sum_t p_t c_kv[t]) W_uv_h

W_uk and W_uv are read whole through `read_f16()` in both modes. Caches
and pools are written in place.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import NestedLinearParams
from repro_torch.models import layers as L
from repro_torch.models.layers import NEG_INF, Runtime, apply_linear


def init_mla(gen, cfg, put=L.keep) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dev = L.device_of(gen)
    qk_head = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": L.init_linear(gen, d, m.q_lora_rank, put=put),
        "q_norm": L.init_rms_norm(m.q_lora_rank, dev),
        "wq_b": L.init_linear(gen, m.q_lora_rank, h * qk_head, put=put),
        "wkv_a": L.init_linear(gen, d, m.kv_lora_rank + m.qk_rope_dim,
                               put=put),
        "kv_norm": L.init_rms_norm(m.kv_lora_rank, dev),
        "wk_b": L.init_linear(gen, m.kv_lora_rank, h * m.qk_nope_dim,
                              put=put),
        "wv_b": L.init_linear(gen, m.kv_lora_rank, h * m.v_head_dim,
                              put=put),
        "wo": L.init_linear(gen, h * m.v_head_dim, d, put=put),
    }


def _project_q(rt, p, cfg, x, positions, latent=None):
    """(q_nope, q_rope) (B, S, heads, .): the heads are wq_b's columns
    (head-major), so a shard's column slice gives its own heads. latent:
    the q latent (wq_a's output) when it was computed elsewhere (a mesh
    gathers it whole from the shards' columns before its norm)."""
    m = cfg.mla
    b, s, _ = x.shape
    if latent is None:
        latent = apply_linear(rt, p["wq_a"], x)
    q = apply_linear(rt, p["wq_b"],
                     L.rms_norm(latent, p["q_norm"], cfg.norm_eps))
    q = q.reshape(b, s, -1, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, L.rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(rt, p, cfg, x, positions):
    """(c_kv (B, S, r), k_rope (B, S, d_rope)) in rt.dtype."""
    m = cfg.mla
    kv = apply_linear(rt, p["wkv_a"], x)
    c_kv = L.rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = L.rope(kv[..., None, m.kv_lora_rank:], positions,
                    cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _weight_f16(p) -> torch.Tensor:
    if isinstance(p, NestedLinearParams):
        return p.weight.read_f16()
    return p["w"]


def _absorbed_weights(p, m):
    """W_uk (r, H, nope) and W_uv (r, H, dv) in f32; H is the heads the
    weights' (head-major) columns hold."""
    wk_b = _weight_f16(p["wk_b"]).float().reshape(m.kv_lora_rank, -1,
                                                  m.qk_nope_dim)
    wv_b = _weight_f16(p["wv_b"]).float().reshape(m.kv_lora_rank, -1,
                                                  m.v_head_dim)
    return wk_b, wv_b


def _absorbed_attend(q_nope, q_rope, c_kv, k_rope, wk_b, wv_b, m, mask):
    """C query tokens over a latent cache of Cap tokens. q_*: (B,C,H,.);
    c_kv (B,Cap,r); k_rope (B,Cap,d_rope); mask (B,C,Cap) bool ->
    (B,C,H,dv) f32."""
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    c = c_kv.float()
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_abs, c)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    scores = torch.where(mask[:, None], (s_lat + s_rope) * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhqk,bkr->bqhr", probs, c)
    return torch.einsum("bqhr,rhd->bqhd", ctx_lat, wv_b)


def _attend_paged(rt, p, cfg, x, q_nope, q_rope, *, positions, cache,
                  kv_len, paged) -> torch.Tensor:
    """The paged phase after the q projection: the chunk's latents
    scattered into the pool planes `cache`, gathered back per row in
    logical order, and the absorbed attention of q's heads over them.
    Returns (B, S, heads * dv) in rt.dtype, before wo."""
    m = cfg.mla
    b, s, _ = x.shape
    phys_write, phys_read, q_offset = paged[:3]
    c_new, kr_new = _project_kv_latent(rt, p, cfg, x, positions)
    wf = phys_write.reshape(-1)
    ckv = cache["c_kv"].view(-1, m.kv_lora_rank)
    kr = cache["k_rope"].view(-1, m.qk_rope_dim)
    ckv[wf] = c_new.reshape(-1, m.kv_lora_rank).to(ckv.dtype)
    kr[wf] = kr_new.reshape(-1, m.qk_rope_dim).to(kr.dtype)
    c_kv, k_rope = ckv[phys_read], kr[phys_read]            # (B, Cap, .)
    cap = c_kv.shape[1]
    qpos = q_offset[:, None] + torch.arange(s, device=x.device)[None, :]
    kpos = torch.arange(cap, device=x.device)
    mask = (kpos[None, None, :] <= qpos[..., None]) \
        & (kpos[None, None, :] < kv_len[:, None, None])
    wk_b, wv_b = _absorbed_weights(p, m)
    o = _absorbed_attend(q_nope, q_rope, c_kv, k_rope, wk_b, wv_b, m, mask)
    return o.reshape(b, s, -1).to(rt.dtype)


def mla_attention(rt: Runtime, p: dict, cfg, x: torch.Tensor, *, phase: str,
                  positions, cache: dict | None = None, kv_len=None,
                  paged=None):
    """One layer's MLA. Returns (out (B, S, D), latents or None).

    phase "paged": cache = this layer's pool planes {"c_kv": (NB,BS,r),
    "k_rope": (NB,BS,d_rope)}, paged = (phys_write (B,C), phys_read
    (B,Cap), q_offset (B,), tables) as for GQA (`layers.attention_paged`):
    the chunk's latents are scattered into the pool, then gathered back
    per row in logical order, so COW-shared blocks are transparent.
    phase "prefill": returns the prompt's latents {"c_kv", "k_rope"}
    (B, S, .) for the caller's cache. phase "decode": cache = this
    layer's dense per-slot {"c_kv": (B,Cap,r), "k_rope": (B,Cap,d_rope)},
    the new token's latents written at kv_len - 1. phase "train":
    returns None for the latents."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(rt, p, cfg, x, positions)
    h = q_nope.shape[2]
    new = None
    if phase == "paged":
        o = _attend_paged(rt, p, cfg, x, q_nope, q_rope, positions=positions,
                          cache=cache, kv_len=kv_len, paged=paged)
        return apply_linear(rt, p["wo"], o), None
    if phase in ("prefill", "train"):
        c_kv, k_rope = _project_kv_latent(rt, p, cfg, x, positions)
        k_nope = apply_linear(rt, p["wk_b"], c_kv).reshape(
            b, s, h, m.qk_nope_dim)
        v = apply_linear(rt, p["wv_b"], c_kv).reshape(b, s, h, m.v_head_dim)
        k_rope_h = k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_h], dim=-1)
        if phase == "train":
            o = L.attn_core_train(q_full, k_full, v)
        else:
            o = L.attn_core_prefill(q_full, k_full, v)
            new = {"c_kv": c_kv, "k_rope": k_rope}
    elif phase == "decode":
        rows = torch.arange(b, device=x.device)
        at = kv_len.to(torch.int64) - 1
        c_new, kr_new = _project_kv_latent(rt, p, cfg, x, positions)
        cache["c_kv"][rows, at] = c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][rows, at] = kr_new[:, 0].to(cache["k_rope"].dtype)
        cap = cache["c_kv"].shape[1]
        mask = (torch.arange(cap, device=x.device)[None, None, :]
                < kv_len[:, None, None])
        wk_b, wv_b = _absorbed_weights(p, m)
        o = _absorbed_attend(q_nope, q_rope, cache["c_kv"], cache["k_rope"],
                             wk_b, wv_b, m, mask)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    o = o.reshape(b, s, h * m.v_head_dim).to(rt.dtype)
    return apply_linear(rt, p["wo"], o), new


def mla_attention_mesh(rt: Runtime, mesh, lay, ps: list, cfg, xs: list, *,
                       positions: list, caches: list, kv_len: list,
                       paged: list) -> list:
    """The paged phase on a mesh, head-parallel (`sharding.serving_layout`
    serves MLA so only): the counterpart of the JAX package's MLA under
    `param_spec`. Returns the output, whole on every shard.

    wq_a split by its q_lora_rank columns (lay.q_a "col"): each shard
    computes its columns of the q latent, gathered whole in shard order
    before the latent's RMSNorm, which needs the whole row. wq_b, wk_b
    and wv_b are split by heads (their columns are head-major), so shard
    s projects its q heads and reads its heads' absorbed weights. wkv_a
    is whole: every shard computes the same latents and writes them into
    its own copy of the pool (the latent planes are whole on every
    shard). wo is row-parallel and reduced (`layers.
    linear_row_parallel`). The absorbed attention of a shard's heads is
    the unsharded one's plain torch ops."""
    lat = [None] * mesh.size
    if lay.q_a == "col":
        lat = mesh.all_gather([apply_linear(rt, p["wq_a"], x)
                               for p, x in zip(ps, xs)], dim=-1)
    outs = []
    for i, (p, x) in enumerate(zip(ps, xs)):
        q_nope, q_rope = _project_q(rt, p, cfg, x, positions[i],
                                    latent=lat[i])
        outs.append(_attend_paged(rt, p, cfg, x, q_nope, q_rope,
                                  positions=positions[i], cache=caches[i],
                                  kv_len=kv_len[i], paged=paged[i]))
    return L.linear_row_parallel(rt, mesh, [p["wo"] for p in ps], outs)
