"""Dense GQA decoder: init, caches, and its three serving entry points.

- `paged_step`: the serving engine's step over the block-paged pool.
- `prefill` and `decode_step`: the dense-slot steps (`launch/steps.py`)
  over per-slot caches laid out (L, B, Cap, Hkv, D) as in the JAX package.

The JAX package scans stacked (L, ...) layer params; the port keeps one
dict per layer in `params["layers"]` and runs the stack as a Python loop.
Random init uses a seeded `torch.Generator` on the requested device, so
full-size weights can be made on the card directly (they differ from the
JAX package's values; the tests carry the JAX weights across instead,
`convert.from_jax_serving`). Every entry point that allocates takes
`device=None`, meaning the card (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.nestedfp import split_bytes
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KV


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False) -> dict:
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=gen.device,
                          dtype=torch.float32) * d_in ** -0.5}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def init_rms_norm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {"wq": init_linear(gen, d, h * hd, bias=cfg.qkv_bias),
         "wk": init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias),
         "wv": init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias),
         "wo": init_linear(gen, h * hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, gen.device)
        p["k_norm"] = init_rms_norm(hd, gen.device)
    return p


def init_decoder_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, gen.device),
            "ln2": init_rms_norm(cfg.d_model, gen.device),
            "attn": init_attention(gen, cfg),
            "mlp": {"gate": init_linear(gen, cfg.d_model, cfg.d_ff),
                    "up": init_linear(gen, cfg.d_model, cfg.d_ff),
                    "down": init_linear(gen, cfg.d_ff, cfg.d_model)}}


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Training-form params of a dense decoder, from a seeded generator."""
    _check_dense(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": {"tok": torch.randn((cfg.vocab_size, d), generator=gen,
                                     device=gen.device) * 0.02},
        "final_norm": init_rms_norm(d, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, cfg.vocab_size)
    params["layers"] = [init_decoder_block(gen, cfg)
                        for _ in range(cfg.n_layers)]
    return params


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the port serves dense decoders; "
                                  f"{cfg.arch_id} is {cfg.family}")
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window layer groups are not "
                                  "ported yet")


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def cache_descriptor(cfg: ArchConfig, planar: bool = False) -> KV.CacheDescriptor:
    """GQA descriptor: K/V planes per layer, f16 or byte-planar (NestedKV)."""
    _check_dense(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if planar:
        return KV.CacheDescriptor("gqa", planes=tuple(
            KV.PlaneSpec(n, cfg.n_layers, (hkv, hd), "uint8")
            for n in ("k_hi", "k_lo", "v_hi", "v_lo")))
    return KV.CacheDescriptor("gqa", planes=(
        KV.PlaneSpec("k", cfg.n_layers, (hkv, hd), "float16"),
        KV.PlaneSpec("v", cfg.n_layers, (hkv, hd), "float16")))


_TORCH_DTYPES = {"uint8": torch.uint8, "float16": torch.float16}


def init_paged_cache(cfg: ArchConfig, n_total_blocks: int, block_size: int,
                     planar: bool = False, device=None) -> dict:
    """{"attn": {plane: (L, NB, BS, Hkv, D)}} — no batch dim: sequences own
    block ids (serving/kvcache.py BlockManager; block 0 is the trash
    block). planar=True stores the GQA byte planes (NestedKV)."""
    desc = cache_descriptor(cfg, planar=planar)
    device = resolve_device(device)
    return {"attn": {
        p.name: torch.zeros((p.n_layers, n_total_blocks, block_size)
                            + p.token_shape, dtype=_TORCH_DTYPES[p.dtype],
                            device=device)
        for p in desc.planes}}


# ---------------------------------------------------------------------------
# dense per-slot cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, capacity: int,
               planar: bool = False, device=None) -> dict:
    """{"attn": {plane: (L, B, Cap, Hkv, D)}} zeros: {"k","v"} f16, or with
    planar=True the byte planes of NestedKV (fp8 decode reads the hi
    planes only). GQA decoders only."""
    _check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    names, dtype = ((("k_hi", "k_lo", "v_hi", "v_lo"), torch.uint8) if planar
                    else (("k", "v"), torch.float16))
    return {"attn": {n: torch.zeros(shape, dtype=dtype, device=device)
                     for n in names}}


def planarize_cache(caches: dict) -> dict:
    """Prefilled f16 caches ({"attn": {"k","v"}}) in byte-planar form
    (NestedKV): a new dict whose "attn" holds k_hi, k_lo, v_hi, v_lo u8.
    Split one layer at a time, so the integer temporaries stay one layer's
    size; other entries and planar caches pass through."""
    out = dict(caches)
    sub = caches["attn"]
    if set(sub) == {"k", "v"}:
        planes = {}
        for kind in ("k", "v"):
            src = sub[kind]
            hi = torch.empty(src.shape, dtype=torch.uint8, device=src.device)
            lo = torch.empty_like(hi)
            for i in range(src.shape[0]):
                hi[i], lo[i] = split_bytes(src[i])
            planes[f"{kind}_hi"], planes[f"{kind}_lo"] = hi, lo
        out["attn"] = planes
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_decoder_block(rt: Runtime, p: dict, cfg: ArchConfig, x, attend):
    """x + attend(norm(x)), then the SwiGLU MLP; `attend` runs this layer's
    attention phase on the normed input."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attend(h)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(rt, p["mlp"], h)


def run_decoder_stack(rt, layers, cfg, x, *, phase, positions, caches,
                      kv_len=None, paged=None):
    """The decoder stack as a loop over layers, for the "paged", "prefill"
    and "decode" phases; layer i reads and writes slice i of every cache
    plane in place. Prefill copies each layer's k/v into its f16 cache
    (the first min(S, Cap) positions; the rest stay zero)."""
    for i, p in enumerate(layers):
        cache = {name: plane[i] for name, plane in caches.items()}
        if phase == "paged":
            def attend(h):
                return L.attention_paged(rt, p["attn"], cfg, h,
                                         positions=positions, cache=cache,
                                         kv_len=kv_len, paged=paged)
        elif phase == "prefill":
            def attend(h):
                a, kv = L.attention_prefill(rt, p["attn"], cfg, h,
                                            positions=positions)
                for name in ("k", "v"):
                    n = min(kv[name].shape[1], cache[name].shape[1])
                    cache[name][:, :n] = kv[name][:, :n]
                return a
        elif phase == "decode":
            def attend(h):
                return L.attention_decode(rt, p["attn"], cfg, h,
                                          positions=positions, cache=cache,
                                          kv_len=kv_len)
        else:
            raise ValueError(f"unknown phase {phase!r}")
        x = apply_decoder_block(rt, p, cfg, x, attend)
    return x


def embed_tokens(rt, params, cfg, tokens):
    return params["embed"]["tok"].to(rt.dtype)[tokens.long()]


def lm_logits(rt, params, cfg, h):
    """Final norm + LM head as a plain f32 matmul (tied: the embedding)."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(rt.dtype)
        return h.float() @ w.float().T
    return L.apply_linear(dataclasses.replace(rt, dtype=torch.float32),
                          params["lm_head"], h)


def paged_step(rt, params, cfg, tokens, caches, block_tables, *,
               q_offset, kv_len, block_size: int, logit_position=None,
               rows=None, return_logits: bool = False):
    """One step over the paged cache — batched decode (C=1 across all
    rows) and chunked prefill (ragged right-padded chunk rows) alike.

    tokens:       (B, C) int32, right-padded chunks.
    block_tables: (B, MB) int32 physical block ids in logical order
                  (holes = trash block 0). Rows may alias blocks (COW
                  prefix sharing); the caller forks before any write.
    q_offset:     (B,) absolute position of tokens[:, 0].
    kv_len:       (B,) valid cache tokens AFTER this chunk is written
                  (0 disables a row: its writes go to the trash block).
    logit_position: (B,) column of the last real token per row (default:
                  the last column).
    rows:         (B,) slot of each row: block_tables is then the whole
                  (n_slots, MB) table array and row b reads its row
                  rows[b], gathered here, inside the step (as the JAX
                  engine gathers inside its jit).

    The pool planes in `caches` are updated in place. Returns next_ids
    (B,) int32 (greedy argmax, on the device) or, with return_logits,
    the (B, V) f32 logits."""
    b, c = tokens.shape
    dev = tokens.device
    if rows is not None:
        block_tables = block_tables[rows.long()]
    tables = block_tables.to(torch.int32)
    q_offset = q_offset.to(torch.int64)
    kv_len = kv_len.to(torch.int32)
    mb = tables.shape[1]
    positions = q_offset[:, None] + torch.arange(c, device=dev)[None, :]
    real = positions < kv_len[:, None]
    blkidx = torch.clamp(positions // block_size, 0, mb - 1)
    blk = torch.gather(tables.long(), 1, blkidx)                 # (B, C)
    trash = (torch.arange(c, device=dev) % block_size)[None, :]
    phys_write = torch.where(real, blk * block_size + positions % block_size,
                             trash)
    offs = torch.arange(block_size, device=dev)
    phys_read = (tables.long()[..., None] * block_size
                 + offs[None, None, :]).reshape(b, mb * block_size)
    h = embed_tokens(rt, params, cfg, tokens)
    h = run_decoder_stack(rt, params["layers"], cfg, h, phase="paged",
                          positions=positions, caches=caches["attn"],
                          kv_len=kv_len,
                          paged=(phys_write, phys_read, q_offset, tables))
    if logit_position is None:
        hsel = h[:, -1:]
    else:
        lp = logit_position.to(torch.int64)
        hsel = torch.gather(h, 1, lp[:, None, None].expand(-1, 1, h.shape[-1]))
    logits = lm_logits(rt, params, cfg, hsel)[:, 0]
    if return_logits:
        return logits
    return torch.argmax(logits, dim=-1).to(torch.int32)


def prefill(rt, params, cfg, batch, *, capacity: int | None = None,
            logit_position: int | None = None):
    """Run the whole prompt; returns (logits (B, V) f32, caches, length).

    batch: {"tokens": (B, S)}. The caches are fresh f16 {"attn": {"k","v"}}
    of (L, B, capacity, Hkv, D) (capacity defaults to S) on the tokens'
    device, holding the prompt's keys and values, zero past S. Logits are
    taken at `logit_position` (default: the last position)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    capacity = capacity or s
    caches = init_cache(cfg, b, capacity, device=tokens.device)
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = embed_tokens(rt, params, cfg, tokens)
    h = run_decoder_stack(rt, params["layers"], cfg, h, phase="prefill",
                          positions=positions, caches=caches["attn"])
    pos = s - 1 if logit_position is None else int(logit_position)
    logits = lm_logits(rt, params, cfg, h[:, pos:pos + 1])[:, 0]
    return logits, caches, s


def decode_step(rt, params, cfg, tokens, caches, cache_len):
    """One decoding step. tokens: (B, 1); cache_len: int or (B,) — tokens
    already in each row's cache, below its capacity (checked for an int).
    The new keys and values are written IN PLACE into `caches` (f16 or
    planar) at position cache_len. Returns (logits (B, V) f32, caches)."""
    b = tokens.shape[0]
    cap = next(iter(caches["attn"].values())).shape[2]
    if isinstance(cache_len, int) and not 0 <= cache_len < cap:
        raise ValueError(f"cache_len {cache_len}: the new token needs a free "
                         f"position in a cache of capacity {cap}")
    lens = torch.as_tensor(cache_len, device=tokens.device).to(torch.int32)
    lens = lens.expand(b) if lens.dim() == 0 else lens
    h = embed_tokens(rt, params, cfg, tokens)
    h = run_decoder_stack(rt, params["layers"], cfg, h, phase="decode",
                          positions=lens[:, None], caches=caches["attn"],
                          kv_len=lens + 1)
    return lm_logits(rt, params, cfg, h[:, -1:])[:, 0], caches
