"""Dense GQA decoder: init, paged cache, and the engine's `paged_step`.

The JAX package scans stacked (L, ...) layer params; the port keeps one
dict per layer in `params["layers"]` and runs the stack as a Python loop.
Random init uses a seeded `torch.Generator` on the requested device, so
full-size weights can be made on the card directly (they differ from the
JAX package's values; the tests carry the JAX weights across instead,
`convert.from_jax_serving`).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
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


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> dict:
    """Training-form params of a dense decoder, from a seeded generator."""
    _check_dense(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
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
                     planar: bool = False, device="cpu") -> dict:
    """{"attn": {plane: (L, NB, BS, Hkv, D)}} — no batch dim: sequences own
    block ids (serving/kvcache.py BlockManager; block 0 is the trash
    block). planar=True stores the GQA byte planes (NestedKV)."""
    desc = cache_descriptor(cfg, planar=planar)
    return {"attn": {
        p.name: torch.zeros((p.n_layers, n_total_blocks, block_size)
                            + p.token_shape, dtype=_TORCH_DTYPES[p.dtype],
                            device=device)
        for p in desc.planes}}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_decoder_block(rt: Runtime, p: dict, cfg: ArchConfig, x, *,
                        positions, cache, kv_len, paged):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_paged(rt, p["attn"], cfg, h, positions=positions,
                              cache=cache, kv_len=kv_len, paged=paged)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(rt, p["mlp"], h)


def run_decoder_stack(rt, layers, cfg, x, *, positions, caches, kv_len,
                      paged):
    """The decoder stack as a loop over layers; layer i reads and writes
    slice i of every pool plane in place."""
    for i, p in enumerate(layers):
        cache = {name: plane[i] for name, plane in caches.items()}
        x = apply_decoder_block(rt, p, cfg, x, positions=positions,
                                cache=cache, kv_len=kv_len, paged=paged)
    return x


def embed_tokens(rt, params, cfg, tokens):
    return params["embed"]["tok"].to(rt.dtype)[tokens.long()]


def lm_logits(rt, params, cfg, h):
    """Final norm + LM head as a plain f32 matmul (tied: the embedding)."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(rt.dtype)
        return h.float() @ w.float().T
    return L.apply_linear(Runtime(mode=rt.mode, dtype=torch.float32,
                                  act_quant=rt.act_quant),
                          params["lm_head"], h)


def paged_step(rt, params, cfg, tokens, caches, block_tables, *,
               q_offset, kv_len, block_size: int, logit_position=None,
               return_logits: bool = False):
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

    The pool planes in `caches` are updated in place. Returns next_ids
    (B,) int32 (greedy argmax, on the device) or, with return_logits,
    the (B, V) f32 logits."""
    b, c = tokens.shape
    dev = tokens.device
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
    h = run_decoder_stack(rt, params["layers"], cfg, h, positions=positions,
                          caches=caches["attn"], kv_len=kv_len,
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
