"""Every family of the JAX package: init, caches, the training loss and
the three serving entry points.

- `train_loss`: next-token cross-entropy with a z-loss, the MoE layers'
  aux losses and deepseek-v3's multi-token-prediction loss, for every
  family (`launch/steps.py::make_train_step` differentiates it). Each
  layer (a hybrid's group: attn_every Mamba2 layers and one shared
  block) is recomputed in backward (`torch.utils.checkpoint`, the
  reference's `jax.checkpoint`); no cache is written.
- `paged_step`: the serving engine's step over the block-paged pool
  (every family but encdec, as in the JAX package).
- `prefill` and `decode_step`: the dense-slot steps (`launch/steps.py`)
  over per-slot caches laid out (L, B, Cap, Hkv, D) as in the JAX package
  (every family).

A layer's attention is GQA (`layers.py`) or, when the config has `mla`,
Multi-head Latent Attention (`mla.py`, whose caches hold f16 latents);
its MLP is a dense SwiGLU or, when the config has `moe`, the routed
expert banks of `moe.py` (granite-moe-3b, deepseek-v3).

Recurrent stacks (`ssm`, `hybrid` families): every layer is a Mamba2
block (`mamba2.py`) whose state lives in slot-resident planes ("ssm":
conv_x, conv_bc, ssm, shaped (L, n_slots, ...)), one entry a sequence
slot, read and written in place. A hybrid stack (zamba2) applies one
SHARED decoder block (attention + SwiGLU, `params["shared_attn"]`) after
every `attn_every`-th layer; its K/V ("shared", one layer an
application, f16 as in the JAX package) sit in the block pool or, for
the dense-slot steps, in per-slot caches (planar after
`planarize_cache`). A recurrent chunk cannot be padded (the state would
absorb the pads), so the engine runs prompt chunks at their exact
length, one sequence a chunk, routed to its state row by `slot`.

Sliding-window stacks (gemma3): every `swa_pattern`-th layer is global,
the rest attend within `sliding_window` tokens (`window_schedule`). The
paged cache then has two window groups, each with its own block table
(`cache_descriptor`, serving/kvcache.py), and each layer reads and
writes the pool through its own group's table.

Stub frontends (the JAX package's): a vlm (phi-3-vision) maps
precomputed patch embeddings through `frontend_proj` and prepends them
to the text in `prefill`; the paged engine serves it as a text-only GQA
decoder, as the JAX engine does. An encdec (seamless) maps frame
embeddings through `frontend_proj`, runs a bidirectional encoder stack
(`encode_memory`), and its decoder blocks add cross-attention over that
memory; `prefill` returns the cross caches ("cross": each layer's memory
projections, in the activation dtype, unpadded) that `decode_step`
reuses. The engine refuses encdec where the JAX package does
(`cache_descriptor`, `paged_step`).

The JAX package scans stacked (L, ...) layer params; the port keeps one
dict per layer in `params["layers"]` (and `params["enc_layers"]`) and
runs the stack as a Python loop.
Random init uses a seeded `torch.Generator` on the requested device, so
full-size weights can be made on the card directly (they differ from the
JAX package's values; the tests carry the JAX weights across instead,
`convert.from_jax_serving`). Every entry point that allocates takes
`device=None`, meaning the card (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.nestedfp import split_bytes
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.convert import (_nest_tensor, to_serving,
                                        wrap_nested_linears)
from repro_torch.models.layers import Runtime, init_linear, init_rms_norm
from repro_torch.serving import kvcache as KV


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, put=L.keep) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {"wq": init_linear(gen, d, h * hd, bias=cfg.qkv_bias, put=put),
         "wk": init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias, put=put),
         "wv": init_linear(gen, d, hkv * hd, bias=cfg.qkv_bias, put=put),
         "wo": init_linear(gen, h * hd, d, put=put)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, L.device_of(gen))
        p["k_norm"] = init_rms_norm(hd, L.device_of(gen))
    return p


def init_decoder_block(gen, cfg: ArchConfig, put=L.keep, *,
                       cross: bool = False) -> dict:
    """One layer: MLA or GQA attention, then an MoE or a dense SwiGLU
    MLP, as the config says; with `cross` (an encdec decoder layer) also
    `ln_cross` and a cross-attention block of the attention's shapes,
    drawn last. `put` takes every weight that serving nests as soon as it
    is drawn (`init_linear`)."""
    dev = L.device_of(gen)
    p = {"ln1": init_rms_norm(cfg.d_model, dev),
         "ln2": init_rms_norm(cfg.d_model, dev),
         "attn": MLA.init_mla(gen, cfg, put) if cfg.mla is not None
         else init_attention(gen, cfg, put)}
    if cfg.moe is not None:
        p["moe"] = MOE.init_moe(gen, cfg, put)
    else:
        p["mlp"] = {"gate": init_linear(gen, cfg.d_model, cfg.d_ff, put=put),
                    "up": init_linear(gen, cfg.d_model, cfg.d_ff, put=put),
                    "down": init_linear(gen, cfg.d_ff, cfg.d_model, put=put)}
    if cross:
        p["ln_cross"] = init_rms_norm(cfg.d_model, dev)
        p["cross"] = init_attention(gen, cfg, put)
    return p


def init_ssm_block(gen, cfg: ArchConfig, put=L.keep) -> dict:
    """One recurrent layer: a pre-norm and a Mamba2 block."""
    return {"ln1": init_rms_norm(cfg.d_model, L.device_of(gen)),
            "mamba": M2.init_mamba2(gen, cfg, put)}


def _layer_init(cfg: ArchConfig):
    """The init function of one layer of the stack: a Mamba2 layer for a
    recurrent family, else a decoder block (with cross-attention for an
    encdec's decoder)."""
    if cfg.family in ("ssm", "hybrid"):
        return functools.partial(init_ssm_block, cfg=cfg)
    return functools.partial(init_decoder_block, cfg=cfg,
                             cross=cfg.family == "encdec")


def _init_mtp(gen, cfg: ArchConfig, put=L.keep) -> dict:
    """deepseek-v3's multi-token-prediction head (one block with a dense
    MLP of 2 d_model), drawn after the layers. Carried, never run while
    serving."""
    d = cfg.d_model
    return {"proj": init_linear(gen, 2 * d, d, put=put),
            "norm": init_rms_norm(d, L.device_of(gen)),
            "block": init_decoder_block(gen, dataclasses.replace(
                cfg, moe=None, d_ff=2 * d), put)}


def _generator(seed: int, device):
    """A seeded generator on `device` (None = the card); on the meta
    device the device itself, so that init draws shapes only."""
    dev = resolve_device(device)
    return dev if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)


def _init_top(gen, cfg: ArchConfig) -> dict:
    """Embedding, final norm and (untied) LM head, drawn first."""
    params: dict[str, Any] = {
        "embed": {"tok": L.randn(gen, (cfg.vocab_size, cfg.d_model)) * 0.02},
        "final_norm": init_rms_norm(cfg.d_model, L.device_of(gen)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size)
    return params


def _init_tail(gen, cfg: ArchConfig, params: dict) -> None:
    """An encdec's `enc_norm` and a stub frontend's `frontend_proj`
    (d_frontend, d_model; never nested, as `lm_head`), drawn after the
    layers."""
    if cfg.family == "encdec":
        params["enc_norm"] = init_rms_norm(cfg.d_model, L.device_of(gen))
    if cfg.frontend != "none":
        params["frontend_proj"] = init_linear(gen, cfg.frontend_dim,
                                              cfg.d_model)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Training-form params, from a seeded generator: the top, an
    encdec's encoder layers, the layers, then a hybrid's `shared_attn`
    block, the tail (`_init_tail`) and deepseek-v3's `mtp`.
    device="meta" gives the tree's shapes and dtypes without data."""
    gen = _generator(seed, device)
    params = _init_top(gen, cfg)
    if cfg.family == "encdec":
        params["enc_layers"] = [init_decoder_block(gen, cfg)
                                for _ in range(cfg.n_enc_layers)]
    block = _layer_init(cfg)
    params["layers"] = [block(gen) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = init_decoder_block(gen, cfg)
    _init_tail(gen, cfg, params)
    if cfg.mtp_heads:
        params["mtp"] = _init_mtp(gen, cfg)
    return params


def _nest(w: torch.Tensor):
    """A drawn weight nested as `to_serving` nests it (meta: planes of
    its shape only)."""
    return _nest_tensor(w, structural=w.is_meta)


def _weight_paths(init) -> list[str]:
    """The tree paths ("attn/wo/w", "moe/w_down") of the weights that
    `init(gen, put=)` hands to `put`, in the order it draws them, read
    off a build on the meta device (which draws nothing)."""
    drawn: list[torch.Tensor] = []
    tree = init(torch.device("meta"), put=lambda w: drawn.append(w) or w)
    at: dict[int, str] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, torch.Tensor):
            at[id(node)] = path
    walk(tree, "")
    return [at[id(w)] for w in drawn]


def init_serving_params(cfg: ArchConfig, seed: int = 0, device=None,
                        plant=None) -> dict:
    """Serving params streamed: bitwise `to_serving(init_params(cfg, seed,
    device))`, drawn from the same generator in the same order, but each
    weight is nested (`convert.to_serving`, K8 on the card) as soon as it
    is drawn, so the device holds one f32 weight at a time beside the
    served tree (a deepseek-v3 layer is 46 GB in f32, one of its expert
    banks 15 GB). `plant(i, path, w)` sees each weight of layer i that
    serving nests, by its path in the layer ("attn/wo/w", "moe/w_down",
    "mamba/out_proj/w"), and may edit it in place before it is nested
    (tests plant an exception tensor with it); the weights of a hybrid's
    shared block come with i = "shared_attn", those of an encdec's
    encoder layer j with i = ("enc_layers", j)."""
    gen = _generator(seed, device)
    params = to_serving(_init_top(gen, cfg))

    def streamed(init, i, paths):
        at = iter(paths)

        def put(w):
            if plant is not None:
                plant(i, next(at), w)
            return _nest(w)
        return wrap_nested_linears(init(gen, put=put))
    plain_block = functools.partial(init_decoder_block, cfg=cfg)
    if cfg.family == "encdec":
        paths = _weight_paths(plain_block)
        params["enc_layers"] = [streamed(plain_block, ("enc_layers", j), paths)
                                for j in range(cfg.n_enc_layers)]
    block = _layer_init(cfg)
    paths = _weight_paths(block)
    params["layers"] = [streamed(block, i, paths)
                        for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = streamed(plain_block, "shared_attn",
                                         _weight_paths(plain_block))
    _init_tail(gen, cfg, params)
    if cfg.mtp_heads:
        params["mtp"] = wrap_nested_linears(_init_mtp(gen, cfg, _nest))
    return params


def window_schedule(cfg: ArchConfig) -> tuple[int, ...] | None:
    """Per-layer window: every swa_pattern-th layer is global (-1), the
    rest local (sliding_window); None for a stack without windows."""
    if cfg.sliding_window is None:
        return None
    p = cfg.swa_pattern
    return tuple(-1 if i % p == p - 1 else int(cfg.sliding_window)
                 for i in range(cfg.n_layers))


def _layer_windows(cfg: ArchConfig) -> list[int | None]:
    """Each layer's window for the attention functions (None = global)."""
    ws = window_schedule(cfg)
    if ws is None:
        return [None] * cfg.n_layers
    return [w if w > 0 else None for w in ws]


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def cache_descriptor(cfg: ArchConfig, planar: bool = False) -> KV.CacheDescriptor:
    """The cache layout of a decoder. GQA: K/V planes per layer, f16 or
    byte-planar (NestedKV), and for a sliding-window stack its two window
    groups: global = the layers with i % swa_pattern == swa_pattern - 1,
    local = the rest. MLA: the latent `c_kv` (r,) and `k_rope` (d_rope,)
    planes, f16, never planar (as in the JAX package, planar raises).
    ssm: slot-resident state only (conv_x, conv_bc f16, ssm f32), no
    paged plane and no prefix cache. hybrid: that state plus the shared
    attention's f16 K/V planes, one layer a application (attn_every must
    divide n_layers). encdec: NotImplementedError, as in the JAX package
    (the dense-slot steps serve it)."""
    if cfg.cache_kind == "encdec":
        raise NotImplementedError(
            "engine serves decoder-only archs; enc-dec serving is "
            "covered by the dense-slot steps")
    if cfg.cache_kind == "mla":
        if planar:
            raise ValueError("byte-planar NestedKV applies to GQA K/V "
                             "planes only, not MLA latents")
        m = cfg.mla
        return KV.CacheDescriptor("mla", planes=(
            KV.PlaneSpec("c_kv", cfg.n_layers, (m.kv_lora_rank,), "float16"),
            KV.PlaneSpec("k_rope", cfg.n_layers, (m.qk_rope_dim,),
                         "float16")))
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.cache_kind in ("ssm", "hybrid"):
        return _recurrent_descriptor(cfg, planar)
    groups: tuple[KV.LayerGroup, ...] = ()
    if cfg.sliding_window and cfg.swa_pattern:
        p = cfg.swa_pattern
        glob = tuple(i for i in range(cfg.n_layers) if i % p == p - 1)
        loc = tuple(i for i in range(cfg.n_layers) if i % p != p - 1)
        groups = (KV.LayerGroup("global", None, glob),
                  KV.LayerGroup("local", int(cfg.sliding_window), loc))
    if planar:
        return KV.CacheDescriptor("gqa", planes=tuple(
            KV.PlaneSpec(n, cfg.n_layers, (hkv, hd), "uint8")
            for n in ("k_hi", "k_lo", "v_hi", "v_lo")), groups=groups)
    return KV.CacheDescriptor("gqa", planes=(
        KV.PlaneSpec("k", cfg.n_layers, (hkv, hd), "float16"),
        KV.PlaneSpec("v", cfg.n_layers, (hkv, hd), "float16")), groups=groups)


def _recurrent_descriptor(cfg: ArchConfig, planar: bool) -> KV.CacheDescriptor:
    """cache_descriptor's ssm and hybrid branches."""
    if planar:
        raise ValueError("byte-planar NestedKV applies to GQA K/V planes "
                         "only, not SSM/hybrid state")
    d_inner, n_heads, _ = M2.ssm_dims(cfg)
    s = cfg.ssm
    gn2 = 2 * s.n_groups * s.d_state
    slot_planes = (
        KV.SlotPlaneSpec("conv_x", (cfg.n_layers, s.conv_width - 1, d_inner),
                         "float16"),
        KV.SlotPlaneSpec("conv_bc", (cfg.n_layers, s.conv_width - 1, gn2),
                         "float16"),
        KV.SlotPlaneSpec("ssm", (cfg.n_layers, n_heads, s.head_dim,
                                 s.d_state), "float32"))
    if cfg.cache_kind == "ssm":
        return KV.CacheDescriptor("ssm", slot_planes=slot_planes,
                                  prefix_cacheable=False)
    if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
        # one shared-attention application a group of attn_every layers
        raise ValueError(
            f"hybrid paged serving requires attn_every | n_layers, got "
            f"{cfg.n_layers} % {cfg.attn_every}")
    n_apps = cfg.n_layers // cfg.attn_every
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return KV.CacheDescriptor(
        "hybrid",
        planes=(KV.PlaneSpec("k", n_apps, (hkv, hd), "float16"),
                KV.PlaneSpec("v", n_apps, (hkv, hd), "float16")),
        slot_planes=slot_planes, prefix_cacheable=False)


TORCH_DTYPES = {"uint8": torch.uint8, "float16": torch.float16,
                 "float32": torch.float32}


def _state_planes(desc: KV.CacheDescriptor, n: int, device) -> dict:
    """Zero slot-resident state planes of `n` slots, (L, n, ...) each."""
    return {p.name: torch.zeros((p.shape[0], n) + tuple(p.shape[1:]),
                                dtype=TORCH_DTYPES[p.dtype], device=device)
            for p in desc.slot_planes}


def paged_key(desc: KV.CacheDescriptor) -> str:
    """The caches' subtree that holds a descriptor's paged planes: "shared"
    (a hybrid's shared attention) or "attn"."""
    return "shared" if desc.kind == "hybrid" else "attn"


def init_paged_cache(cfg: ArchConfig, n_total_blocks: int, block_size: int,
                     planar: bool = False, device=None,
                     n_slots: int | None = None, mesh=None):
    """The serving caches a descriptor lays out. Paged planes are
    {plane: (L, NB, BS, *token_shape)}, with no batch dim: sequences own
    block ids (serving/kvcache.py BlockManager; block 0 is the trash
    block); under "attn", or "shared" for a hybrid's shared attention.
    GQA planes are (Hkv, D) a token (planar=True: the byte planes of
    NestedKV), MLA planes (r,) and (d_rope,). Slot-resident state (ssm
    and hybrid) is {"ssm": {plane: (L, n_slots, ...)}}, zero, and needs
    `n_slots`.

    mesh: one such dict a shard, on the shard's device, each plane cut as
    `sharding.paged_cache_spec` says (GQA planes, a hybrid's "shared"
    ones too, by kv heads when they divide, else whole: every shard then
    holds its own copy; MLA latents whole; the SSM state by heads and
    conv_x by channels when they divide, conv_bc whole). `device` is not
    read then."""
    desc = cache_descriptor(cfg, planar=planar)
    if desc.slot_planes and n_slots is None:
        raise ValueError(f"{desc.kind} descriptor has slot-resident "
                         "state; init_paged_cache needs n_slots")

    def planes(device, cut) -> dict:
        out = {}
        if desc.planes:
            key = paged_key(desc)
            out[key] = {p.name: torch.zeros(
                cut((key, p.name), (p.n_layers, n_total_blocks, block_size)
                    + p.token_shape), dtype=TORCH_DTYPES[p.dtype],
                device=device) for p in desc.planes}
        if desc.slot_planes:
            out["ssm"] = {p.name: torch.zeros(
                cut(("ssm", p.name), (p.shape[0], n_slots)
                    + tuple(p.shape[1:])), dtype=TORCH_DTYPES[p.dtype],
                device=device) for p in desc.slot_planes}
        return out
    if mesh is None:
        return planes(resolve_device(device), lambda path, shape: shape)
    from repro_torch.launch import sharding as SH

    def cut(path, shape):
        return SH.local_shape(shape, SH.paged_cache_spec(path, shape, cfg,
                                                         mesh), mesh)
    return [planes(dev, cut) for dev in mesh.devices]


# ---------------------------------------------------------------------------
# dense per-slot cache
# ---------------------------------------------------------------------------

def encdec_enc_len(dec_len: int) -> int:
    """Encoder (audio-frame) length policy for seamless: seq // 8, at
    least 64 (the JAX package's)."""
    return max(64, dec_len // 8)


def init_cache(cfg: ArchConfig, batch: int, capacity: int,
               planar: bool = False, device=None) -> dict:
    """{"attn": {plane: (L, B, Cap, ...)}} zeros. GQA (a vlm too):
    {"k","v"} f16 of (Hkv, D) a token, or with planar=True the byte planes
    of NestedKV (fp8 decode reads the hi planes only). MLA: {"c_kv",
    "k_rope"} f16 latents ((r,) and (d_rope,) a token; planar does not
    apply). ssm: {"ssm": {conv_x, conv_bc f16, ssm f32}} of (L, B, ...),
    whatever the capacity; hybrid: that and the shared attention's f16
    {"k","v"} of (L // attn_every, B, Cap, Hkv, D) under "shared".
    encdec: f16 {"k","v"} under "attn" (planar does not apply, as in the
    JAX package) and the f16 cross caches {"k","v"} of (L, B,
    encdec_enc_len(Cap), Hkv, D) under "cross"."""
    device = resolve_device(device)
    if cfg.cache_kind == "encdec":
        shape = (cfg.n_layers, batch, encdec_enc_len(capacity),
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        return {**init_cache(dataclasses.replace(cfg, family="dense"), batch,
                             capacity, device=device),
                "cross": {n: torch.zeros(shape, dtype=torch.float16,
                                         device=device) for n in ("k", "v")}}
    if cfg.cache_kind in ("ssm", "hybrid"):
        desc = cache_descriptor(cfg)
        out = {"ssm": _state_planes(desc, batch, device)}
        if desc.planes:
            out["shared"] = {
                p.name: torch.zeros((p.n_layers, batch, capacity)
                                    + p.token_shape, dtype=torch.float16,
                                    device=device)
                for p in desc.planes}
        return out
    lead = (cfg.n_layers, batch, capacity)
    if cfg.cache_kind == "mla":
        m = cfg.mla
        return {"attn": {
            "c_kv": torch.zeros(lead + (m.kv_lora_rank,),
                                dtype=torch.float16, device=device),
            "k_rope": torch.zeros(lead + (m.qk_rope_dim,),
                                  dtype=torch.float16, device=device)}}
    shape = lead + (cfg.n_kv_heads, cfg.resolved_head_dim)
    names, dtype = ((("k_hi", "k_lo", "v_hi", "v_lo"), torch.uint8) if planar
                    else (("k", "v"), torch.float16))
    return {"attn": {n: torch.zeros(shape, dtype=dtype, device=device)
                     for n in names}}


def planarize_cache(caches: dict) -> dict:
    """Prefilled f16 self-attention caches ({"k","v"} under "attn", or a
    hybrid's "shared") in byte-planar form (NestedKV): a new dict whose
    subtree holds k_hi, k_lo, v_hi, v_lo u8. Split one layer at a time, so
    the integer temporaries stay one layer's size; other entries (the
    state of a recurrent stack, an encdec's cross caches) and planar
    caches pass through."""
    out = dict(caches)
    for key in ("attn", "shared"):
        sub = caches.get(key, {})
        if set(sub) != {"k", "v"}:
            continue
        planes = {}
        for kind in ("k", "v"):
            src = sub[kind]
            hi = torch.empty(src.shape, dtype=torch.uint8, device=src.device)
            lo = torch.empty_like(hi)
            for i in range(src.shape[0]):
                hi[i], lo[i] = split_bytes(src[i])
            planes[f"{kind}_hi"], planes[f"{kind}_lo"] = hi, lo
        out[key] = planes
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_decoder_block(rt: Runtime, p: dict, cfg: ArchConfig, x, attend,
                        aux: list | None = None, cross=None):
    """x + attend(norm(x)), then for a layer with cross-attention (an
    encdec decoder layer) x + cross(norm(x)), then the MLP: the layer's
    MoE block if it has one, else its SwiGLU. `attend` runs this layer's
    attention phase on the normed input, `cross` its cross-attention.
    aux: a list to which an MoE layer appends its aux dict
    (`moe.moe_block`); None skips computing it."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attend(h)
    if "cross" in p:
        x = x + cross(L.rms_norm(x, p["ln_cross"], cfg.norm_eps))
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" not in p:
        return x + L.swiglu(rt, p["mlp"], h)
    if aux is None:
        return x + MOE.moe_block(rt, p["moe"], cfg, h)
    y, a = MOE.moe_block(rt, p["moe"], cfg, h, with_aux=True)
    aux.append(a)
    return x + y


def _attention(cfg, phase: str):
    """This config's attention function for a phase: MLA's, or GQA's."""
    if cfg.mla is not None:
        return functools.partial(MLA.mla_attention, phase=phase)
    return {"paged": L.attention_paged, "prefill": L.attention_prefill,
            "decode": L.attention_decode, "train": L.attention_train}[phase]


def _remat(fn, x):
    """fn(x), its activations recomputed in backward when a backward will
    run (the reference's `jax.checkpoint` around a scanned layer)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


_AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction")


def _add_aux(acc: dict, got: list) -> dict:
    """acc plus the _AUX_KEYS of each aux dict in `got`, in order."""
    for a in got:
        acc = {k: acc[k] + a[k] for k in _AUX_KEYS}
    return acc


def _prefill_into(cache: dict, kv: dict) -> None:
    """Copy a prompt's per-layer k/v (B, S, ...) into the first min(S,
    Cap) positions of this layer's cache planes (B, Cap, ...)."""
    for name, plane in cache.items():
        n = min(kv[name].shape[1], plane.shape[1])
        plane[:, :n] = kv[name][:, :n]


def run_decoder_stack(rt, layers, cfg, x, *, phase, positions, caches=None,
                      kv_len=None, paged=None, paged_groups=None, aux=None,
                      memory=None, cross_caches=None, causal: bool = True):
    """The decoder stack as a loop over layers, for the "paged", "prefill",
    "decode" and "train" phases; layer i reads and writes slice i of
    every cache plane in place, within its window (`window_schedule`).
    Prefill copies each layer's k/v (MLA: c_kv/k_rope) into its f16 cache
    (the first min(S, Cap) positions; the rest stay zero). "train" writes
    no cache: a decoder's training pass (cross-attention over `memory`,
    projected afresh), or with `causal=False` an encoder stack's
    bidirectional pass (training's and serving's); each layer is
    recomputed in backward (`_remat`), and an MoE layer's aux dict goes
    to `aux` (one append a layer) as the checkpointed block returns it.

    paged: (phys_write (G,B,C), phys_read (G,B,Cap), q_offset (B,),
    tables (G,B,MB)), one index set per window group; paged_groups:
    (L,) layer -> group map. Layer i attends through group
    paged_groups[i]'s indices and table. aux: as `apply_decoder_block`'s
    (the MoE layers' aux dicts in layer order).

    Layers with cross-attention (an encdec's decoder) attend over
    `memory` (B, Senc, D), writing each layer's projections into slice i
    of `cross_caches` {"k","v"} (L, B, Senc, Hkv, D) (prefill), or over
    slice i of `cross_caches` when there is no memory (decode)."""
    windows = _layer_windows(cfg)
    attn = _attention(cfg, phase)
    mla = cfg.mla is not None
    if phase == "train":
        for i, p in enumerate(layers):
            x, got = _remat(functools.partial(
                _train_block, rt, p, cfg, positions=positions,
                window=windows[i], memory=memory, causal=causal), x)
            if aux is not None and got is not None:
                aux.append(got)
        return x
    for i, p in enumerate(layers):
        cache = {name: plane[i] for name, plane in (caches or {}).items()}
        wkw = {} if mla else {"window": windows[i]}
        if phase == "paged":
            g = 0 if paged_groups is None else int(paged_groups[i])
            pg = (paged[0][g], paged[1][g], paged[2], paged[3][g])

            def attend(h):
                out = attn(rt, p["attn"], cfg, h, positions=positions,
                           cache=cache, kv_len=kv_len, paged=pg, **wkw)
                return out[0] if mla else out
        elif phase == "prefill":
            def attend(h):
                a, kv = attn(rt, p["attn"], cfg, h, positions=positions,
                             **wkw)
                _prefill_into(cache, kv)
                return a
        elif phase == "decode":
            def attend(h):
                out = attn(rt, p["attn"], cfg, h, positions=positions,
                           cache=cache, kv_len=kv_len, **wkw)
                return out[0] if mla else out
        else:
            raise ValueError(f"unknown phase {phase!r}")

        def cross(h, i=i, p=p):
            xc = {n: pl[i] for n, pl in cross_caches.items()}
            c, kv = L.cross_attention(rt, p["cross"], cfg, h, memory,
                                      cache=None if memory is not None
                                      else xc)
            if memory is not None:
                for n, pl in xc.items():
                    pl.copy_(kv[n])
            return c
        x = apply_decoder_block(rt, p, cfg, x, attend, aux, cross)
    return x


def _train_block(rt, p: dict, cfg: ArchConfig, x, *, positions,
                 window=None, memory=None, causal: bool = True):
    """One decoder layer's training pass: (x, the MoE layer's aux dict or
    None). Attention is GQA's `attention_train` (causal within `window`,
    or bidirectional) or MLA's "train" phase; a layer with
    cross-attention attends over `memory`."""
    mla = cfg.mla is not None
    attn = _attention(cfg, "train")
    kw = {} if mla else {"window": window, "causal": causal}

    def attend(h):
        out = attn(rt, p["attn"], cfg, h, positions=positions, **kw)
        return out[0] if mla else out

    def cross(h):
        return L.cross_attention(rt, p["cross"], cfg, h, memory)[0]
    got = [] if "moe" in p else None
    x = apply_decoder_block(rt, p, cfg, x, attend, got, cross)
    return x, (got[0] if got else None)


def apply_ssm_block(rt, p: dict, cfg: ArchConfig, x, *, phase: str,
                    cache=None, kv_len=None):
    """x + mamba2(norm(x)); returns (x, the layer's new state)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_cache = M2.mamba2_block(rt, p["mamba"], cfg, h, phase=phase,
                                   cache=cache, kv_len=kv_len)
    return x + y, new_cache


def train_ssm_stack(rt, layers, cfg, x, *, positions, shared_params=None):
    """The Mamba2 stack's training pass (no state in or out): a hybrid
    (`shared_params`) applies its shared decoder block after every
    attn_every-th layer. Each group of layers up to and including a
    shared application (a pure ssm stack: each layer) is recomputed in
    backward, as the reference checkpoints its grouped scan's body."""
    every = cfg.attn_every if shared_params is not None else 0

    def group(x, ps, shared):
        for p in ps:
            x, _ = apply_ssm_block(rt, p, cfg, x, phase="train")
        if shared:
            x = apply_decoder_block(
                rt, shared_params, cfg, x,
                lambda h: L.attention_train(rt, shared_params["attn"], cfg,
                                            h, positions=positions))
        return x
    start = 0
    for i in range(len(layers)):
        shared = bool(every) and i % every == every - 1
        if shared or not every or i == len(layers) - 1:
            x = _remat(functools.partial(group, ps=layers[start:i + 1],
                                         shared=shared), x)
            start = i + 1
    return x


def run_ssm_stack(rt, layers, cfg, x, *, phase, positions, caches,
                  kv_len=None, slot=None, shared_params=None, paged=None):
    """The Mamba2 stack as a loop over layers, for the "paged", "prefill"
    and "decode" phases. Layer i reads its state from slice i of
    caches["ssm"]'s planes (L, B or n_slots, ...) and writes the new state
    back IN PLACE (the reference returned new arrays): a "prefill" writes
    the fresh state, a "paged" step keeps rows with kv_len == 0 as they
    were (`mamba2_block`). `slot` (a (1,) tensor) routes a one-row paged
    chunk to that state row, read and written without a host read.

    A hybrid stack (`shared_params`) applies the shared decoder block
    after every attn_every-th layer; application j reads and writes layer
    j of caches["shared"]: in the paged phase a pool it attends over
    through `paged` (phys_write (B,C), phys_read (B,Cap), q_offset (B,),
    tables (B,MB)), as `layers.attention_paged` takes them; in the
    prefill phase per-slot f16 caches (B, Cap, Hkv, D) it fills, as
    `run_decoder_stack` fills "attn"; in the decode phase those caches,
    f16 or planar, through `layers.attention_decode` (K5 when planar)."""
    every = cfg.attn_every if shared_params is not None else 0
    state = caches["ssm"]
    for i, p in enumerate(layers):
        planes = {n: pl[i] for n, pl in state.items()}
        if phase == "prefill":
            cache = None
        elif slot is not None:
            cache = {n: pl.index_select(0, slot) for n, pl in planes.items()}
        else:
            cache = planes
        x, new = apply_ssm_block(rt, p, cfg, x, phase=phase, cache=cache,
                                 kv_len=kv_len)
        for n, pl in planes.items():
            if slot is not None:
                pl.index_copy_(0, slot, new[n].to(pl.dtype))
            else:
                pl.copy_(new[n])
        if every and i % every == every - 1:
            app = {n: pl[i // every] for n, pl in caches["shared"].items()}
            sp = shared_params["attn"]

            def attend(h, app=app):
                if phase == "paged":
                    return L.attention_paged(rt, sp, cfg, h,
                                             positions=positions, cache=app,
                                             kv_len=kv_len, paged=paged)
                if phase == "prefill":
                    a, kv = L.attention_prefill(rt, sp, cfg, h,
                                                positions=positions)
                    _prefill_into(app, kv)
                    return a
                return L.attention_decode(rt, sp, cfg, h, positions=positions,
                                          cache=app, kv_len=kv_len)
            x = apply_decoder_block(rt, shared_params, cfg, x, attend)
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
               rows=None, slot=None, return_logits: bool = False,
               sample_all: bool = False, aux: list | None = None):
    """One step over the paged cache — batched decode (C=1 across all
    rows) and chunked prefill (ragged right-padded chunk rows) alike —
    for every family but encdec (ValueError, as in the JAX package): GQA
    K/V planes (a vlm's text tokens too), MLA latent planes, and
    recurrent stacks whose slot-resident state ("ssm") pairs, for a
    hybrid, with the shared attention's paged planes ("shared").

    tokens:       (B, C) int32, right-padded chunks (attention families;
                  a recurrent chunk is exact-length: the state would
                  absorb pads).
    block_tables: (G, B, MB) int32 physical block ids in logical order,
                  one table per window group (holes and slide-freed
                  blocks = trash block 0), or (B, MB), then the same
                  table for every group. Rows may alias blocks (COW
                  prefix sharing); the caller forks before any write.
    q_offset:     (B,) absolute position of tokens[:, 0].
    kv_len:       (B,) valid cache tokens AFTER this chunk is written
                  (0 disables a row: its writes go to the trash block).
    logit_position: (B,) column of the last real token per row (default:
                  the last column).
    rows:         (B,) slot of each row: block_tables is then the whole
                  (G, n_slots, MB) (or (n_slots, MB)) table array and row
                  b reads its row rows[b] of every group, gathered here,
                  inside the step (as the JAX engine gathers inside its
                  jit).
    slot:         (1,) int tensor, for a single-row chunk of a recurrent
                  stack: the state row the chunk reads and writes (B must
                  be 1). None: the state's slot axis matches B (the
                  batched decode).
    sample_all:   the greedy argmax at EVERY chunk column, (B, C) int32
                  (or (B, C, V) logits with return_logits), in place of
                  the `logit_position` selection: speculative
                  verification, where column j's argmax is the greedy
                  continuation after the chunk up to j.
    aux:          a list that receives each MoE layer's aux dict (losses,
                  drop fraction, routing); None (the serving engine's
                  choice) skips them, as the JAX package's step drops
                  them.

    The pool planes and the slot-resident state in `caches` are updated
    in place. Returns next_ids
    (B,) int32 (greedy argmax, on the device) or, with return_logits,
    the (B, V) f32 logits."""
    if cfg.family == "encdec":
        raise ValueError("paged_step serves decoder-only archs")
    ix = paged_indices(cfg, tokens, block_tables, q_offset=q_offset,
                       kv_len=kv_len, block_size=block_size, rows=rows)
    desc = ix.desc
    if slot is not None:
        slot = slot.to(torch.int64)
    h = embed_tokens(rt, params, cfg, tokens)
    if desc.slot_planes:
        h = run_ssm_stack(rt, params["layers"], cfg, h, phase="paged",
                          positions=ix.positions, caches=caches,
                          kv_len=ix.kv_len, slot=slot,
                          shared_params=params.get("shared_attn"),
                          paged=(ix.phys_write[0], ix.phys_read[0],
                                 ix.q_offset, ix.tables[0]))
    else:
        h = run_decoder_stack(rt, params["layers"], cfg, h, phase="paged",
                              positions=ix.positions, caches=caches["attn"],
                              kv_len=ix.kv_len,
                              paged=(ix.phys_write, ix.phys_read,
                                     ix.q_offset, ix.tables),
                              paged_groups=desc.layer_group_map(cfg.n_layers),
                              aux=aux)
    if not sample_all:
        h = logit_rows(h, logit_position)
    logits = lm_logits(rt, params, cfg, h)
    if not sample_all:
        logits = logits[:, 0]
    if return_logits:
        return logits
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class PagedIndices:
    """A paged step's positions and pool indices (`paged_indices`)."""
    desc: KV.CacheDescriptor
    positions: torch.Tensor    # (B, C) int64
    phys_write: torch.Tensor   # (G, B, C) flat pool rows of the writes
    phys_read: torch.Tensor    # (G, B, MB * BS) flat pool rows in order
    q_offset: torch.Tensor     # (B,) int64
    kv_len: torch.Tensor       # (B,) int32
    tables: torch.Tensor       # (G, B, MB) int32


def paged_indices(cfg, tokens, block_tables, *, q_offset, kv_len,
                  block_size: int, rows=None) -> PagedIndices:
    """The positions and flat pool indices of a `paged_step`, one set a
    window group, from its block tables (see `paged_step` for the
    arguments)."""
    b, c = tokens.shape
    dev = tokens.device
    desc = cache_descriptor(cfg)
    ngrp = len(desc.group_windows)
    tables = block_tables
    if tables.dim() == 2:
        tables = tables[None]
    if rows is not None:
        tables = tables[:, rows.long()]
    tables = tables.to(torch.int32)
    if tables.shape[0] != ngrp:            # one table for every group
        tables = tables.expand(ngrp, -1, -1)
    q_offset = q_offset.to(torch.int64)
    kv_len = kv_len.to(torch.int32)
    mb = tables.shape[2]
    positions = q_offset[:, None] + torch.arange(c, device=dev)[None, :]
    real = positions < kv_len[:, None]
    blkidx = torch.clamp(positions // block_size, 0, mb - 1)
    blk = torch.gather(tables.long(), 2,
                       blkidx.expand(ngrp, -1, -1))              # (G, B, C)
    trash = (torch.arange(c, device=dev) % block_size)[None, None, :]
    phys_write = torch.where(
        real[None], blk * block_size + (positions % block_size)[None], trash)
    offs = torch.arange(block_size, device=dev)
    phys_read = (tables.long()[..., None] * block_size
                 + offs).reshape(ngrp, b, mb * block_size)
    return PagedIndices(desc, positions, phys_write, phys_read, q_offset,
                        kv_len, tables)


def logit_rows(h: torch.Tensor, logit_position=None) -> torch.Tensor:
    """(B, 1, D): each row's hidden state at its `logit_position` (default
    the last column)."""
    if logit_position is None:
        return h[:, -1:]
    lp = logit_position.to(torch.int64)
    return torch.gather(h, 1, lp[:, None, None].expand(-1, 1, h.shape[-1]))


# ---------------------------------------------------------------------------
# a serving mesh's model-level pieces (serving/shard.py drives them): one
# list entry a shard, as in `layers.attention_paged_mesh`
# ---------------------------------------------------------------------------

def embed_tokens_mesh(rt, mesh, lay, params: list, cfg, tokens: list) -> list:
    """`embed_tokens` on a mesh. A vocab-split embedding (lay.vocab):
    shard s gathers the rows of the ids in its slice of the vocab and
    zeros for the rest, and the mesh sums the shards (each id's row comes
    from one shard, so the sum is that row). Gathering before the cast to
    rt.dtype gives the cast-then-gather's bits."""
    if not lay.vocab:
        return [embed_tokens(rt, p, cfg, t) for p, t in zip(params, tokens)]
    parts = []
    for s, (p, t) in enumerate(zip(params, tokens)):
        w = p["embed"]["tok"]
        n = w.shape[0]
        local = t.long() - s * n
        hit = (local >= 0) & (local < n)
        rows = w[local.clamp(0, n - 1)].to(rt.dtype)
        parts.append(torch.where(hit[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device)))
    return mesh.all_reduce(parts)


def sharded_argmax(mesh, parts: list) -> torch.Tensor:
    """torch.argmax over the last dim of the logits that `parts` hold in
    vocab slices, one a shard in vocab order: each shard's first maximum
    and its value, then, in shard order, a later shard wins only with a
    strictly larger value, so the first index of the whole row's maximum
    wins as torch.argmax's does. On the first shard's device, int32."""
    root = mesh.devices[0]
    best_v = best_i = None
    off = 0
    for part in parts:
        i = torch.argmax(part, dim=-1, keepdim=True)
        v = torch.gather(part, -1, i).to(root)
        i = (i + off).to(root)
        off += part.shape[-1]
        if best_v is None:
            best_v, best_i = v, i
            continue
        take = v > best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return best_i[..., 0].to(torch.int32)


def _block_mesh(rt, mesh, lay, ps: list, cfg, hs: list, attend) -> list:
    """`apply_decoder_block` on a mesh (no cross-attention, no aux): x +
    attend(norm(x)), then the MoE block (`moe.moe_block_mesh`) or the
    SwiGLU (`layers.swiglu_mesh`), one entry a shard."""
    eps = cfg.norm_eps
    hn = [L.rms_norm(h, p["ln1"], eps) for h, p in zip(hs, ps)]
    hs = [h + y for h, y in zip(hs, attend(hn))]
    hn = [L.rms_norm(h, p["ln2"], eps) for h, p in zip(hs, ps)]
    if "moe" in ps[0]:
        f = MOE.moe_block_mesh(rt, mesh, lay, [p["moe"] for p in ps], cfg, hn)
    else:
        f = L.swiglu_mesh(rt, mesh, lay.mlp, [p["mlp"] for p in ps], hn)
    return [h + y for h, y in zip(hs, f)]


def _pool_mesh(caches: list, key: str, i: int, idx: list, g: int) -> dict:
    """The paged-attention keywords of layer i (window group g) on a mesh:
    each shard's layer-i pool planes under caches[s][key], and its pool
    indices."""
    return dict(positions=[ix.positions for ix in idx],
                caches=[{n: pl[i] for n, pl in c[key].items()}
                        for c in caches],
                kv_len=[ix.kv_len for ix in idx],
                paged=[(ix.phys_write[g], ix.phys_read[g], ix.q_offset,
                        ix.tables[g]) for ix in idx])


def run_decoder_stack_mesh(rt, mesh, lay, params: list, cfg, hs: list, *,
                           caches: list, idx: list) -> list:
    """`run_decoder_stack`'s paged phase on a mesh: layer i of every shard
    in turn, each shard's attention (GQA, or MLA's latents) over its own
    pool (its slice i of `caches[s]["attn"]`) through its window group's
    indices (`idx[s]`, a `PagedIndices`), then its SwiGLU or MoE block,
    the residual stream whole on every shard."""
    windows = _layer_windows(cfg)
    groups = idx[0].desc.layer_group_map(cfg.n_layers)
    for i in range(cfg.n_layers):
        ps = [p["layers"][i] for p in params]
        kw = _pool_mesh(caches, "attn", i, idx, int(groups[i]))
        if cfg.mla is not None:
            def attend(hn, ps=ps, kw=kw):
                return MLA.mla_attention_mesh(
                    rt, mesh, lay, [p["attn"] for p in ps], cfg, hn, **kw)
        else:
            def attend(hn, ps=ps, kw=kw, w=windows[i]):
                return L.attention_paged_mesh(
                    rt, mesh, lay, [p["attn"] for p in ps], cfg, hn,
                    window=w, **kw)
        hs = _block_mesh(rt, mesh, lay, ps, cfg, hs, attend)
    return hs


def run_ssm_stack_mesh(rt, mesh, lay, params: list, cfg, hs: list, *,
                       caches: list, idx: list, slot: list | None = None
                       ) -> list:
    """`run_ssm_stack`'s paged phase on a mesh: layer i's Mamba2 block
    on every shard (`mamba2.mamba2_block_mesh`), each shard's state in
    its slice i of `caches[s]["ssm"]`, written back in place (through
    `slot[s]`, a (1,) int64 tensor, for a one-row chunk, as unsharded).
    A hybrid applies its shared block after every attn_every-th layer:
    the GQA attention on the mesh (`layers.attention_paged_mesh`) over
    each shard's layer of its "shared" pools, through its window-less
    indices, then the shared SwiGLU."""
    shared = [p.get("shared_attn") for p in params]
    every = cfg.attn_every if shared[0] is not None else 0
    for i in range(cfg.n_layers):
        ps = [p["layers"][i] for p in params]
        planes = [{n: pl[i] for n, pl in c["ssm"].items()} for c in caches]
        if slot is None:
            state = planes
        else:
            state = [{n: pl.index_select(0, sl) for n, pl in pp.items()}
                     for pp, sl in zip(planes, slot)]
        hn = [L.rms_norm(h, p["ln1"], cfg.norm_eps) for h, p in zip(hs, ps)]
        ys, news = M2.mamba2_block_mesh(
            rt, mesh, lay, [p["mamba"] for p in ps], cfg, hn, phase="paged",
            caches=state, kv_len=[ix.kv_len for ix in idx])
        hs = [h + y for h, y in zip(hs, ys)]
        for s, (pp, new) in enumerate(zip(planes, news)):
            for n, pl in pp.items():
                if slot is not None:
                    pl.index_copy_(0, slot[s], new[n].to(pl.dtype))
                else:
                    pl.copy_(new[n])
        if every and i % every == every - 1:
            kw = _pool_mesh(caches, "shared", i // every, idx, 0)

            def attend(hn, kw=kw):
                return L.attention_paged_mesh(
                    rt, mesh, lay, [p["attn"] for p in shared], cfg, hn,
                    **kw)
            hs = _block_mesh(rt, mesh, lay, shared, cfg, hs, attend)
    return hs


def _frontend_tokens(rt, params, cfg, batch):
    """Stub-frontend embeddings (vlm patches (B, P, F) / audio frames (B,
    Senc, F)) mapped to d_model by `frontend_proj`, in rt.dtype."""
    emb = batch["patch_embeds"] if cfg.frontend == "vision" else batch["frames"]
    return L.apply_linear(rt, params["frontend_proj"], emb.to(rt.dtype))


def encode_memory(rt, params, cfg, frames):
    """encdec: the bidirectional encoder over stub frame embeddings
    (B, Senc, frontend_dim) -> memory (B, Senc, D) in rt.dtype (the
    stack's "train" phase with causal=False, as in the JAX package,
    serving and training alike)."""
    h = _frontend_tokens(rt, params, cfg, {"frames": frames})
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    h = run_decoder_stack(rt, params["enc_layers"], cfg, h, phase="train",
                          positions=pos, causal=False)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def backbone(rt, params, cfg, h, *, positions, memory=None):
    """The training pass of the family's stack over h (B, S, D) -> (h,
    aux): the _AUX_KEYS summed over the MoE layers in layer order (zeros
    for a stack without MoE)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    acc = {k: zero for k in _AUX_KEYS}
    if cfg.family in ("ssm", "hybrid"):
        return train_ssm_stack(rt, params["layers"], cfg, h,
                               positions=positions,
                               shared_params=params.get("shared_attn")), acc
    got: list = []
    h = run_decoder_stack(rt, params["layers"], cfg, h, phase="train",
                          positions=positions, aux=got, memory=memory)
    return h, _add_aux(acc, got)


def _ce(logits, labels):
    """(mean cross-entropy, logz): logits (B, S, V) f32, labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean(), logz


def train_loss(rt, params, cfg, batch):
    """batch: {"tokens": (B, S+1)} and a vlm's "patch_embeds" (B, P,
    frontend_dim) or an encdec's "frames" (B, Senc, frontend_dim), torch
    tensors. Returns (loss, metrics): the next-token cross-entropy of
    the text, a 1e-4 z-loss on its log-partition, the MoE aux losses and,
    for deepseek-v3, 0.1 of the multi-token-prediction loss; metrics hold
    loss, ce, acc and the _AUX_KEYS."""
    tokens = batch["tokens"].long()
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    h = embed_tokens(rt, params, cfg, inp)
    memory, n_prefix = None, 0
    if cfg.family == "encdec":
        memory = encode_memory(rt, params, cfg, batch["frames"])
    elif cfg.frontend == "vision":
        front = _frontend_tokens(rt, params, cfg, batch)
        n_prefix = front.shape[1]
        h = torch.cat([front, h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, aux = backbone(rt, params, cfg, h, positions=positions, memory=memory)
    h = h[:, n_prefix:]
    logits = lm_logits(rt, params, cfg, h)               # (B, S, V) f32
    ce, logz = _ce(logits, labels)
    zloss = 1e-4 * (logz ** 2).mean()
    loss = ce + zloss + aux["moe_lb_loss"] + aux["moe_z_loss"]
    if cfg.mtp_heads and "mtp" in params:
        loss = loss + 0.1 * _mtp_loss(rt, params, cfg, h, tokens)
    metrics = {"loss": loss, "ce": ce,
               "acc": (logits.argmax(-1) == labels).float().mean(), **aux}
    return loss, metrics


def _mtp_loss(rt, params, cfg, h, tokens):
    """deepseek-v3's single-depth multi-token prediction: predict t+2
    from [norm(h_t); emb(t+1)] through one extra block with a dense MLP
    of 2 d_model (arXiv:2412.19437 §2.2)."""
    p = params["mtp"]
    emb_next = embed_tokens(rt, params, cfg, tokens[:, 1:-1])
    h_in = torch.cat([L.rms_norm(h[:, :-1], p["norm"], cfg.norm_eps),
                      emb_next], dim=-1)
    h2 = L.apply_linear(rt, p["proj"], h_in)
    pos = torch.arange(h2.shape[1], device=h2.device)[None, :]
    mtp_cfg = dataclasses.replace(cfg, moe=None, d_ff=2 * cfg.d_model)
    h2, _ = _train_block(rt, p["block"], mtp_cfg, h2, positions=pos)
    return _ce(lm_logits(rt, params, cfg, h2), tokens[:, 2:])[0]


def prefill(rt, params, cfg, batch, *, capacity: int | None = None,
            logit_position: int | None = None, aux: list | None = None):
    """Run the whole prompt; returns (logits (B, V) f32, caches, length).

    batch: {"tokens": (B, S)}, with a vlm's "patch_embeds" (B, P,
    frontend_dim), prepended to the text (length P + S), or an encdec's
    "frames" (B, Senc, frontend_dim), which the encoder reads. The caches
    are fresh f16 `init_cache` planes ({"k","v"} of (L, B, capacity, Hkv,
    D), or MLA's latents) with capacity defaulting to the length, on the
    tokens' device, holding the prompt's keys and values, zero past it;
    for a recurrent stack the state after the prompt, and for a hybrid
    its shared attention's f16 caches under "shared"; for an encdec also
    "cross", each decoder layer's memory projections {"k","v"} (L, B,
    Senc, Hkv, D) in rt.dtype, unpadded, as the JAX package leaves them.
    Logits are taken at `logit_position` of the text (default: the last
    position). aux: as `paged_step`'s."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    h = embed_tokens(rt, params, cfg, tokens)
    memory, n_prefix = None, 0
    if cfg.family == "encdec":
        memory = encode_memory(rt, params, cfg, batch["frames"])
    elif cfg.frontend == "vision":
        front = _frontend_tokens(rt, params, cfg, batch)
        n_prefix = front.shape[1]
        h = torch.cat([front, h], dim=1)
    total = h.shape[1]
    capacity = capacity or total
    positions = torch.arange(total, device=dev)[None, :]
    if cfg.cache_kind in ("ssm", "hybrid"):
        caches = init_cache(cfg, b, capacity, device=dev)
        h = run_ssm_stack(rt, params["layers"], cfg, h, phase="prefill",
                          positions=positions, caches=caches,
                          shared_params=params.get("shared_attn"))
    else:
        caches = init_cache(dataclasses.replace(cfg, family="dense"), b,
                            capacity, device=dev)
        if memory is not None:
            shape = (cfg.n_layers, b, memory.shape[1], cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            caches["cross"] = {n: torch.empty(shape, dtype=rt.dtype,
                                              device=dev) for n in ("k", "v")}
        h = run_decoder_stack(rt, params["layers"], cfg, h, phase="prefill",
                              positions=positions, caches=caches["attn"],
                              aux=aux, memory=memory,
                              cross_caches=caches.get("cross"))
    pos = total - 1 if logit_position is None \
        else n_prefix + int(logit_position)
    logits = lm_logits(rt, params, cfg, h[:, pos:pos + 1])[:, 0]
    return logits, caches, total


def check_cache_len(cap: int | None, cache_len) -> None:
    """decode_step's host check: an int cache_len must leave the new token
    a free position in caches of capacity `cap` (None: a recurrent state,
    which has no capacity; a tensor is not read)."""
    if isinstance(cache_len, int) and not (
            0 <= cache_len and (cap is None or cache_len < cap)):
        raise ValueError(f"cache_len {cache_len}: the new token needs a free "
                         f"position in a cache of capacity {cap}")


def cache_capacity(caches) -> int | None:
    """Positions a row of the dense per-slot self-attention caches holds:
    "attn"'s (not an encdec's cross length), or a hybrid's "shared"; None
    for the state of an ssm stack, which is O(1) in the sequence's
    length."""
    for key in ("attn", "shared"):
        if key in caches:
            return next(iter(caches[key].values())).shape[2]
    return None


def decode_step(rt, params, cfg, tokens, caches, cache_len,
                aux: list | None = None):
    """One decoding step. tokens: (B, 1); cache_len: int or (B,) — tokens
    already in each row's cache (a vlm's patches included), below its
    capacity (checked for an int). The new keys and values are written IN
    PLACE into `caches` (f16 or planar) at position cache_len. Returns
    (logits (B, V) f32, caches).

    The host part (the check, and the upload of an int cache_len) is done
    here; `decode_logits` is the device part, which
    `launch/steps.py::make_decode_step` captures with cache_len staged in
    a device buffer of its own. aux: as `paged_step`'s. A recurrent stack
    advances its state in place; an encdec reads its cross caches."""
    b = tokens.shape[0]
    check_cache_len(cache_capacity(caches), cache_len)
    lens = torch.as_tensor(cache_len, device=tokens.device).to(torch.int32)
    lens = lens.expand(b) if lens.dim() == 0 else lens
    return decode_logits(rt, params, cfg, tokens, caches, lens, aux), caches


def decode_logits(rt, params, cfg, tokens, caches, lens,
                  aux: list | None = None) -> torch.Tensor:
    """decode_step's device part: tokens (B, 1), lens (B,) int32 on the
    tokens' device (cache lengths, not read on the host) -> logits (B, V)
    f32, the caches written in place. No host read and no host value
    depends on lens, so a CUDA graph of it serves any lengths."""
    h = embed_tokens(rt, params, cfg, tokens)
    if cfg.cache_kind in ("ssm", "hybrid"):
        h = run_ssm_stack(rt, params["layers"], cfg, h, phase="decode",
                          positions=lens[:, None], caches=caches,
                          kv_len=lens + 1,
                          shared_params=params.get("shared_attn"))
    else:
        h = run_decoder_stack(rt, params["layers"], cfg, h, phase="decode",
                              positions=lens[:, None], caches=caches["attn"],
                              kv_len=lens + 1, aux=aux,
                              cross_caches=caches.get("cross"))
    return lm_logits(rt, params, cfg, h[:, -1:])[:, 0]
