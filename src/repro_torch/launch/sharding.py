"""Which dimension of each weight and pool plane a serving mesh splits.

The port of the JAX package's `launch/sharding.py` resolvers that serving
reads, `param_spec` and `paged_cache_spec`, as pure shape logic: a spec
is a tuple, one entry a dimension, of None (whole on every shard) or
"model" (cut into equal slices, shard s holding slice s). The rules are
the JAX package's, branch for branch, so the tables agree for every
config (tests/test_torch_sharding.py): any dimension that does not
divide the axis stays whole.

A path is the leaf's keys in the port's trees. The port keeps one dict a
layer in `params["layers"]` (a list), where the JAX package stacks the
layers into leading (L, ...) dimensions, so a layer's leaf here has no
L dimension and its spec none either; pool planes are (L, NB, BS, ...)
in both packages.

`opt_state_spec`, `batch_spec` and `cache_spec` (training and the dry
run) wait for the training slice, as do the data axes: a serving mesh
has the "model" axis alone.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import model_axis_size

Spec = tuple


def _div(n: int, m: int) -> bool:
    return n > 0 and m > 0 and n % m == 0


def _keys(path: Sequence) -> list[str]:
    return [k for k in path if isinstance(k, str)]


# which head count governs a projection's sharded output dim
_Q_NAMES = ("wq", "wq_b")
_KV_NAMES = ("wk", "wv", "wk_b", "wv_b")
_OUT_NAMES = ("wo",)


def param_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig,
               mesh) -> Spec:
    """The spec of one parameter leaf of `shape` at `path` (e.g.
    ("layers", 3, "attn", "wq", "w"); a nested weight's byte planes have
    the f16 weight's shape)."""
    m = model_axis_size(mesh)
    keys = _keys(path)
    body = tuple(shape)
    rank = len(body)

    def spec(*dims):
        return tuple(dims)

    # embeddings / head (kept un-nested): vocab-sharded iff divisible
    if "embed" in keys:                      # (V, D)
        return spec("model" if _div(body[0], m) else None, None)
    if "lm_head" in keys:                    # (D, V)
        if rank == 1:
            return spec("model" if _div(body[0], m) else None)
        return spec(None, "model" if _div(body[1], m) else None)
    if "router" in keys or "frontend_proj" in keys:
        return spec(*([None] * rank))

    # MoE expert banks (E_pad, D, F) / (E_pad, F, D): expert-parallel when
    # the (padded) expert count divides, else per-expert tensor parallel
    if any(k in keys for k in ("w_gate", "w_up", "w_down")):
        if _div(body[0], m):
            return spec("model", None, None)
        down = "w_down" in keys
        if _div(body[1 if down else 2], m):
            return spec(None, "model", None) if down \
                else spec(None, None, "model")
        return spec(None, None, None)

    # attention projections: head-parallel (by columns) when the head
    # count divides the axis; otherwise ROW-parallel, the d_model
    # contraction cut, so the weights still spread (partial sums reduced
    # after; the attention itself then runs whole on every shard)
    n_heads = cfg.n_heads
    n_kv = cfg.n_kv_heads
    if any(k in keys for k in _Q_NAMES):
        if rank == 1:
            return spec("model" if _div(n_heads, m) else None)
        if _div(n_heads, m):
            return spec(None, "model")
        return spec("model" if _div(body[0], m) else None, None)
    if any(k in keys for k in _KV_NAMES):
        heads = n_heads if cfg.mla is not None else n_kv
        if rank == 1:
            return spec("model" if _div(heads, m) else None)
        if _div(heads, m):
            return spec(None, "model")
        if _div(n_heads, m):
            # kv heads indivisible but q heads divide (gemma3's 4 q / 1
            # kv): q and wo stay head-parallel and every shard computes
            # the few K/V heads whole, which its attention then reads
            # without a collective
            return spec(None, None)
        return spec("model" if _div(body[0], m) else None, None)
    if any(k in keys for k in _OUT_NAMES):
        if rank == 1:
            return spec(None)
        if _div(n_heads, m):
            return spec("model", None)
        return spec(None, "model" if _div(body[1], m) else None)
    if "wq_a" in keys:                       # (D, q_lora_rank)
        ok = cfg.mla is not None and _div(cfg.mla.q_lora_rank, m)
        if rank == 1:
            return spec("model" if ok else None)
        return spec(None, "model" if ok else None)
    if "wkv_a" in keys:                      # tiny latent projection
        return spec(*([None] * rank))

    # dense MLP: gate and up by columns, down by rows
    if any(k in keys for k in ("gate", "up")):
        ff = body[-1] if rank >= 2 else body[0]
        ok = _div(ff, m)
        if rank == 1:
            return spec("model" if ok else None)
        return spec(None, "model" if ok else None)
    if "down" in keys:
        if rank == 1:
            return spec(None)
        return spec("model" if _div(body[0], m) else None, None)

    # mamba2: z/x column-parallel over heads; bc/dt tiny, replicated
    if any(k in keys for k in ("in_z", "in_x")):
        ok = _div(body[-1], m)
        if rank == 1:
            return spec("model" if ok else None)
        return spec(None, "model" if ok else None)
    if any(k in keys for k in ("in_bc", "in_dt", "conv_wbc", "conv_bbc")):
        return spec(*([None] * rank))
    if "out_proj" in keys:
        if rank == 1:
            return spec(None)
        return spec("model" if _div(body[0], m) else None, None)
    if "conv_wx" in keys:                    # (W, d_inner)
        return spec(None, "model" if _div(body[-1], m) else None)
    if "conv_bx" in keys:
        return spec("model" if _div(body[0], m) else None)

    # everything else (norms, scalars, dt/A/D, mtp proj): whole
    return spec(*([None] * rank))


def paged_cache_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig,
                     mesh) -> Spec:
    """The spec of one plane of the engine's caches
    (`model.init_paged_cache`: no batch dim, sequences own block ids).

    "attn" / "shared" GQA planes (L, NB, BS, Hkv, D), f16 k/v or the four
    NestedKV byte planes, split the kv-head axis when it divides; an
    indivisible count (gemma3's one kv head) keeps the pool whole on
    every shard, as its K/V projections are. MLA latent planes (L, NB,
    BS, r) have no head axis and stay whole (the block axis cannot be
    cut: blocks are written at per-token indices). "ssm" slot state:
    mamba2's (L, slots, H, P, N) splits heads, conv_x (L, slots, W-1,
    d_inner) channels; conv_bc stays whole."""
    m = model_axis_size(mesh)
    keys = _keys(path)
    shape = tuple(shape)
    dims: list = [None] * len(shape)
    if any(k in keys for k in ("attn", "shared")):
        if len(shape) == 5 and _div(shape[3], m):
            dims[3] = "model"
    elif "conv_x" in keys:
        if len(shape) == 4 and _div(shape[3], m):
            dims[3] = "model"
    elif "conv_bc" in keys:
        pass                                   # tiny; replicate channels
    elif "ssm" in keys:
        if len(shape) == 5 and _div(shape[2], m):
            dims[2] = "model"
    return tuple(dims)


def local_shape(shape: Sequence[int], spec: Spec, m: int) -> tuple:
    """A shard's shape of a leaf of `shape` under `spec` on m shards."""
    return tuple(n // m if s == "model" else n for n, s in zip(shape, spec))


def shard_bounds(spec: Spec, shape: Sequence[int], m: int, s: int
                 ) -> tuple[int, int, int] | None:
    """(dim, start, length) of shard s's slice, or None for a leaf kept
    whole."""
    for d, (n, name) in enumerate(zip(shape, spec)):
        if name == "model":
            c = n // m
            return d, s * c, c
    return None


def _kind(spec: Spec) -> str:
    """A 2-D weight's split: "col" (its output columns), "row" (its
    contraction rows) or "whole"."""
    if spec[-1] == "model":
        return "col"
    if spec[0] == "model":
        return "row"
    return "whole"


@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """How a dense decoder's layers run on a mesh, read off `param_spec`
    and `paged_cache_spec`, so that the forward follows the weights:

    q:    "col" (head-parallel: each shard its q heads), "row" (the
          row-parallel fallback: q, k and v reduced, whole on every
          shard) or "whole";
    kv:   wk / wv likewise; "whole" beside a "col" q is gemma3's case,
          every shard computing the few kv heads whole;
    wo:   "row" (head-parallel), "col" (the fallback's output columns,
          gathered after) or "whole";
    mlp:  "col" (gate and up by columns, down by rows) or "whole";
    vocab: the embedding and the LM head split by vocab rows / columns;
    pool: the pool planes split by kv heads (else whole on every shard)."""
    m: int
    q: str
    kv: str
    wo: str
    mlp: str
    vocab: bool
    pool: bool


def serving_layout(cfg: ArchConfig, mesh) -> ServingLayout:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def kind(path, shape):
        return _kind(param_spec(("layers", 0) + path, shape, cfg, mesh))
    vocab = param_spec(("embed", "tok"), (cfg.vocab_size, d), cfg,
                       mesh)[0] == "model"
    pool = paged_cache_spec(("attn", "k"), (cfg.n_layers, 1, 1, hkv, hd),
                            cfg, mesh)[3] == "model"
    lay = ServingLayout(
        m=model_axis_size(mesh),
        q=kind(("attn", "wq", "w"), (d, h * hd)),
        kv=kind(("attn", "wk", "w"), (d, hkv * hd)),
        wo=kind(("attn", "wo", "w"), (h * hd, d)),
        mlp=kind(("mlp", "gate", "w"), (d, ff)),
        vocab=vocab, pool=pool)
    if lay.q == "col" and not lay.pool and hkv > 1:
        # a shard's q heads would not be whole GQA groups of the pool's
        # kv heads (no config of the port has this; gemma3's one kv head
        # does not)
        raise NotImplementedError(
            f"{cfg.arch_id} on {lay.m} shards: {h} q heads split over "
            f"{hkv} kv heads kept whole")
    return lay
