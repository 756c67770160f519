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
    """How a decoder's layers run on a mesh, read off `param_spec` and
    `paged_cache_spec`, so that the forward follows the weights:

    q:    "col" (head-parallel: each shard its q heads), "row" (the
          row-parallel fallback: q, k and v reduced, whole on every
          shard) or "whole"; MLA's wq_b, whose heads are the q heads;
    kv:   wk / wv likewise (MLA: wk_b / wv_b, split by the same heads);
          "whole" beside a "col" q is gemma3's case, every shard
          computing the few kv heads whole;
    wo:   "row" (head-parallel), "col" (the fallback's output columns,
          gathered after) or "whole";
    mlp:  the dense SwiGLU (a hybrid's: its shared block's): "col" (gate
          and up by columns, down by rows) or "whole"; None without one
          (moe, ssm);
    vocab: the embedding and the LM head split by vocab rows / columns;
    pool: the attention pool planes split by kv heads (else whole on
          every shard; MLA's latent planes are always whole);
    q_a:  MLA's wq_a: "col" (its q_lora_rank columns, the latent gathered
          before its norm) or "whole"; None without MLA;
    experts: the MoE banks: "ep" (expert-parallel: each shard E_pad / m
          whole experts), "tp" (per-expert tensor parallel: w_gate and
          w_up by F columns, w_down by F rows) or "whole"; None without
          MoE;
    shared: the MoE shared expert's SwiGLU, as `mlp`; None without one;
    ssm:  Mamba2: "col" (in_z / in_x by columns, the conv_x channels and
          the state by heads; in_bc, in_dt and the conv_bc channels
          whole; out_proj by rows) or "whole"; None without Mamba2;
    ssm_groups: per shard, the B/C group each of its SSM heads reads
          (head h reads group h // (H / n_groups)); () without Mamba2."""
    m: int
    q: str
    kv: str
    wo: str
    mlp: str | None
    vocab: bool
    pool: bool
    q_a: str | None = None
    experts: str | None = None
    shared: str | None = None
    ssm: str | None = None
    ssm_groups: tuple = ()

    @property
    def ssm_heads(self) -> int:
        """SSM heads a shard holds (all of them when "whole")."""
        return len(self.ssm_groups[0]) if self.ssm_groups else 0


def _expert_layout(cfg: ArchConfig, mesh) -> str:
    moe = cfg.moe
    ep, d, f = moe.n_experts_padded, cfg.d_model, moe.d_ff_expert
    gate = param_spec(("layers", 0, "moe", "w_gate"), (ep, d, f), cfg, mesh)
    down = param_spec(("layers", 0, "moe", "w_down"), (ep, f, d), cfg, mesh)
    if gate[0] == "model":
        return "ep"
    if gate[2] == "model" and down[1] == "model":
        return "tp"
    return "whole"


def _ssm_layout(cfg: ArchConfig, mesh, m: int) -> tuple[str, tuple]:
    """("col" | "whole", the group of each SSM head a shard holds)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    rep = n_heads // s.n_groups
    cols = param_spec(("layers", 0, "mamba", "in_x", "w"),
                      (cfg.d_model, d_inner), cfg, mesh)[-1] == "model"
    heads = paged_cache_spec(("ssm", "ssm"), (1, 1, n_heads, s.head_dim,
                                              s.d_state), cfg, mesh)[2]
    if cols and heads != "model":
        raise NotImplementedError(
            f"{cfg.arch_id} on {m} shards: the in_x columns split but its "
            f"{n_heads} SSM heads do not")
    if not cols:
        return "whole", (tuple(h // rep for h in range(n_heads)),) * m
    hs = n_heads // m
    return "col", tuple(tuple((s_ * hs + j) // rep for j in range(hs))
                        for s_ in range(m))


def serving_layout(cfg: ArchConfig, mesh) -> ServingLayout:
    """The layout of `cfg` on `mesh`, for every decoder-only family. An
    MLA stack is served head-parallel only: its n_heads must divide the
    axis (NotImplementedError otherwise)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    m = model_axis_size(mesh)

    def kind(path, shape):
        return _kind(param_spec(("layers", 0) + path, shape, cfg, mesh))
    vocab = param_spec(("embed", "tok"), (cfg.vocab_size, d), cfg,
                       mesh)[0] == "model"
    extra: dict = {}
    if cfg.mla is not None:
        ml = cfg.mla
        q = kind(("attn", "wq_b", "w"),
                 (ml.q_lora_rank, h * (ml.qk_nope_dim + ml.qk_rope_dim)))
        kv = kind(("attn", "wk_b", "w"), (ml.kv_lora_rank, h * ml.qk_nope_dim))
        wo = kind(("attn", "wo", "w"), (h * ml.v_head_dim, d))
        if (q, kv, wo) != ("col", "col", "row"):
            raise NotImplementedError(
                f"{cfg.arch_id} on {m} shards: MLA is served head-parallel "
                f"only, and its {h} heads do not divide the axis")
        extra["q_a"] = kind(("attn", "wq_a", "w"), (d, ml.q_lora_rank))
        pool = False
    elif h:
        q = kind(("attn", "wq", "w"), (d, h * hd))
        kv = kind(("attn", "wk", "w"), (d, hkv * hd))
        wo = kind(("attn", "wo", "w"), (h * hd, d))
        key = "shared" if cfg.family == "hybrid" else "attn"
        pool = paged_cache_spec((key, "k"), (cfg.n_layers, 1, 1, hkv, hd),
                                cfg, mesh)[3] == "model"
    else:                                    # attention-free (mamba2)
        q = kv = wo = "whole"
        pool = False
    mlp = kind(("mlp", "gate", "w"), (d, ff)) if ff else None
    if cfg.moe is not None:
        extra["experts"] = _expert_layout(cfg, mesh)
        if cfg.moe.n_shared_experts:
            extra["shared"] = kind(
                ("moe", "shared", "gate", "w"),
                (d, cfg.moe.d_ff_expert * cfg.moe.n_shared_experts))
    if cfg.ssm is not None:
        extra["ssm"], extra["ssm_groups"] = _ssm_layout(cfg, mesh, m)
    lay = ServingLayout(m=m, q=q, kv=kv, wo=wo, mlp=mlp, vocab=vocab,
                        pool=pool, **extra)
    if lay.q == "col" and cfg.mla is None and not lay.pool and hkv > 1:
        # a shard's q heads would not be whole GQA groups of the pool's
        # kv heads (no config of the port has this; gemma3's one kv head
        # does not)
        raise NotImplementedError(
            f"{cfg.arch_id} on {lay.m} shards: {h} q heads split over "
            f"{hkv} kv heads kept whole")
    return lay
