"""Which dimension of each weight, moment, batch input and cache plane a
mesh splits.

The port of the JAX package's `launch/sharding.py` resolvers
(`param_spec`, `opt_state_spec`, `batch_spec`, `cache_spec`,
`paged_cache_spec`, `tree_shardings`, `scalar_sharding`) as pure shape
logic: a spec is a tuple, one entry a dimension, of None (whole on every
shard), an axis name ("model", "data", "pod": cut into equal slices
along that axis) or a tuple of axis names (cut along their product: the
expert-parallel axis cascade puts deepseek-v3's 256 experts on ("data",
"model")). The rules are the JAX package's, branch for branch, so the
tables agree for every config (tests/test_torch_sharding.py,
tests/test_torch_dryrun.py): any dimension that does not divide its
axes stays whole. A mesh is a serving `launch.mesh.Mesh` (the "model"
axis alone) or a `launch.mesh.Layout` (with data axes).

A path is the leaf's keys in the port's trees. The port keeps one dict a
layer in `params["layers"]` (a list), where the JAX package stacks the
layers into leading (L, ...) dimensions, so a layer's leaf here has no
L dimension and its spec none either; pool and cache planes are (L, ...)
in both packages. Where a rule must see the stacked leaf, as
`opt_state_spec` does (ZeRO-1 may put the data axes on L: llama's 32
layers divide 16), it takes `stack=L` and returns the spec of the
stacked (L, ...) leaf, its first entry the layer list's; `local_bytes`
then charges each layer its share of the stacked leaf's shard, so a
device's bytes come out as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import fractions
import math
from typing import Iterator, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import NestedLinearParams
from repro_torch.core.nestedfp import NestedTensor
from repro_torch.launch.mesh import data_axes, data_axis_size, model_axis_size

Spec = tuple


def _div(n: int, m: int) -> bool:
    return n > 0 and m > 0 and n % m == 0


def _keys(path: Sequence) -> list[str]:
    return [k for k in path if isinstance(k, str)]


# which head count governs a projection's sharded output dim
_Q_NAMES = ("wq", "wq_b")
_KV_NAMES = ("wk", "wv", "wk_b", "wv_b")
_OUT_NAMES = ("wo",)


def _size(mesh, entry) -> int:
    """The number of slices a spec entry cuts its dimension into."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def param_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig,
               mesh, *, stack: int | None = None) -> Spec:
    """The spec of one parameter leaf of `shape` at `path` (e.g.
    ("layers", 3, "attn", "wq", "w"); a nested weight's byte planes have
    the f16 weight's shape). With `stack`, the spec of the stacked leaf:
    a leading None for the layer list."""
    m = model_axis_size(mesh)
    keys = _keys(path)
    body = tuple(shape)
    rank = len(body)
    lead = () if stack is None else (None,)

    def spec(*dims):
        return lead + tuple(dims)

    # embeddings / head (kept un-nested): vocab-sharded iff divisible
    if "embed" in keys:                      # (V, D)
        return spec("model" if _div(body[0], m) else None, None)
    if "lm_head" in keys:                    # (D, V)
        if rank == 1:
            return spec("model" if _div(body[0], m) else None)
        return spec(None, "model" if _div(body[1], m) else None)
    if "router" in keys or "frontend_proj" in keys:
        return spec(*([None] * rank))

    # MoE expert banks (E_pad, D, F) / (E_pad, F, D): expert-parallel over
    # the widest axes whose size divides the (padded) expert count (multi
    # pod: 256 experts on (data, model), whole across pods), else per-
    # expert tensor parallel
    if any(k in keys for k in ("w_gate", "w_up", "w_down")):
        for axes in (data_axes(mesh) + ("model",), ("data", "model"),
                     ("model",)):
            if all(a in mesh.axis_names for a in axes) \
                    and _div(body[0], _size(mesh, axes)):
                return spec(axes if len(axes) > 1 else axes[0], None, None)
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


def opt_state_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig,
                   mesh, *, stack: int | None = None) -> Spec:
    """ZeRO-1: an AdamW moment takes its param's spec plus the data axes
    on the first dimension still whole that their size divides (the
    stacked L first: pass `stack` for a leaf of a layer list). Expert
    banks already cut along data keep their spec; so does every leaf of
    a mesh without data axes."""
    base = param_spec(path, shape, cfg, mesh, stack=stack)
    d_axes = data_axes(mesh)
    if not d_axes:
        return base
    dsz = data_axis_size(mesh)
    full = ((stack,) if stack is not None else ()) + tuple(shape)
    taken = {a for d in base for a in (d if isinstance(d, tuple) else (d,))
             if a}
    if taken & set(d_axes):
        return base
    dims = list(base)
    for i, (d, n) in enumerate(zip(dims, full)):
        if d is None and n % dsz == 0:
            dims[i] = d_axes if len(d_axes) > 1 else d_axes[0]
            return tuple(dims)
    return base


def batch_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig, mesh,
               *, micro: bool = False) -> Spec:
    """A batch input (tokens, a vlm's patch_embeds, an encdec's frames):
    its batch dim over the data axes when their size divides it; `micro`
    marks a leading n_micro dim."""
    d = data_axes(mesh)
    bdim = 1 if micro else 0
    dims: list = [None] * len(shape)
    if d and len(shape) > bdim and _div(shape[bdim], data_axis_size(mesh)):
        dims[bdim] = d if len(d) > 1 else d[0]
    return tuple(dims)


def cache_spec(path: Sequence, shape: Sequence[int], cfg: ArchConfig,
               mesh) -> Spec:
    """A dense per-slot cache plane (`model.init_cache`, leading layer
    dim): the batch over the data axes when their size divides it, else
    (long_500k, one row) the cache's SEQUENCE axis over them: context
    parallelism, whose partial-softmax reduction
    `roofline.analysis.collective_bytes` reckons. Heads (or the SSM
    heads, the conv_x channels, an MLA latent's sequence) over "model"
    where they divide."""
    m = model_axis_size(mesh)
    d = data_axes(mesh)
    dsz = data_axis_size(mesh)
    dt = d if len(d) > 1 else d[0] if d else None
    keys = _keys(path)
    shape = tuple(shape)
    dims: list = [None] * len(shape)
    batch_ok = bool(d) and len(shape) >= 2 and _div(shape[1], dsz)
    seq_ok = bool(d) and not batch_ok
    if batch_ok:
        dims[1] = dt
    if "ssm" in keys and len(shape) == 5:      # (L, B, H, P, N)
        if _div(shape[2], m):
            dims[2] = "model"
    elif "conv_x" in keys and len(shape) == 4:
        if _div(shape[3], m):                  # (L, B, W-1, d_inner)
            dims[3] = "model"
    elif "conv_bc" in keys and len(shape) == 4:
        pass                                   # tiny; channels whole
    elif len(shape) == 5:                      # (L, B, Cap, Hkv, D)
        if _div(shape[3], m):
            dims[3] = "model"
        elif _div(shape[2], m):
            dims[2] = "model"                  # kv heads indivisible
        if seq_ok and _div(shape[2], dsz):
            dims[2] = dt if dims[2] is None else d + ("model",)
    elif len(shape) == 4:                      # (L, B, Cap, r) MLA latents
        if _div(shape[2], m):
            dims[2] = "model"
        if seq_ok and _div(shape[2], dsz * m):
            dims[2] = d + ("model",)
        elif seq_ok and _div(shape[2], dsz):
            dims[2] = dt
    return tuple(dims)


def scalar_sharding(mesh) -> Spec:
    """The spec of a scalar: whole on every shard."""
    return ()


def tree_leaves(tree, path: tuple = (), stack: int | None = None
                ) -> Iterator[tuple[tuple, torch.Tensor, int | None]]:
    """(path, tensor, stack) of every tensor leaf of a params, moments,
    batch or cache tree, in tree order: a nested linear's byte planes at
    (..., "w", "upper" / "lower" / "raw") and its bias at (..., "b"), a
    list's entries at their index; `stack` is the length of the nearest
    list above the leaf (None outside one). Walked with a stack of its
    own, not by recursion: a deep model's layer lists make this a hot
    loop of the dry run."""
    todo = [(path, tree, stack)]
    while todo:
        path, tree, stack = todo.pop()
        if isinstance(tree, torch.Tensor):
            yield path, tree, stack
        elif isinstance(tree, NestedLinearParams):
            todo.append((path, {"w": tree.weight, "b": tree.bias}, stack))
        elif isinstance(tree, NestedTensor):
            todo.append((path, {"upper": tree.upper, "lower": tree.lower,
                                "raw": tree.raw}, stack))
        elif isinstance(tree, dict):
            todo.extend((path + (k,), v, stack)
                        for k, v in reversed(tree.items()))
        elif isinstance(tree, (list, tuple)):
            n = len(tree)
            todo.extend((path + (i,), tree[i], n) for i in range(n - 1, -1, -1))


def tree_specs(tree, rule, cfg: ArchConfig, mesh, **kw
               ) -> list[tuple[tuple, torch.Tensor, int | None, Spec]]:
    """(path, leaf, stack, spec) of every leaf of `tree` under `rule` (the
    counterpart of the JAX package's `tree_shardings`): a leaf of a layer
    list gets the spec of its stacked leaf (`stack=` passed to the
    rule). A rule reads a path's names only (`_keys`), so it is asked
    once for the leaves that every layer of a list repeats."""
    out = []
    seen: dict = {}
    for path, leaf, stack in tree_leaves(tree):
        key = (tuple(_keys(path)), tuple(leaf.shape), stack)
        if key not in seen:
            extra = {} if stack is None else {"stack": stack}
            seen[key] = rule(path, tuple(leaf.shape), cfg, mesh, **extra, **kw)
        out.append((path, leaf, stack, seen[key]))
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """A shard's shape of a leaf of `shape` under `spec` on `mesh`."""
    return tuple(n // _size(mesh, e) for n, e in zip(shape, spec))


def local_bytes(leaf: torch.Tensor, spec: Spec, mesh,
                stack: int | None = None) -> fractions.Fraction:
    """A shard's bytes of `leaf` under `spec`: with `stack`, the leaf's
    share (1 / stack) of its stacked leaf's shard, so that the layers of
    a list sum to the JAX package's stacked leaf."""
    full = ((stack,) if stack is not None else ()) + tuple(leaf.shape)
    n = math.prod(local_shape(full, spec, mesh)) * leaf.element_size()
    return fractions.Fraction(n, stack or 1)


def shard_bounds(spec: Spec, shape: Sequence[int], mesh, s: int
                 ) -> tuple[int, int, int] | None:
    """(dim, start, length) of shard s's slice along a serving mesh's
    "model" axis, or None for a leaf kept whole."""
    for d, (n, name) in enumerate(zip(shape, spec)):
        if name == "model":
            c = n // mesh.shape["model"]
            return d, s * c, c
        if name is not None:
            raise ValueError(f"a serving shard is cut along 'model' only, "
                             f"not {name!r}")
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
    """The layout of `cfg` on `mesh`, for every decoder-only family, as
    the port serves it (`layout_of`). An MLA stack is served head-
    parallel only: its n_heads must divide the axis; and a shard's q heads
    must be whole GQA groups of its kv heads (NotImplementedError
    otherwise)."""
    lay = layout_of(cfg, mesh)
    if cfg.mla is not None and (lay.q, lay.kv, lay.wo) != ("col", "col",
                                                          "row"):
        raise NotImplementedError(
            f"{cfg.arch_id} on {lay.m} shards: MLA is served head-parallel "
            f"only, and its {cfg.n_heads} heads do not divide the axis")
    if lay.q == "col" and cfg.mla is None and not lay.pool \
            and cfg.n_kv_heads > 1:
        # a shard's q heads would not be whole GQA groups of the pool's
        # kv heads (no config of the port has this at 2, 4 or 8 shards;
        # gemma3's one kv head does not)
        raise NotImplementedError(
            f"{cfg.arch_id} on {lay.m} shards: {cfg.n_heads} q heads split "
            f"over {cfg.n_kv_heads} kv heads kept whole")
    return lay


def layout_of(cfg: ArchConfig, mesh) -> ServingLayout:
    """How each weight of `cfg` splits on `mesh`'s "model" axis, read off
    `param_spec` and `paged_cache_spec`, whether or not the port serves
    that layout (`roofline.analysis` reckons collectives from it)."""
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
    return ServingLayout(m=m, q=q, kv=kv, wo=wo, mlp=mlp, vocab=vocab,
                         pool=pool, **extra)
