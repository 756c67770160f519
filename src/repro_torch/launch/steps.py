"""Step functions of training (train_4k) and of the dense-slot serving
path (prefill_32k / decode_32k), and the shapes of their inputs.

  make_train_step   -> step(params, opt_state, batch(n_micro, mb, ...))
                       -> (params, opt_state, metrics)
  make_prefill_step -> step(params, batch) -> (logits, caches)
  make_decode_step  -> step(params, caches, tokens, cache_len)
                       -> (logits, caches)

The train step runs `model.train_loss` in `TRAIN_RT` (bf16 activations,
f32 params) once a microbatch, sums the f32 gradients over the
microbatches (autograd's accumulation into each param's `.grad`),
divides by their count and applies AdamW (`optim/adamw.py`) in place.
`batch_specs`, `param_structs`, `opt_structs` and `cache_structs` give
the inputs' shapes and dtypes as meta tensors (nothing allocated), as
the JAX package's ShapeDtypeStruct stand-ins do; `shape_supported` is
its shape policy. The dry run (`launch/dryrun.py`) runs these steps on
them.

As in the JAX package, serving steps run bf16 activations with bf16-
rounded GEMM outputs (`fast_accum`) and the paper's per-tensor FP8
activation scale, for every family. The prefill caches are f16;
`model.planarize_cache` turns GQA caches (a hybrid's shared attention's
too) into the byte-planar form that FP8 decode reads half of (MLA
latents and an encdec's cross caches stay as they are). MoE layers
(granite-moe-3b, deepseek-v3) route within each row and read their
expert banks in bf16 here. An ssm stack (mamba2) keeps its recurrent
state in the caches instead ({"ssm": conv_x, conv_bc, ssm}), O(1) in the
sequence's length; a hybrid (zamba2) adds its shared attention's caches
("shared": 32 heads of 80, K6 in the prefill and K5 over planar caches
in the decode). A vlm (phi-3-vision) prefills its stub patch embeddings
ahead of the text and an encdec (seamless) its encoder over stub frames
(`stub_frontend` makes both as the JAX package's `batch_specs` shapes
them); an encdec's decode reads the cross caches its prefill returned.
Decode writes the caches in place.

The decode step is the port's counterpart of the JAX package's
`jax.jit(make_decode_step(cfg, mode), donate_argnums=(1,))`
(`repro/launch/dryrun.py`). Its key is JAX's jit key, shapes plus the
donated buffers: the batch, the capacity, planar caches or f16, the
caches' buffers and the params (the mode is fixed per step). On a card a
key's first call runs the step eagerly and captures it into a CUDA graph
(`serving/graphs.py::capture`); every later call with the key stages its
inputs and replays the graph. The prefill step stays eager: its device
is busy ~99 % of its wall time, so a graph would buy nothing.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.convert import to_serving
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw
from repro_torch.serving import graphs

TRAIN_RT = Runtime(mode="train", dtype=torch.bfloat16)


def serve_rt(mode: str) -> Runtime:
    return Runtime(mode=mode, dtype=torch.bfloat16, fast_accum=True)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    """step(params, opt_state, batch) -> (params, opt_state, metrics), in
    TRAIN_RT (read when the step runs, as the reference's trace reads it).
    batch: {name: (n_micro, mb, ...)} arrays or tensors (`data.pipeline.
    microbatch_split`), moved to the params' device. The params (f32
    leaves of a `model.init_params` tree) are updated in place and keep
    their last gradients in `.grad`; metrics: "loss" (the mean over the
    microbatches), "grad_norm" and "lr", f32 device scalars."""

    def step(params, opt_state, batch):
        leaves = [p for p, _ in adamw.leaves(params)]
        dev = leaves[0].device
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        n_micro = next(iter(batch.values())).shape[0]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            loss, _ = M.train_loss(TRAIN_RT, params, cfg,
                                   {k: v[i] for k, v in batch.items()})
            loss.backward()
            lsum = lsum + loss.detach()
        for p in leaves:
            if p.grad is None:              # a leaf the loss does not read
                p.grad = torch.zeros_like(p)
            p.grad.div_(n_micro)
        grads = adamw.tree_map(lambda p: p.grad, params)
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": lsum / n_micro, **om}

    return step


def stub_frontend(cfg: ArchConfig, batch: int, seq: int, *, generator=None,
                  device=None) -> dict[str, torch.Tensor]:
    """A stub frontend's inputs for a prefill of `batch` rows of `seq`
    tokens, normal draws in bf16 shaped as the JAX package's
    `batch_specs`: a vlm's "patch_embeds" (B, frontend_len,
    frontend_dim), an encdec's "frames" (B, encdec_enc_len(seq),
    frontend_dim); {} for a text-only config. device=None means the
    card."""
    dev = resolve_device(device)
    shape = {"vision": ("patch_embeds", cfg.frontend_len),
             "audio": ("frames", M.encdec_enc_len(seq))}.get(cfg.frontend)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.randn((batch, n, cfg.frontend_dim), device=dev,
                              generator=generator).to(torch.bfloat16)}


def make_prefill_step(cfg: ArchConfig, mode: str = "fp16",
                      capacity: int | None = None):
    """step(params, batch) -> (logits, caches); batch holds "tokens" and
    the stub frontend's inputs (`stub_frontend`)."""
    rt = serve_rt(mode)

    def step(params, batch):
        logits, caches, _ = M.prefill(rt, params, cfg, batch,
                                      capacity=capacity)
        return logits, caches

    return step


def make_decode_step(cfg: ArchConfig, mode: str = "fp16") -> "DecodeStep":
    return DecodeStep(cfg, mode)


def _planes(caches) -> dict[str, torch.Tensor]:
    """Every cache plane by its name; a name two subtrees share (an
    encdec's "k" and "v" under "attn" and "cross") is qualified by its
    subtree ("cross/k")."""
    seen = collections.Counter(n for planes in caches.values()
                               for n in planes)
    return {(n if seen[n] == 1 else f"{sub}/{n}"): p
            for sub, planes in caches.items() for n, p in planes.items()}


@dataclasses.dataclass
class _Key:
    """One key's static buffers, and its graph once captured."""
    params: dict                         # held: its id is in the key
    dev: torch.Tensor                    # packed int32 inputs (2B,)
    host: torch.Tensor                   # the same on the host (pinned)
    tokens: torch.Tensor                 # (B, 1) view into `dev`
    lens: torch.Tensor                   # (B,) view into `dev`
    logits: torch.Tensor                 # (B, V) f32, the static output
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict[str, int] | None = None   # recorded at capture
    uploaded: torch.cuda.Event | None = None


class DecodeStep:
    """step(params, caches, tokens, cache_len) -> (logits, caches).

    tokens: (B, 1) ints, on the caches' device or the host; cache_len: an
    int (range-checked on the host, as `model.decode_step` does) or a
    (B,) / 0-dim tensor (on the caches' device it is copied there, with
    no host read). Both go into the key's static int32 buffer: what comes
    from the host in one copy from a pinned buffer, what lies on the
    device by a copy on the device. The caches are written in place.

    The returned logits are the key's static (B, V) f32 buffer: they stay
    valid until the next call with the same key, which overwrites them.
    All of a step's graphs share one memory pool, which the step owns and
    which goes with it; the static buffers live outside the pool. A key
    holds its params (their id is in the key), never the caches: a
    replay reads the buffers of the caches it is given, whose addresses
    the key names. On the CPU the same buffers are staged and the step
    runs eagerly on them, as `serving/graphs.py::StepGraphs` does."""

    def __init__(self, cfg: ArchConfig, mode: str = "fp16"):
        self.cfg, self.mode, self.rt = cfg, mode, serve_rt(mode)
        self._keys: dict[tuple, _Key] = {}
        self._pool = None

    @staticmethod
    def key(params, caches, tokens) -> tuple:
        """(batch, capacity (None for a recurrent state), planar, the
        caches' planes as (name, address, shape, strides), id(params))."""
        planes = _planes(caches)
        return (tokens.shape[0], M.cache_capacity(caches),
                "k_hi" in planes,
                tuple((n, p.data_ptr(), tuple(p.shape), p.stride())
                      for n, p in planes.items()), id(params))

    def keys(self) -> set:
        return set(self._keys)

    def graph(self, key: tuple) -> torch.cuda.CUDAGraph | None:
        """The key's captured graph (None before its capture, and on the
        CPU)."""
        return self._keys[key].graph

    @property
    def n_captured(self) -> int:
        """Keys whose graph has been captured."""
        return sum(st.graph is not None for st in self._keys.values())

    def pool_bytes(self) -> int:
        """Bytes the card's allocator holds in the step's graph pool (0 on
        the CPU)."""
        return graphs.pool_bytes(self._pool)

    def __call__(self, params, caches, tokens, cache_len):
        key = self.key(params, caches, tokens)
        st = self._keys.get(key) or self._new(key, params, caches)
        self._stage(st, caches, tokens, cache_len)
        if not st.dev.is_cuda:
            self._body(st, caches)
        elif st.graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            st.graph, st.launches = graphs.capture(
                lambda: self._body(st, caches), self._pool, st.dev.device)
        else:
            graphs.replay(st.graph, st.launches)
        return st.logits, caches

    def _new(self, key: tuple, params, caches) -> _Key:
        b = key[0]
        dev = next(iter(_planes(caches).values())).device
        buf = torch.zeros(2 * b, dtype=torch.int32, device=dev)
        host = torch.zeros(2 * b, dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        st = _Key(params, buf, host, buf[:b].view(b, 1), buf[b:],
                  torch.empty((b, self.cfg.vocab_size), dtype=torch.float32,
                              device=dev))
        self._keys[key] = st
        return st

    def _stage(self, st: _Key, caches, tokens, cache_len) -> None:
        b, dev = st.lens.shape[0], st.dev.device
        M.check_cache_len(M.cache_capacity(caches), cache_len)
        tok_here = tokens.device == dev
        len_here = (isinstance(cache_len, torch.Tensor)
                    and cache_len.device == dev)
        if not (tok_here and len_here):          # one upload of the host part
            if st.uploaded is not None:
                st.uploaded.synchronize()        # the last upload has left
            if not tok_here:
                st.host[:b].copy_(tokens.reshape(b))
            if not len_here:
                st.host[b:].copy_(torch.as_tensor(cache_len))
            st.dev.copy_(st.host, non_blocking=st.dev.is_cuda)
            if st.dev.is_cuda:
                st.uploaded = torch.cuda.Event()
                st.uploaded.record()
        if tok_here:
            st.tokens.copy_(tokens)
        if len_here:
            st.lens.copy_(cache_len)

    def _body(self, st: _Key, caches) -> None:
        st.logits.copy_(M.decode_logits(self.rt, st.params, self.cfg,
                                        st.tokens, caches, st.lens))

    def check_replay(self, params, caches, tokens, cache_len
                     ) -> dict[str, bool]:
        """Run the step once as a call does (a replay, once the key is
        captured) and `model.decode_step` once eagerly on clones of the
        same caches; compare the logits and every cache plane bitwise.
        The caches are left as the step wrote them, and the launch
        counters count the step and not the eager call. Returns
        {"logits": equal, plane name: equal, ...}."""
        clones = {sub: {n: p.clone() for n, p in planes.items()}
                  for sub, planes in caches.items()}
        before = ops.all_launch_counters()
        want, _ = M.decode_step(self.rt, params, self.cfg, tokens, clones,
                                cache_len)
        after = ops.all_launch_counters()
        ops.add_launches({k: before[k] - after[k] for k in after})
        got, _ = self(params, caches, tokens, cache_len)
        same = {"logits": bool(torch.equal(got, want))}
        want_planes = _planes(clones)
        for n, p in _planes(caches).items():
            same[n] = bool(torch.equal(p, want_planes[n]))
        return same


# ---------------------------------------------------------------------------
# input shapes (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def micro_layout(shape: InputShape, data_size: int) -> tuple[int, int]:
    """(n_micro, micro_batch): one sample a data shard a microbatch, as
    in the JAX package (whose set of archs that run the whole global
    batch in one shot is empty)."""
    mb = min(shape.global_batch, data_size)
    return shape.global_batch // mb, mb


def batch_specs(cfg: ArchConfig, shape: InputShape, *,
                data_size: int = 1) -> dict:
    """The model inputs of a workload shape as meta tensors: a train
    shape's microbatched (n_micro, mb, ...) tokens of seq + 1 (and a
    vlm's patch_embeds or an encdec's frames, bf16), a prefill's (B, S)
    tokens (and the same extras), a decode's (B, 1) tokens and a scalar
    cache_len."""
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "cache_len": _meta((), torch.int32)}
    lead, n = ((micro_layout(shape, data_size), s + 1)
               if shape.kind == "train" else ((b,), s))
    out = {"tokens": _meta(lead + (n,), torch.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = _meta(lead + (cfg.frontend_len,
                                            cfg.frontend_dim), torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = _meta(lead + (M.encdec_enc_len(s), cfg.frontend_dim),
                              torch.bfloat16)
    return out


def param_structs(cfg: ArchConfig, *, serving: bool):
    """The params' tree on the meta device (training form, or nested as
    `to_serving` nests it)."""
    spec = M.init_params(cfg, device="meta")
    return to_serving(spec, structural=True) if serving else spec


def opt_structs(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, params_spec):
    """The AdamW state of `params_spec` on the meta device."""
    return adamw.init_state(opt_cfg, params_spec)


def cache_structs(cfg: ArchConfig, shape: InputShape, planar: bool = False):
    """A decode shape's caches (`model.init_cache` of global_batch rows of
    seq_len) on the meta device."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        planar=planar, device="meta")


def shape_supported(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """The shape policy of the JAX package: long_500k only for sub-
    quadratic archs. (ok, the reason when not)."""
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, ("full-attention arch: 500k dense-cache serving is "
                       "quadratic at prefill; skipped per DESIGN.md shape "
                       "policy")
    return True, ""
