"""Roofline terms of a step on H100s, reckoned from its FLOPs, bytes and
collectives.

The port's counterpart of the JAX package's `roofline/analysis.py`. Its
terms, all per device:

    compute    = sum over dtype classes of class FLOPs / class peak
    memory     = bytes moved / HBM rate
    collective = sum over mesh axes of weighted wire bytes / link rate

and the bound of a step is the largest. The constants are one NVIDIA
H100 SXM5 80GB's (NVIDIA H100 Tensor Core GPU data sheet, SXM column,
dense rates without sparsity, at its 700 W power limit); no TPU figure
is used. `serving/simulate.py` reads its rates from here. TF32 is
charged nowhere: the port keeps it off (`chip_smoke.py` turns it off),
so f32 products run on the CUDA cores at `PEAK_FLOPS["f32"]`.
Elementwise work is held to its dtype's class peak, a rate it never
reaches (it is bound by memory): a lower bound, like every term here.

`collective_bytes` stands in for the JAX module's parse of the
optimized HLO, which the port, compiling none, cannot have: it reckons
the collectives from the spec tables (`launch/sharding.py`) and the
mesh forward of the serving layers (`models/layers.py`, `moe.py`,
`mla.py`, `mamba2.py`), with the JAX module's ring multipliers.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Layout, data_axes
from repro_torch.models import model as M

# HBM3: 3.35 TB/s (data sheet, H100 SXM5 80GB)
HBM_BYTES_S = 3.35e12
# dense tensor-core peaks (data sheet): bf16 / f16 989.4 TFLOP/s, fp8
# (e4m3) 1978.9; f32 without tensor cores 66.9 ("FP32" row); "other"
# (integer and f64 elementwise) is held to the f32 rate; TF32's 494.7
# is not used (kept off)
PEAK_FLOPS = {"f16": 989.4e12, "e4m3": 1978.9e12, "f32": 66.9e12,
              "other": 66.9e12}
# NVLink 4: 900 GB/s a GPU both ways, 450 a direction, among the 8 GPUs
# of one HGX H100 board; past a board, the node's network: 400 Gb/s
# (one ConnectX-7 port) a GPU, 50 GB/s
NVLINK_BYTES_S = 450e9
NETWORK_BYTES_S = 50e9
BOARD = 8

# bytes on the wire a byte of result (ring algorithms, large n)
_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}


def link_bytes_s(mesh, axes) -> float:
    """The rate of a collective over `axes` of `mesh`: NVLink when the
    devices it spans (the axes and every axis inside them, the mesh's
    last axis innermost) fit one board, else the network."""
    names = mesh.axis_names
    first = min(names.index(a) for a in axes)
    span = 1
    for a in names[first:]:
        span *= mesh.shape[a]
    return NVLINK_BYTES_S if span <= BOARD else NETWORK_BYTES_S


def roofline_terms(flops_by_class: dict, bytes_accessed: float,
                   collective_s: float, *, fp8: bool = False) -> dict:
    """compute_s (each class at its peak), memory_s, collective_s, the
    dominant term and `bound_step_s`, the largest. fp8 rows also give
    `compute_fp8_adj_s`, the JAX record's key: the port counts e4m3 work
    in its own class, so it equals compute_s, at the e4m3 peak, which K2
    and K7 (`mma.sync` e4m3 at the f16 rate, F-port-4) do not reach."""
    compute = sum(f / PEAK_FLOPS[c] for c, f in flops_by_class.items())
    terms = {"compute_s": compute,
             "memory_s": bytes_accessed / HBM_BYTES_S,
             "collective_s": collective_s}
    if fp8:
        terms["compute_fp8_adj_s"] = compute
    key = max(("compute_s", "memory_s", "collective_s"), key=terms.__getitem__)
    terms["dominant"] = key
    terms["bound_step_s"] = terms[key]
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful-compute reference)
# ---------------------------------------------------------------------------

def count_params(param_tree, *, active_expert_fraction: float | None = None
                 ) -> dict[str, float]:
    """Total and active params of a (training-form, meta) tree. Expert
    banks (w_gate / w_up / w_down) count `active_expert_fraction` of
    themselves as active."""
    total = active = 0.0
    for path, leaf, _ in SH.tree_leaves(param_tree):
        n = float(leaf.numel())
        total += n
        if active_expert_fraction is not None and any(
                k in ("w_gate", "w_up", "w_down") for k in path):
            active += n * active_expert_fraction
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(cfg, shape, n_params_active: float) -> float:
    """6·N·D for training, 2·N·tokens for serving steps (per whole step,
    all devices)."""
    if shape.kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch


# ---------------------------------------------------------------------------
# collectives, reckoned from the spec tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tally:
    """Collective result bytes by (type, axes), and each op's count."""
    bytes: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, axes: tuple, nbytes: float, times: int = 1):
        if nbytes <= 0 or times <= 0:
            return
        key = (op, axes)
        self.bytes[key] = self.bytes.get(key, 0.0) + nbytes * times
        self.counts[key] = self.counts.get(key, 0) + times

    def merge(self, other: "_Tally", times: int) -> None:
        """other's collectives, `times` over."""
        for key, b in other.bytes.items():
            self.bytes[key] = self.bytes.get(key, 0.0) + b * times
            self.counts[key] = (self.counts.get(key, 0)
                                + other.counts[key] * times)


def _row_parallel(t: _Tally, tokens: int, n_out: int, mode: str,
                  act_quant: str, exception: bool = False) -> None:
    """`layers.linear_row_parallel`: the f32 partials of (tokens, n_out)
    all-reduced, after (in FP8) the activations' absmax: one f32 a row
    (per token) or one in all (per tensor)."""
    if mode == "fp8" and not exception:
        t.add("all-reduce", ("model",),
              4 * (tokens if act_quant == "per_token" else 1))
    t.add("all-reduce", ("model",), 4 * tokens * n_out)


def _model_axis(cfg, m: int, t: _Tally, *, kind: str, rows: int, seq: int,
                act_bytes: int, mode: str, act_quant: str,
                gather_logits: bool) -> None:
    """The model-axis collectives of one forward of `kind` over `rows`
    rows of `seq` text tokens, as the port's mesh forward does them
    (`layers.linear_row_parallel`, `attention_paged_mesh`, `swiglu_mesh`,
    `moe.moe_block_mesh`, `mla.mla_attention_mesh`,
    `mamba2.mamba2_block_mesh`, `model.embed_tokens_mesh`), for the layout
    `sharding.layout_of` reads off the specs. Outside decode, a vlm's stack
    also runs its `frontend_len` patch tokens, and an encdec runs its
    encoder stack over `model.encdec_enc_len(seq)` frames a row and its
    decoder's cross-attention projects that memory; in decode the cross
    caches stand in for the memory."""
    if m <= 1:
        return
    lay = SH.layout_of(cfg, Layout(("model",), (m,)))
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    serving = kind == "decode"
    prefix = cfg.frontend_len if cfg.frontend == "vision" and not serving \
        else 0
    tokens = rows * (seq + prefix)           # through the decoder stack
    enc = (rows * M.encdec_enc_len(seq)
           if cfg.family == "encdec" and not serving else 0)

    def row(n_out, tok=tokens):
        _row_parallel(t, tok, n_out, mode, act_quant)

    def attention(tok=tokens, kv_tok=tokens):
        if cfg.mla is not None:
            if lay.q_a == "col":
                t.add("all-gather", ("model",),
                      act_bytes * tok * cfg.mla.q_lora_rank)
            row(d, tok)
            return
        if lay.q == "row":
            row(h * hd, tok)
        if lay.kv == "row" and kv_tok:
            row(hkv * hd, kv_tok)
            row(hkv * hd, kv_tok)
        if lay.wo == "row":
            row(d, tok)
        elif lay.wo == "col":
            t.add("all-gather", ("model",), act_bytes * tok * d)

    def swiglu(split, tok=tokens):
        if split == "col":
            row(d, tok)

    def moe():
        mo = cfg.moe
        if lay.experts == "whole":
            return
        cap = max(int(mo.top_k * (seq + prefix) * mo.capacity_factor
                      / mo.n_experts), mo.top_k)
        buf = rows * mo.n_experts_padded * cap * d
        if lay.experts == "ep":
            t.add("all-gather", ("model",), act_bytes * buf)
        else:
            t.add("all-reduce", ("model",), 4 * buf)
        if mo.n_shared_experts:
            swiglu(lay.shared)

    for _ in range(cfg.n_enc_layers if enc else 0):
        attention(enc, enc)
        swiglu(lay.mlp, enc)
    if lay.vocab:
        t.add("all-reduce", ("model",), act_bytes * rows * seq * d)
    for i in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            if lay.ssm == "col":
                t.add("all-reduce", ("model",), 4 * tokens)
                row(d)
            if cfg.family == "hybrid" and i % cfg.attn_every \
                    == cfg.attn_every - 1:
                attention()
                swiglu(lay.mlp)
            continue
        attention()
        if cfg.family == "encdec":
            attention(tokens, enc)
        if cfg.moe is not None:
            moe()
        else:
            swiglu(lay.mlp)
    if lay.vocab and gather_logits:
        t.add("all-gather", ("model",), 4 * rows * cfg.vocab_size)


def collective_bytes(cfg, mesh, *, kind: str, tokens: int, rows: int,
                     mode: str = "fp16", act_bytes: int = 2, n_micro: int = 1,
                     grad_bytes: float = 0.0, param_bytes: float = 0.0,
                     cache_context: bool = False) -> dict:
    """A device's collectives in one step of `kind` ("train", "prefill",
    "decode") over `tokens` tokens in `rows` rows (a data shard's),
    reckoned from the spec tables in place of an HLO parse:

    - every row-parallel application (a weight whose spec splits its
      contraction) all-reduces its f32 output, and in FP8 its rows'
      absmax first; a column split whose output is needed whole (the
      row-parallel fallback's wo, MLA's q latent) all-gathers it; a
      vocab-split embedding all-reduces its rows, a vocab-split head
      all-gathers the f32 logits (the engine's sharded argmax moves one
      value and one id a row instead, not reckoned);
    - MoE banks: expert-parallel over "model" all-gathers the expert
      outputs (G, E_pad, C, D), per-expert tensor parallel all-reduces
      them in f32; banks over the data axes too (deepseek-v3) also
      exchange each token's top-k inputs and outputs (an all-to-all
      each way);
    - a train step on data axes all-reduces its gradients once a
      microbatch (`grad_bytes`, the device's f32 share) and all-gathers
      the ZeRO-1-updated params once a step (`param_bytes`);
    - a context-parallel cache (`cache_context`: long_500k's sequence
      over the data axes) all-reduces each attention application's
      partial softmax: its (rows, H, D) f32 output and two f32 a head.

    The forward is the dry run's: per-tensor FP8 scales, and outside a
    train step the f32 logits gathered. A train step's forward runs
    n_micro times, is run again in backward (every layer is checkpointed,
    `model._remat`), and its backward mirrors it (an all-reduce back for
    each all-gather of the forward and the reverse), so its model-axis
    and all-to-all bytes are 3 x n_micro x the forward's.
    Returns bytes and counts by type and axes, the weighted wire bytes
    (`_MULT`) and `seconds` at each axis's link rate; `bytes_once_total`
    and `n_unattributed` keep the JAX record's keys (every collective is
    counted as often as it runs: no loop hides one)."""
    t = _Tally()
    m = mesh.shape.get("model", 1)
    d_axes = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
    runs = 3 * n_micro if kind == "train" else 1
    fwd = _Tally()
    _model_axis(cfg, m, fwd, kind=kind, rows=rows,
                seq=max(tokens // max(rows, 1), 1), act_bytes=act_bytes,
                mode=mode, act_quant="per_tensor",
                gather_logits=kind != "train")
    t.merge(fwd, runs)
    mo = cfg.moe
    if mo is not None and d_axes:
        spec = SH.param_spec(("layers", 0, "moe", "w_gate"),
                             (mo.n_experts_padded, cfg.d_model,
                              mo.d_ff_expert), cfg, mesh)
        ep = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        dx = tuple(a for a in ep if a in d_axes)
        if dx:
            per = act_bytes * tokens * mo.top_k * cfg.d_model
            t.add("all-to-all", dx, per, 2 * cfg.n_layers * runs)
    if kind == "train" and d_axes:
        t.add("all-reduce", d_axes, grad_bytes, n_micro)
        t.add("all-gather", d_axes, param_bytes)
    if cache_context and d_axes and cfg.n_heads:
        apps = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else 0 if cfg.family == "ssm" else cfg.n_layers)
        t.add("all-reduce", d_axes,
              4 * rows * cfg.n_heads * (cfg.resolved_head_dim + 2), apps)
    by_type: dict = {}
    counts: dict = {}
    weighted = seconds = 0.0
    for (op, axes), b in t.bytes.items():
        by_type[op] = by_type.get(op, 0.0) + b
        counts[op] = counts.get(op, 0) + t.counts[(op, axes)]
        weighted += _MULT[op] * b
        seconds += _MULT[op] * b / link_bytes_s(mesh, axes)
    by_axes = {f"{op}@{'+'.join(axes)}": b for (op, axes), b in t.bytes.items()}
    return {"bytes_by_type": by_type, "counts_by_type": counts,
            "bytes_once_total": sum(by_type.values()), "n_unattributed": 0,
            "bytes_by_type_and_axes": by_axes,
            "weighted_wire_bytes": weighted, "seconds": seconds,
            "source": "reckoned from the spec tables (no HLO)"}

