"""Top-k MoE with grouped capacity routing, on torch tensors.

Port of the JAX package's `models/moe.py`. Each batch row is a routing
group with its own capacity buffer (G, E_pad, C, D), so a row's routing
never depends on what shares the batch. Tokens past an expert's
capacity are dropped (Switch/GShard semantics): with s tokens in a
group, cap = max(int(top_k * s * capacity_factor / n_experts), top_k),
so a serving step's capacity follows its chunk width.

Kept exactly from the reference:
- the router is a plain product in `rt.dtype` (it is never nested),
  its logits then softmaxed in f32;
- top-k picks in descending probability, ties to the lower expert index
  (`jax.lax.top_k`'s order): a stable descending sort, not `torch.topk`,
  whose order among equal values is unspecified on CUDA;
- slots come from a cumsum over the group in token-major,
  k-in-descending-probability order; a dropped choice is clamped to slot
  cap - 1 and masked to zero;
- banks are padded to `n_experts_padded` rows that are never routed to;
- the combine is f32 with the renormalised gates.

No float atomics: the dispatch is an accumulating `index_put_` whose
only colliding values are the exact zeros of dropped choices, so its sum
is the same in any order; the combine sums each token's K contributions
one after another in k order (a scatter-add's order on CUDA is
unspecified, which would break bitwise graph replay against eager and
batch invariance).

The expert products are plain `torch.einsum`s over bank reads
(`_read_bank`), as in the reference, where they are `jnp.einsum`s
outside any Pallas kernel. A bank is read and multiplied in slices of
whole experts of at most 2^28 weights (granite's banks in one slice,
deepseek-v3's 256 experts in 15), so that the rebuild's temporaries stay
near 1 GiB where a whole deepseek-v3 bank's would take ~40 GB: each
expert's product is the same sum over its own weights either way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.nestedfp import NestedTensor, fp8_dequant
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime


def init_moe(gen, cfg, put=L.keep) -> dict:
    """Router (d, E), the three banks (E_pad, ...) and the shared expert,
    drawn in that order; `put` takes each bank and the shared expert's
    weights as drawn (the router is never nested)."""
    m = cfg.moe
    d = cfg.d_model
    ep = m.n_experts_padded          # bank rows >= n_experts never routed to
    scale = d ** -0.5
    p = {"router": L.init_linear(gen, d, m.n_experts)}
    for name in ("w_gate", "w_up"):
        p[name] = put(L.randn(gen, (ep, d, m.d_ff_expert)).mul_(scale))
    p["w_down"] = put(L.randn(gen, (ep, m.d_ff_expert, d))
                      .mul_(m.d_ff_expert ** -0.5))
    if m.n_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, m.d_ff_expert * m.n_shared_experts,
                                    put=put)
    return p


def _read_bank(rt: Runtime, w) -> torch.Tensor:
    """An expert bank (or a slice of its experts) in rt.dtype: FP16 mode
    reads the lossless f16
    rebuild, FP8 mode the upper byte dequantized (a weight-precision
    switch, no activation quantization); an exception bank reads f16 in
    both modes."""
    if isinstance(w, NestedTensor):
        if rt.mode == "fp8" and not w.is_exception:
            return fp8_dequant(w.upper, rt.dtype)
        return w.read_f16().to(rt.dtype)
    return w.to(rt.dtype)


# the most weights one bank slice rebuilds at a time (1 GiB in f32)
_BANK_SLICE_WEIGHTS = 1 << 28


def _bank_slices(w) -> list[slice]:
    """Slices of whole experts, each at most _BANK_SLICE_WEIGHTS weights."""
    e, per = w.shape[0], math.prod(w.shape[1:])
    n = max(1, _BANK_SLICE_WEIGHTS // per)
    return [slice(i, min(i + n, e)) for i in range(0, e, n)]


def _experts(w, sl: slice):
    """Experts `sl` of a bank (a view; nested banks keep their planes)."""
    if isinstance(w, NestedTensor):
        return NestedTensor(*(None if t is None else t[sl]
                              for t in (w.upper, w.lower, w.raw)))
    return w[sl]


def _expert_ffn(rt: Runtime, p: dict, xb: torch.Tensor,
                partial: bool = False) -> torch.Tensor:
    """xb: (G, E, C, D) -> (G, E, C, D), SwiGLU batched over experts.
    Products in rt.dtype rounded to f32 (bf16 under fast_accum), as the
    reference's preferred_element_type. partial: the banks are a shard's
    F slice (per-expert tensor parallel), and the down product stays the
    f32 partial sum over those F rows, for the mesh to add up."""
    dt = rt.dtype
    acc = torch.bfloat16 if rt.fast_accum else torch.float32

    def prod(eq, a, bank, acc=acc):
        out = []
        for sl in _bank_slices(bank):
            w, ai = _read_bank(rt, _experts(bank, sl)), a[:, sl]
            if acc == torch.float32 and dt != torch.float32:
                ai, w = ai.float(), w.float()    # exact: values of dt
            out.append(torch.einsum(eq, ai, w).to(acc))
            del w
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)

    x = xb.to(dt)
    gate = prod("gecd,edf->gecf", x, p["w_gate"])
    up = prod("gecd,edf->gecf", x, p["w_up"])
    h = (F.silu(gate.float()) * up.float()).to(dt)
    return prod("gecf,efd->gecd", h, p["w_down"],
                torch.float32 if partial else acc)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    descending order, ties to the lower index (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class _Routing:
    """One MoE step's routing (`_route`): the router's f32 logits and
    probabilities, the top-k (renormalised gates, experts), each choice's
    expert (flat_e, (G, S*K)), its capacity slot (clamped) and keep
    mask, the capacity."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate_vals: torch.Tensor
    expert_idx: torch.Tensor
    flat_e: torch.Tensor
    slot_c: torch.Tensor
    keep: torch.Tensor
    cap: int


def _route(rt: Runtime, p: dict, cfg, x: torch.Tensor) -> _Routing:
    """The router (f32 softmax of rt.dtype logits), top-k and the
    per-group capacity slots of x (B, S, D)."""
    m = cfg.moe
    b, s, _ = x.shape
    kk = m.top_k
    logits = L.apply_linear(rt, p["router"], x).float()        # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, kk)                    # (G, S, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(int(kk * s * m.capacity_factor / m.n_experts), kk)
    flat_e = expert_idx.reshape(b, s * kk)                      # (G, S*K)
    onehot = F.one_hot(flat_e, m.n_experts)
    # slot of each choice: how many earlier choices of the group picked
    # the same expert (the reference's max over cumsum * onehot - 1)
    slot = torch.gather(torch.cumsum(onehot, dim=1), 2,
                        flat_e[..., None])[..., 0] - 1
    keep = slot < cap
    return _Routing(logits, probs, gate_vals, expert_idx, flat_e,
                    torch.clamp(slot, max=cap - 1), keep, cap)


def _dispatch(rt: Runtime, r: _Routing, x: torch.Tensor, n_banks: int
              ) -> torch.Tensor:
    """x (B, S, D) into its capacity buffer (G, E_pad, C, D); dropped
    choices add exact zeros."""
    b, s, d = x.shape
    kk = r.flat_e.shape[1] // s
    token_of_choice = torch.arange(s, device=x.device).repeat_interleave(kk)
    vals = (x[:, token_of_choice] * r.keep[..., None]).to(rt.dtype)
    gi = torch.arange(b, device=x.device)[:, None].expand(b, s * kk)
    xb = torch.zeros((b, n_banks, r.cap, d), dtype=rt.dtype, device=x.device)
    xb.index_put_((gi, r.flat_e, r.slot_c), vals, accumulate=True)
    return xb


def _combine(r: _Routing, yb: torch.Tensor, s: int) -> torch.Tensor:
    """The expert outputs yb (G, E_pad, C, D) back to tokens, f32 (B, S,
    D): each token's K terms weighted by its gates and summed in k
    order."""
    b, n = r.flat_e.shape
    kk = n // s
    gi = torch.arange(b, device=yb.device)[:, None].expand(b, n)
    w = (r.gate_vals.reshape(b, -1) * r.keep).float()
    terms = (yb[gi, r.flat_e, r.slot_c].float() * w[..., None]
             ).reshape(b, s, kk, yb.shape[-1])
    y = terms[:, :, 0]
    for j in range(1, kk):
        y = y + terms[:, :, j]
    return y


def moe_block(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
              with_aux: bool = False):
    """x: (B, S, D) -> (B, S, D) in rt.dtype, and with `with_aux` also the
    aux dict: the Switch load-balance and router z losses, the dropped
    share of choices (`moe_drop_fraction`), and the routing itself
    (`router_logits` (B, S, E) f32, `expert_idx` (B, S, K), `keep`
    (B, S, K) bool). The serving steps ignore the aux, as the JAX
    package's do, and skip computing it."""
    m = cfg.moe
    b, s, _ = x.shape
    r = _route(rt, p, cfg, x)
    yb = _expert_ffn(rt, p, _dispatch(rt, r, x, m.n_experts_padded))
    y = _combine(r, yb, s)
    if m.n_shared_experts:
        y = y + L.swiglu(rt, p["shared"], x).float()
    y = y.to(rt.dtype)
    if not with_aux:
        return y
    density = F.one_hot(r.expert_idx, m.n_experts).float().mean(dim=(0, 1, 2))
    router_prob = r.probs.mean(dim=(0, 1))
    aux = {
        "moe_lb_loss": m.n_experts * torch.sum(density * router_prob)
        * m.load_balance_loss,
        "moe_z_loss": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
        * m.router_z_loss,
        "moe_drop_fraction": 1.0 - r.keep.float().mean(),
        "router_logits": r.logits, "expert_idx": r.expert_idx,
        "keep": r.keep.reshape(b, s, m.top_k)}
    return y, aux


def moe_block_mesh(rt: Runtime, mesh, lay, ps: list, cfg, xs: list) -> list:
    """`moe_block` on a mesh (the serving steps': no aux), its input and
    output whole on every shard.

    The router is replicated, so the routing, the capacity slots and the
    dispatch into the whole (G, E_pad, C, D) buffer are the same on every
    shard: they run once a device. Expert-parallel (lay.experts "ep"):
    shard s runs its E_pad / m experts on their slice of the buffer, and
    the expert outputs are gathered along E in shard order, so the
    combine is the unsharded one on the whole buffer (a partial combine
    all-reduced after would sum each token's K terms in another order).
    Per-expert tensor parallel ("tp"): every shard runs every expert on
    its F columns of w_gate / w_up and F rows of w_down, and the f32
    partials are summed in shard order (`Mesh.all_reduce`). The shared
    expert is a SwiGLU on the mesh (`layers.swiglu_mesh`); "whole" runs
    the block whole on every shard."""
    m = cfg.moe
    if lay.experts == "whole":
        return [moe_block(rt, p, cfg, x) for p, x in zip(ps, xs)]
    s = xs[0].shape[1]
    once: dict = {}
    for dev, p, x in zip(mesh.devices, ps, xs):
        if dev not in once:
            r = _route(rt, p, cfg, x)
            once[dev] = (r, _dispatch(rt, r, x, m.n_experts_padded))
    routed = [once[dev] for dev in mesh.devices]
    if lay.experts == "ep":
        e = m.n_experts_padded // mesh.size
        ybs = mesh.all_gather(
            [_expert_ffn(rt, p, xb[:, i * e:(i + 1) * e])
             for i, (p, (_, xb)) in enumerate(zip(ps, routed))], dim=1)
    else:
        ybs = mesh.all_reduce([_expert_ffn(rt, p, xb, partial=True)
                               for p, (_, xb) in zip(ps, routed)])
        if rt.fast_accum:
            ybs = [y.to(torch.bfloat16) for y in ybs]
    combined: dict = {}
    for dev, (r, _), yb in zip(mesh.devices, routed, ybs):
        if dev not in combined:
            combined[dev] = _combine(r, yb, s)
    ys = [combined[dev] for dev in mesh.devices]
    if m.n_shared_experts:
        sh = L.swiglu_mesh(rt, mesh, lay.shared, [p["shared"] for p in ps],
                           xs)
        ys = [y + z.float() for y, z in zip(ys, sh)]
    return [y.to(rt.dtype) for y in ys]
