"""The benchmark's weights, drawn on the device from the run's seed.

Each piece has a generator of its own, seeded from (run seed, index):
index 0 is the top (embedding, final norm, LM head), index i + 1 is
layer i. So the reference can redraw any one layer alone, and both
sides get the same values from the same calls on the same device. A
piece is drawn in one large call a dtype: every weight that serving
nests as one f16 normal buffer, each weight a view of it scaled by
d_in^-0.5 in place (f16 is the type NestedFP serves); the embedding,
the LM head, the router and the norm scales, which serving keeps as
they are, as one f32 buffer. Norm scales are 0.1 * N(0, 1) (the port's
RMSNorm multiplies by 1 + scale), the embedding N(0, 1). The attention's
output projection is drawn at a quarter of d_in^-0.5: at random weights
a causal attention averages its values into one vector that every later
token shares, which piles every token of an MoE onto the same experts
(granite's top expert took ~1000 of 1024 tokens' choices from its
fourth layer on); at a quarter the residual stays token-specific and the
busiest expert takes 118-155 choices of 512 tokens against a mean of
102, as routing over 40 experts would.

The trees use the port's layer layout (`{"w": ...}` linear dicts, expert
banks as bare (E, D, F) tensors), which is also the form the port's
`to_serving` takes. Only torch and numpy are imported here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.spec import Model


def seed_of(seed: int, index: int) -> int:
    """A 63-bit generator seed for piece `index` of run `seed`."""
    a, b = np.random.SeedSequence([seed % 2**64, index]).generate_state(
        2, np.uint32)
    return ((int(a) << 32) | int(b)) & (2**63 - 1)


def _generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, index))


def _layout(m: Model) -> list[tuple[str, tuple[int, ...], float]]:
    """(path, shape, scale) of each f16 weight of a layer, in buffer
    order."""
    d, hd = m.d_model, m.head_dim
    out = [("attn/wq", (d, m.n_heads * hd), d ** -0.5),
           ("attn/wk", (d, m.n_kv_heads * hd), d ** -0.5),
           ("attn/wv", (d, m.n_kv_heads * hd), d ** -0.5),
           ("attn/wo", (m.n_heads * hd, d), 0.25 * (m.n_heads * hd) ** -0.5)]
    if m.moe:
        e, f = m.n_experts_padded, m.d_ff_expert
        out += [("moe/w_gate", (e, d, f), d ** -0.5),
                ("moe/w_up", (e, d, f), d ** -0.5),
                ("moe/w_down", (e, f, d), f ** -0.5)]
    else:
        out += [("mlp/gate", (d, m.d_ff), d ** -0.5),
                ("mlp/up", (d, m.d_ff), d ** -0.5),
                ("mlp/down", (m.d_ff, d), m.d_ff ** -0.5)]
    return out


def _put(tree: dict, path: str, value, linear: bool) -> None:
    *head, last = path.split("/")
    for part in head:
        tree = tree.setdefault(part, {})
    tree[last] = {"w": value} if linear else value


def layer(m: Model, seed: int, i: int, device) -> dict:
    """Layer i's weights: {"ln1", "ln2", "attn": {"wq": {"w"}, ...},
    "mlp": {"gate": {"w"}, ...}} or, for an MoE, "moe": {"router":
    {"w"}, "w_gate", "w_up", "w_down"}."""
    gen = _generator(seed, i + 1, device)
    lay = _layout(m)
    n16 = sum(math.prod(s) for _, s, _ in lay)
    buf = torch.randn(n16, generator=gen, device=device, dtype=torch.float16)
    d = m.d_model
    n32 = 2 * d + (d * m.n_experts if m.moe else 0)
    buf32 = torch.randn(n32, generator=gen, device=device,
                        dtype=torch.float32)
    tree: dict = {"ln1": buf32[:d].mul_(0.1), "ln2": buf32[d:2 * d].mul_(0.1)}
    at = 0
    for path, shape, scale in lay:
        n = math.prod(shape)
        w = buf[at: at + n].view(shape).mul_(scale)
        _put(tree, path, w, linear=len(shape) == 2)
        at += n
    if m.moe:
        tree["moe"]["router"] = {
            "w": buf32[2 * d:].view(d, m.n_experts).mul_(d ** -0.5)}
    return tree


def top(m: Model, seed: int, device) -> dict:
    """{"embed": {"tok": (V, D)}, "final_norm": (D,), "lm_head": {"w":
    (D, V)}}, f32."""
    gen = _generator(seed, 0, device)
    v, d = m.vocab, m.d_model
    buf = torch.randn(2 * v * d + d, generator=gen, device=device,
                      dtype=torch.float32)
    return {"embed": {"tok": buf[:v * d].view(v, d)},
            "lm_head": {"w": buf[v * d: 2 * v * d].view(d, v).mul_(d ** -0.5)},
            "final_norm": buf[2 * v * d:].mul_(0.1)}
