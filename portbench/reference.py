"""The plain reference: the configuration's forward pass in f32 torch ops.

It imports nothing of the port and nothing of JAX. It redraws the
weights from the run's seed one layer at a time (`portbench.weights`),
so it fits on the card once the engine is freed, and runs every sampled
sequence (prompt + served tokens) through the whole stack at once:
linears over all tokens together, causal attention one sequence at a
time, in blocks of queries.

Each precision is the configuration's arithmetic at that precision, with
f32 sums (TF32 is off: the caller sets it):

- "fp16": the weights' f16 values; every linear's input rounded to f16
  (an FP16 GEMM's operands); keys and values rounded to f16 (the KV
  cache's type); expert FFNs on f32 activations.
- "fp8": NestedFP8. A linear's weight is the e4m3 value of w * 2^8 times
  2^-8 (a frozen copy of the format: the upper byte of the nested f16
  is that e4m3 code), its input quantized per token to e4m3 under
  absmax / 448; keys and values are the high byte of their f16 bits
  (e5m2, truncated); expert banks read their e4m3 weights on f32
  activations.

The embedding, the router, the final norm and the LM head stay f32 in
every precision, as the port serves them. MoE routing is the published
one: softmax over the router's logits, the top-k by a stable descending
sort, the gates renormalised, every choice served (no capacity limit),
each token's k terms summed in k order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import weights as W
from portbench.spec import Model

PRECISIONS = ("fp16", "fp8")
E4M3_MAX = 448.0
NESTED_SCALE = 256.0


def e4m3_weight(w: torch.Tensor) -> torch.Tensor:
    """The FP8-mode value of an f16 weight under NestedFP: e4m3(w * 2^8)
    * 2^-8, round to nearest even (|w| <= 1.75 keeps w * 2^8 in range)."""
    x = (w.float() * NESTED_SCALE).clamp(-E4M3_MAX, E4M3_MAX)
    return x.to(torch.float8_e4m3fn).float() / NESTED_SCALE


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp16":
        return w.float()
    if precision == "fp8":
        return e4m3_weight(w)
    raise ValueError(f"unknown precision {precision!r}")


def act(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A linear's input at the precision: f16-rounded, or per-token e4m3
    codes times their scale (max(absmax, 1e-12) / 448, an IEEE
    division)."""
    if precision == "fp16":
        return x.half().float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    scale = amax / torch.full_like(amax, E4M3_MAX)
    q = (x / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return q.float() * scale


def kv(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A key or value as the cache returns it: f16, or (FP8 modes) the
    high byte of the f16 bits alone."""
    h = x.half()
    if precision != "fp16":
        h = (h.view(torch.int16) & -256).view(torch.float16)
    return h.float()


def rms_norm(x, scale, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope(x, positions, theta):
    """x (T, H, D), positions (T,): the split-half rotation."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, block: int = 512):
    """Causal GQA attention of one sequence: q (T, H, D), k / v (T, Hkv,
    D) -> (T, H * D)."""
    t, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(t, hkv, h // hkv, d) * d ** -0.5
    out = []
    for a in range(0, t, block):
        b = min(a + block, t)
        s = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b])
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hgqk,khd->qhgd", p, v[:b]).reshape(b - a, -1))
    return torch.cat(out)


def moe(m: Model, p: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    logits = h @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    terms = torch.zeros(h.shape[0], m.top_k, h.shape[1], device=h.device)
    for e in range(m.n_experts):
        rows, ks = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        wg, wu, wd = (weight(p[n][e], precision)
                      for n in ("w_gate", "w_up", "w_down"))
        y = (F.silu(x @ wg) * (x @ wu)) @ wd
        terms[rows, ks] = y * gates[rows, ks, None]
    y = terms[:, 0]
    for j in range(1, m.top_k):
        y = y + terms[:, j]
    return y


def _layer(m: Model, p: dict, x, spans, positions, precision: str):
    def lin(a, w):
        return act(a, precision) @ weight(w, precision)

    t = x.shape[0]
    hd = m.head_dim
    h = rms_norm(x, p["ln1"], m.norm_eps)
    a = p["attn"]
    q = rope(lin(h, a["wq"]["w"]).view(t, m.n_heads, hd), positions,
             m.rope_theta)
    k = kv(rope(lin(h, a["wk"]["w"]).view(t, m.n_kv_heads, hd), positions,
                m.rope_theta), precision)
    v = kv(lin(h, a["wv"]["w"]).view(t, m.n_kv_heads, hd), precision)
    o = torch.cat([attend(q[s0:s1], k[s0:s1], v[s0:s1]) for s0, s1 in spans])
    x = x + lin(o, a["wo"]["w"])
    h = rms_norm(x, p["ln2"], m.norm_eps)
    if m.moe:
        return x + moe(m, p["moe"], h, precision)
    f = p["mlp"]
    return x + lin(F.silu(lin(h, f["gate"]["w"])) * lin(h, f["up"]["w"]),
                   f["down"]["w"])


def logits_at(m: Model, seed: int, seqs: list[list[int]],
              rows: list[list[int]], precision: str,
              device) -> torch.Tensor:
    """The f32 logits (n, V) at the given rows of every sequence (rows[j]
    indexes sequence j), concatenated in order."""
    lens = [len(s) for s in seqs]
    spans, at = [], 0
    for n in lens:
        spans.append((at, at + n))
        at += n
    tokens = torch.tensor([t for s in seqs for t in s], device=device)
    positions = torch.cat([torch.arange(n, device=device) for n in lens])
    top = W.top(m, seed, device)
    x = top["embed"]["tok"][tokens.long()]
    for i in range(m.n_layers):
        p = W.layer(m, seed, i, device)
        x = _layer(m, p, x, spans, positions, precision)
        del p
    pick = torch.tensor([s0 + r for (s0, _), rs in zip(spans, rows)
                         for r in rs], device=device, dtype=torch.long)
    h = rms_norm(x[pick], top["final_norm"], m.norm_eps)
    return h @ top["lm_head"]["w"]


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best."""
    return logits.max(dim=-1).values - logits.gather(
        1, tokens[:, None].long())[:, 0]
