"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060], on torch
tensors.

Port of the JAX package's `models/mamba2.py`. The chunked SSD splits the
sequence into chunks of Q tokens: inside a chunk the masked-decay score
matrix is applied directly, and a loop over chunks carries the (H, P, N)
recurrent state from one chunk to the next (the reference's `lax.scan`).
Decode is one recurrence step on a (B, H, P, N) state plus a rolling
depthwise-conv cache: O(1) a token whatever the context length.

Recurrence (per head h, diagonal A):
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T        (S: P x N)
    y_t = C_t S_t^T + D x_t

Kept exactly from the reference: the f32 arithmetic of the scan and of
the decode step, the state emitted BEFORE each chunk, padding to a whole
number of chunks, the conv caches rounded to f16 after every call, the
paged phase's one-token branch (`ssd_decode_step`, so a batched decode
and a one-token prompt chunk compute what the dense-slot decode does),
and rows with kv_len == 0 keeping every state plane verbatim. The SSD
einsums are plain `torch.einsum`s, as the reference's are `jnp.einsum`s
outside any Pallas kernel; every linear is a NestedFP linear
(`layers.apply_linear`).

`mamba2_block` is functional like the reference: it returns the new
state planes, and the caller (`model.run_ssm_stack`) writes them into
its caches in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime, apply_linear, init_linear


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, SSM heads, conv channels) of a config."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def _uniform(gen, shape) -> torch.Tensor:
    """f32 uniform [0, 1) draws from `gen` (a meta device: the shape)."""
    if isinstance(gen, torch.device):
        return torch.empty(shape, dtype=torch.float32, device=gen)
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def init_mamba2(gen, cfg, put=L.keep) -> dict:
    """The block's params, as the reference draws them (its values differ:
    another generator). The input projections are separate matrices (z,
    x, BC, dt), as in the reference; `put` takes each of the five
    linears' weights as drawn."""
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    gn = 2 * s.n_groups * s.d_state
    dev = L.device_of(gen)
    p = {"in_z": init_linear(gen, cfg.d_model, d_inner, put=put),
         "in_x": init_linear(gen, cfg.d_model, d_inner, put=put),
         "in_bc": init_linear(gen, cfg.d_model, gn, put=put),
         "in_dt": init_linear(gen, cfg.d_model, n_heads, put=put),
         "conv_wx": L.randn(gen, (s.conv_width, d_inner))
         .mul_(s.conv_width ** -0.5),
         "conv_bx": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
         "conv_wbc": L.randn(gen, (s.conv_width, gn))
         .mul_(s.conv_width ** -0.5),
         "conv_bbc": torch.zeros((gn,), dtype=torch.float32, device=dev)}
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt = torch.exp(_uniform(gen, (n_heads,)) * (hi - lo) + lo)
    p["dt_bias"] = torch.log(torch.expm1(dt))           # softplus^-1(dt)
    p["A_log"] = torch.log(1.0 + _uniform(gen, (n_heads,)) * 15.0)
    p["D"] = torch.ones((n_heads,), dtype=torch.float32, device=dev)
    p["norm"] = L.init_rms_norm(d_inner, dev)
    p["out_proj"] = init_linear(gen, d_inner, cfg.d_model, put=put)
    return p


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv by width-W shifted adds.

    u: (B, L, C); w: (W, C); state: (B, W-1, C) rolling cache or None.
    Returns (out (B, L, C) in u's dtype, new_state (B, W-1, C) in the
    promoted dtype of u and the state, as the reference's concatenate)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                            dtype=u.dtype, device=u.device)
    dt = torch.promote_types(state.dtype, u.dtype)
    full = torch.cat([state.to(dt), u.to(dt)], dim=1)      # (B, W-1+L, C)
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        out = out + full[:, i:i + u.shape[1]].float() * w[i]
    return F.silu(out + b).to(u.dtype), full[:, -(width - 1):]


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b,l,h,p)  dt: (b,l,h)  A: (h,) (negative)  B,C: (b,l,g,n)  D: (h,)
    initial_state: (b,h,p,n) carried in from an earlier chunk of the same
    sequence (None = zeros, a fresh sequence): a prompt chunk of the
    paged engine resumes the recurrence where the previous one left it.
    Returns y (b,l,h,p) f32 and the final state (b,h,p,n) f32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    rep = h // g                                     # heads per B/C group

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bh = B.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)

    dA = dtc * A                                     # (b,nc,q,h) negative
    cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum

    # intra-chunk: scores_ij = C_i.B_j * exp(cum_i - cum_j) * dt_j, i >= j
    decay = torch.exp(cum[:, :, :, None] - cum[:, :, None])    # (b,nc,q,q,h)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    decay = torch.where(mask[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * decay \
        * dtc[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk summary state: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc              # (b,nc,q,h)
    chunk_states = torch.einsum("bcjhn,bcjhp->bchpn", tail[..., None] * Bh,
                                xc)
    chunk_decay = torch.exp(cum[:, :, -1])                       # (b,nc,h)

    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):                          # emit the state BEFORE c
        prev.append(S)
        S = S * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    S_prev = torch.stack(prev, dim=1)                            # (b,nc,h,p,n)

    # inter-chunk contribution: y_i += exp(cum_i) C_i . S_prev
    y = y + torch.einsum("bcihn,bchpn->bcihp",
                         Ch * torch.exp(cum)[..., None], S_prev)
    y = y + D[None, None, None, :, None] * xc
    return y.reshape(b, nc * chunk, h, p)[:, :l], S


def ssd_decode_step(state, x, dt, A, B, C, D):
    """One-token recurrence. state: (b,h,p,n) f32; x: (b,h,p); dt: (b,h);
    B, C: (b,g,n). Returns (y (b,h,p) in x's dtype, new_state f32)."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.float().repeat_interleave(rep, dim=1)          # (b,h,n)
    Ch = C.float().repeat_interleave(rep, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A)                               # (b,h)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtf, x.float(), Bh)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) + D[None, :, None] * x
    return y.to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as the reference's `jax.nn.softplus` computes it
    (logaddexp with 0; torch's softplus switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_block(rt: Runtime, p: dict, cfg, x: torch.Tensor, *,
                 phase: str, cache: dict | None = None, kv_len=None):
    """x: (B, S, D). cache: this layer's state {"conv_x": (B, W-1, d_inner),
    "conv_bc": (B, W-1, 2 g n), "ssm": (B, H, P, N)}, read only.

    Phases: "train" (a fresh sequence; no state returned, the chunked
    SSD alone), "prefill" (a fresh sequence; the new state is returned),
    "decode" (one token), and "paged", the engine's chunk and decode
    entry: S tokens continue the recurrence from the cache's state (S == 1
    takes `ssd_decode_step`, so a batched decode computes what the
    dense-slot decode does). `kv_len` (B,) of the paged phase keeps the
    old state of every row with kv_len == 0: the engine decodes every
    slot at once, and a row that is mid-prefill or empty must keep its
    state.

    Returns (out (B, S, D) in rt.dtype, new state dict: conv planes f16,
    ssm f32; None in the train phase)."""
    z = apply_linear(rt, p["in_z"], x)
    y, new_cache = _mix(rt, p, cfg, x, phase=phase, cache=cache,
                        kv_len=kv_len)
    y = L.rms_norm(y * F.silu(z.float()).to(rt.dtype), p["norm"],
                   cfg.norm_eps)
    return apply_linear(rt, p["out_proj"], y), new_cache


def _group_planes(bc: torch.Tensor, groups: tuple) -> torch.Tensor:
    """The B (or C) planes (B, S, g, N) that heads reading `groups` (the
    group of each head, in order) take: the groups' slice where the heads
    cover whole groups alike (the SSD's repeat maps them), else one plane
    a head."""
    g0, g1 = groups[0], groups[-1] + 1
    hs, n = len(groups), g1 - g0
    if hs % n == 0 and groups == tuple(g0 + j // (hs // n) for j in range(hs)):
        return bc[:, :, g0:g1]
    return torch.cat([bc[:, :, g:g + 1] for g in groups], dim=2)


def _mix(rt: Runtime, p: dict, cfg, x: torch.Tensor, *, phase: str, cache,
         kv_len, heads: slice | None = None, groups: tuple | None = None):
    """The block between its input projections and its gated norm: the
    x and BC convs and the SSD over `heads` (all of them by default; a
    shard's slice, with in_x, conv_wx / conv_bx and the x conv state
    already cut to those heads' channels, and `groups` the B/C group of
    each). Returns (y (B, S, heads * P) in rt.dtype, new state)."""
    s = cfg.ssm
    b, seq, _ = x.shape
    heads = heads or slice(None)
    xp = apply_linear(rt, p["in_x"], x)
    bc = apply_linear(rt, p["in_bc"], x)
    dt_raw = apply_linear(rt, p["in_dt"], x)[..., heads]
    dt = _softplus(dt_raw.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    D = p["D"][heads]

    cx = cache["conv_x"] if cache is not None else None
    cb = cache["conv_bc"] if cache is not None else None
    xs, new_cx = _causal_conv(xp, p["conv_wx"], p["conv_bx"], cx)
    bc_conv, new_cb = _causal_conv(bc, p["conv_wbc"], p["conv_bbc"], cb)
    gn = s.n_groups * s.d_state
    xh = xs.reshape(b, seq, -1, s.head_dim)
    Bm = bc_conv[..., :gn].reshape(b, seq, s.n_groups, s.d_state)
    Cm = bc_conv[..., gn:].reshape(b, seq, s.n_groups, s.d_state)
    if groups is not None:
        Bm, Cm = _group_planes(Bm, groups), _group_planes(Cm, groups)

    if phase in ("prefill", "train"):
        y, S_new = ssd_chunked(xh, dt, A, Bm, Cm, D, chunk=s.chunk_size)
        if phase == "train":               # no state out
            return y.reshape(b, seq, -1).to(rt.dtype), None
    elif phase == "paged" and seq > 1:    # a prompt chunk resumes the scan
        y, S_new = ssd_chunked(xh, dt, A, Bm, Cm, D, chunk=s.chunk_size,
                               initial_state=cache["ssm"])
    elif phase in ("paged", "decode"):    # one token
        y1, S_new = ssd_decode_step(cache["ssm"].float(), xh[:, 0], dt[:, 0],
                                    A, Bm[:, 0], Cm[:, 0], D)
        y = y1[:, None]
    else:
        raise ValueError(f"unknown phase {phase!r}")
    new_cache = {"conv_x": new_cx.to(torch.float16),
                 "conv_bc": new_cb.to(torch.float16), "ssm": S_new}
    if phase == "paged" and kv_len is not None:
        # inactive rows (kv_len == 0) keep their old state verbatim
        act = kv_len.reshape(-1) > 0
        new_cache = {k: torch.where(act.reshape((b,) + (1,) * (v.dim() - 1)),
                                    v, cache[k].to(v.dtype))
                     for k, v in new_cache.items()}
    return y.reshape(b, seq, -1).to(rt.dtype), new_cache


def mamba2_block_mesh(rt: Runtime, mesh, lay, ps: list, cfg, xs: list, *,
                      phase: str, caches: list, kv_len: list):
    """`mamba2_block` on a mesh: the counterpart of the JAX package's
    block under `param_spec` and `paged_cache_spec`'s "ssm" branch.
    Returns (the output, whole on every shard; each shard's new state).

    Head-parallel (lay.ssm "col"): shard s holds its H / m heads' columns
    of in_z and in_x, their conv_x channels (weights and state) and their
    SSM state; in_bc, in_dt, the BC conv and its state are whole, and the
    shard narrows dt, A, D and dt_bias to its heads and reads the B/C
    groups of its heads (lay.ssm_groups). The gated RMSNorm needs the
    whole d_inner row: each shard's f32 sum of squares over its slice,
    summed in shard order (`Mesh.all_reduce`, one (B, S, 1) value a shard
    where gathering the gated output would move (B, S, d_inner / m)),
    then each normalizes its slice. out_proj is row-parallel (in FP8
    under the whole row's scale, `layers.linear_row_parallel`). "whole"
    runs the block whole on every shard."""
    if lay.ssm == "whole":
        outs = [mamba2_block(rt, p, cfg, x, phase=phase, cache=c, kv_len=k)
                for p, x, c, k in zip(ps, xs, caches, kv_len)]
        return [o for o, _ in outs], [n for _, n in outs]
    hs = lay.ssm_heads
    gated, news = [], []
    for i, (p, x, c, k) in enumerate(zip(ps, xs, caches, kv_len)):
        y, new = _mix(rt, p, cfg, x, phase=phase, cache=c, kv_len=k,
                      heads=slice(i * hs, (i + 1) * hs),
                      groups=lay.ssm_groups[i])
        gated.append(y * F.silu(apply_linear(rt, p["in_z"], x).float())
                     .to(rt.dtype))
        news.append(new)
    width = hs * cfg.ssm.head_dim
    normed = rms_norm_mesh(
        mesh, gated, [p["norm"][i * width:(i + 1) * width]
                      for i, p in enumerate(ps)], cfg.norm_eps)
    return (L.linear_row_parallel(rt, mesh, [p["out_proj"] for p in ps],
                                  normed), news)


def rms_norm_mesh(mesh, xs: list, scales: list, eps: float) -> list:
    """`layers.rms_norm` of rows cut into column slices, one a shard (xs,
    with each slice's `scales`): the f32 sums of squares of the slices,
    summed in shard order (`Mesh.all_reduce`), give the whole row's
    variance; each shard normalizes its slice."""
    sq = mesh.all_reduce([(x.float() * x.float()).sum(-1, keepdim=True)
                          for x in xs])
    width = sum(x.shape[-1] for x in xs)
    return [((x.float() * torch.rsqrt(q / width + eps)) * (1.0 + sc)
             ).to(x.dtype) for x, q, sc in zip(xs, sq, scales)]
