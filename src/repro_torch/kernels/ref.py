"""Plain PyTorch versions of the kernels of the port: the eight that
replace a Pallas kernel, and the per-token quantizer in front of K2.

Each repeats its kernel's arithmetic with f32 accumulation; the GEMMs
sum in f64 and round once to f32 (`_exact_rows_matmul`). A kernel
wrapper takes its plain version for tensors on the CPU (which is how the
tests hold the port against the JAX package), and `chip_smoke.py` holds
each CUDA kernel against its plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import nestedfp as nf
from repro_torch.core import quant

NEG_INF = -1e30


def _exact_rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) @ b (K,N) of f16 or e4m3 values, summed in f64 and rounded
    once to f32. Their products are exact in f64 and so are the sums at
    these K (short of products of subnormals), so a row's value does not
    depend on the other rows: an f32 BLAS picks its summation order from
    M, and an f32 sum then differs by an ulp between a row alone and the
    same row in a batch."""
    return (a.double() @ b.double()).float()


def matmul_f16_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain f16 GEMM: (M,K) @ (K,N) -> (M,N) f32 (f16 inputs, sums
    f32-rounded from f64)."""
    return _exact_rows_matmul(x.to(torch.float16), w.to(torch.float16))


def nestedfp16_matmul_ref(x: torch.Tensor, upper: torch.Tensor,
                          lower: torch.Tensor) -> torch.Tensor:
    """FP16 mode: rebuild the exact f16 weights, then GEMM."""
    return matmul_f16_ref(x, nf.decode(upper, lower))


def nestedfp8_matmul_ref(x_q: torch.Tensor, upper: torch.Tensor,
                         x_scale: torch.Tensor) -> torch.Tensor:
    """FP8 mode: (x_q @ e4m3(upper)) * x_scale * 2^-8, x_scale a scalar
    (per-tensor) or (M,1) (per-token)."""
    acc = _exact_rows_matmul(x_q, nf.fp8_view(upper))
    return acc * x_scale * nf.FP8_DEQUANT_SCALE


def quantize_per_token_ref(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token quantizer: (M,K) x -> (codes (M,K) e4m3, scales (M,1)
    f32), exactly `quant.quantize_act_per_token`."""
    return quant.quantize_act_per_token(x)


def fused_quant_codes(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """The e4m3 codes (as u8) that K7 quantizes x to, elementwise:
    e4m3(clip(x * (448/amax))) — a multiply by the inverse, where
    `quant.quantize_act_per_tensor` divides by amax/448. amax: one f32
    element."""
    amax = amax.to(torch.float32).reshape(())
    # a true division, as the JAX kernel and the CUDA kernel do it:
    # `448.0 / amax` would run as amax.reciprocal() * 448 in PyTorch, one
    # f32 ulp away for about a quarter of the amax values
    inv = torch.full_like(amax, nf.E4M3_MAX) / amax
    xq = torch.clamp(x.float() * inv, -nf.E4M3_MAX, nf.E4M3_MAX)
    return xq.to(torch.float8_e4m3fn).view(torch.uint8)


def nestedfp8_matmul_fused_quant_ref(x: torch.Tensor, upper: torch.Tensor,
                                     amax: torch.Tensor) -> torch.Tensor:
    """FP8 mode with the activation quantized inside the GEMM, as the
    fused kernel does it: x_q = `fused_quant_codes(x, amax)`, then
    (x_q @ e4m3(upper)) * (amax/448) * 2^-8. amax: the per-tensor absmax
    of x, one f32 element."""
    amax = amax.to(torch.float32).reshape(())
    acc = _exact_rows_matmul(nf.fp8_view(fused_quant_codes(x, amax)),
                             nf.fp8_view(upper))
    return acc * (amax / nf.E4M3_MAX) * nf.FP8_DEQUANT_SCALE


def nestedfp_encode_ref(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f16 -> (upper, lower) u8 by the kernel's bit formula, which is
    `nestedfp.encode` (RNE on the 7 dropped bits, carry by integer add)."""
    return nf.encode(w)


def softmax_state(qg: torch.Tensor, dv: int):
    """Initial (m, l, acc) of an online softmax for queries qg
    (B,Hkv,G,Q,D): m, l (B,Hkv,G,Q,1) and acc (B,Hkv,G,Q,dv), all f32."""
    m = torch.full((*qg.shape[:-1], 1), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    return m, torch.zeros_like(m), qg.new_zeros((*qg.shape[:-1], dv))


def tile_update(state, qg, k, v, keep):
    """One key tile of the online softmax shared by the attention kernels'
    plain versions and `layers.attn_core_prefill`: qg (B,Hkv,G,Q,D) scaled
    f32; k/v (B,T,Hkv,·) f32; keep broadcastable to the scores
    (B,Hkv,G,Q,T)."""
    m, l, acc = state
    s = torch.einsum("bhgqd,bthd->bhgqt", qg, k)
    s = torch.where(keep, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum("bhgqt,bthd->bhgqd", p, v)
    return m_new, l, acc


def softmax_out(state) -> torch.Tensor:
    """acc / max(l, 1e-30): (B,Hkv,G,Q,dv)."""
    _, l, acc = state
    return acc / torch.clamp(l, min=1e-30)


def _decode_state(q, hkv):
    b, h, d = q.shape
    qg = q.float().reshape(b, hkv, h // hkv, 1, d) * (d ** -0.5)
    return qg, softmax_state(qg, d)


def _planes_kv(k_hi, k_lo, v_hi, v_lo, fp8: bool):
    if fp8:
        return nf.e5m2_view(k_hi), nf.e5m2_view(v_hi)
    return (nf.join_bytes(k_hi, k_lo).float(),
            nf.join_bytes(v_hi, v_lo).float())


def _window_keep(kpos, lens, window):
    """(B,T) keys kept, shaped to broadcast over the scores."""
    keep = kpos < lens[:, None]
    if window is not None and window > 0:
        keep = keep & (kpos > lens[:, None] - 1 - window)
    return keep[:, None, None, None, :]


def paged_planar_decode_attention_ref(q, k_hi, k_lo, v_hi, v_lo, tables,
                                      lens, *, fp8: bool = False,
                                      window: int | None = None
                                      ) -> torch.Tensor:
    """q (B,H,D); planes (NB,BS,Hkv,D) u8; tables (B,MB); lens (B,);
    window None or <= 0 means global. Online softmax over the table's
    blocks, one block of BS keys at a time -> (B,H,D) f32."""
    b, h, d = q.shape
    bs, hkv = k_hi.shape[1], k_hi.shape[2]
    tables = tables.long()
    lens = lens.to(torch.int64)
    qg, state = _decode_state(q, hkv)
    offs = torch.arange(bs, device=q.device)
    for j in range(tables.shape[1]):
        blk = tables[:, j]
        k, v = _planes_kv(k_hi[blk], k_lo[blk], v_hi[blk], v_lo[blk], fp8)
        keep = _window_keep((j * bs + offs)[None, :], lens, window)
        state = tile_update(state, qg, k, v, keep)
    return softmax_out(state).reshape(b, h, d)


DECODE_TILE = 64      # keys per step of the dense-slot decode kernel


def planar_decode_attention_ref(q, k_hi, k_lo, v_hi, v_lo, lens, *,
                                fp8: bool = False, window: int | None = None
                                ) -> torch.Tensor:
    """q (B,H,D); planes (B,Cap,Hkv,D) u8 dense per slot; lens (B,);
    window None or <= 0 means global. Online softmax over the cache in
    tiles of DECODE_TILE keys -> (B,H,D) f32."""
    b, h, d = q.shape
    cap, hkv = k_hi.shape[1], k_hi.shape[2]
    lens = lens.to(torch.int64)
    qg, state = _decode_state(q, hkv)
    for t0 in range(0, cap, DECODE_TILE):
        sl = slice(t0, min(t0 + DECODE_TILE, cap))
        k, v = _planes_kv(k_hi[:, sl], k_lo[:, sl], v_hi[:, sl], v_lo[:, sl],
                          fp8)
        kpos = torch.arange(sl.start, sl.stop, device=q.device)[None, :]
        state = tile_update(state, qg, k, v, _window_keep(kpos, lens, window))
    return softmax_out(state).reshape(b, h, d)


PREFILL_TILE = 64     # keys per step of the prefill kernel


def flash_prefill_attention_ref(q, k, v) -> torch.Tensor:
    """Causal GQA attention for prefill: q (B,S,H,D), k/v (B,S,Hkv,D) ->
    (B,S,H,D) f32. q is scaled by D^-0.5 in f32, then an online softmax
    runs over the keys in tiles of PREFILL_TILE, masking kpos > qpos."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4) \
        * (d ** -0.5)                                       # (B,Hkv,G,S,D)
    state = softmax_state(qg, d)
    qpos = torch.arange(s, device=q.device)[:, None]
    for t0 in range(0, s, PREFILL_TILE):
        sl = slice(t0, min(t0 + PREFILL_TILE, s))
        kpos = torch.arange(sl.start, sl.stop, device=q.device)[None, :]
        state = tile_update(state, qg, k[:, sl].float(), v[:, sl].float(),
                            kpos <= qpos)
    return softmax_out(state).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
