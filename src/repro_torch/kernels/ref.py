"""Plain PyTorch versions of the four kernels of the serving path.

Each repeats its kernel's arithmetic with f32 accumulation. A kernel
wrapper takes its plain version for tensors on the CPU (which is how the
tests hold the port against the JAX package), and `chip_smoke.py` holds
each CUDA kernel against its plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import nestedfp as nf

NEG_INF = -1e30


def matmul_f16_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain f16 GEMM: (M,K) @ (K,N) -> (M,N) f32 (f16 inputs, f32 sums)."""
    return x.to(torch.float16).float() @ w.to(torch.float16).float()


def nestedfp16_matmul_ref(x: torch.Tensor, upper: torch.Tensor,
                          lower: torch.Tensor) -> torch.Tensor:
    """FP16 mode: rebuild the exact f16 weights, then GEMM."""
    return matmul_f16_ref(x, nf.decode(upper, lower))


def nestedfp8_matmul_ref(x_q: torch.Tensor, upper: torch.Tensor,
                         x_scale: torch.Tensor) -> torch.Tensor:
    """FP8 mode: (x_q @ e4m3(upper)) * x_scale * 2^-8, x_scale a scalar
    (per-tensor) or (M,1) (per-token)."""
    acc = x_q.float() @ nf.fp8_view(upper).float()
    return acc * x_scale * nf.FP8_DEQUANT_SCALE


def paged_planar_decode_attention_ref(q, k_hi, k_lo, v_hi, v_lo, tables,
                                      lens, *, fp8: bool = False,
                                      window: int | None = None
                                      ) -> torch.Tensor:
    """q (B,H,D); planes (NB,BS,Hkv,D) u8; tables (B,MB); lens (B,);
    window None or <= 0 means global. Online softmax over the table's
    blocks, one block of BS keys at a time -> (B,H,D) f32."""
    b, h, d = q.shape
    bs, hkv = k_hi.shape[1], k_hi.shape[2]
    g = h // hkv
    mb = tables.shape[1]
    tables = tables.long()
    lens = lens.to(torch.int64)
    qg = q.float().reshape(b, hkv, g, d) * (d ** -0.5)
    m = torch.full((b, hkv, g, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(mb):
        blk = tables[:, j]
        if fp8:
            k = nf.e5m2_view(k_hi[blk])                  # (B,BS,Hkv,D)
            v = nf.e5m2_view(v_hi[blk])
        else:
            k = nf.join_bytes(k_hi[blk], k_lo[blk]).float()
            v = nf.join_bytes(v_hi[blk], v_lo[blk]).float()
        s = torch.einsum("bhgd,bthd->bhgt", qg, k)
        kpos = (j * bs + offs)[None, :]                  # (1,BS)
        keep = kpos < lens[:, None]
        if window is not None and window > 0:
            keep = keep & (kpos > lens[:, None] - 1 - window)
        s = torch.where(keep[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgt,bthd->bhgd", p, v)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).reshape(b, h, d)
