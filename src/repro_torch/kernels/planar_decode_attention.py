"""K4: single-query GQA decode attention over the paged NestedKV pool.

Port of `repro/kernels/planar_decode_attention.py::
paged_planar_decode_attention` (a Pallas TPU kernel) to the CUDA kernel
in `csrc/paged_planar_decode_attention.cu`. The static `window` and the
traced `window_arr` of the TPU kernel are arithmetic-identical, so this
port takes one run-time int (None or <= 0 means global). CPU tensors take
the plain version (`ref.paged_planar_decode_attention_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_void_p])
_SMEM_LIMIT = 227 * 1024


def paged_planar_decode_attention(q, k_hi, k_lo, v_hi, v_lo, tables, lens, *,
                                  fp8: bool = False,
                                  window: int | None = None) -> torch.Tensor:
    """q (B,H,D) f32; planes (NB,BS,Hkv,D) u8; tables (B,MB) int32 block
    ids in logical order (holes point at the trash block); lens (B,) int32
    valid keys per row -> (B,H,D) f32. In fp8 mode the lo planes are not
    read. Rows with lens == 0 return zeros."""
    if not _common.on_cuda(q, k_hi, k_lo, v_hi, v_lo, tables, lens):
        return ref.paged_planar_decode_attention_ref(
            q, k_hi, k_lo, v_hi, v_lo, tables, lens, fp8=fp8, window=window)
    b, h, d = q.shape
    nb, bs, hkv, _ = k_hi.shape
    mb = tables.shape[1]
    if h % hkv or d % 4:
        raise ValueError(f"need H % Hkv == 0 and D % 4 == 0 (H={h}, "
                         f"Hkv={hkv}, D={d})")
    _common.expect(q, "q", torch.float32, (b, h, d))
    for name, p in (("k_hi", k_hi), ("k_lo", k_lo), ("v_hi", v_hi),
                    ("v_lo", v_lo)):
        _common.expect(p, name, torch.uint8, (nb, bs, hkv, d))
    _common.expect(tables, "tables", torch.int32, (b, mb))
    _common.expect(lens, "lens", torch.int32, (b,))
    g = h // hkv
    smem = 4 * (2 * g * d + 2 * bs * d + g * bs + 3 * g)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={g}, D={d}, BS={bs} need {smem} B of shared "
                         f"memory, above {_SMEM_LIMIT}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    fn = _build.function("paged_planar_decode_attention",
                         "paged_planar_decode_attention", _ARGS)
    w = 0 if window is None else int(window)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_hi.data_ptr(),
                 0 if fp8 else k_lo.data_ptr(), v_hi.data_ptr(),
                 0 if fp8 else v_lo.data_ptr(), tables.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), b, h, hkv, d, bs, mb, w,
                 int(fp8), float(d ** -0.5), _common.stream_handle(q.device))
    _build.check(err, "paged_planar_decode_attention")
    paged_planar_decode_attention.launches += 1
    return out


paged_planar_decode_attention.launches = 0
