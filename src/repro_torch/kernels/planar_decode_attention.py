"""K4 and K5: single-query GQA decode attention over byte-planar KV.

Ports of two Pallas TPU kernels of `repro/kernels/planar_decode_attention.py`
to CUDA kernels that share one body (`csrc/decode_attention.cuh`):

- K4 `paged_planar_decode_attention` (`csrc/paged_planar_decode_attention.cu`)
  over the serving engine's paged pool, keys found through a block table.
  The static `window` and the traced `window_arr` of the TPU kernel are
  arithmetic-identical, so this port takes one run-time int.
- K5 `planar_decode_attention` (`csrc/planar_decode_attention.cu`) over
  dense per-slot planes (B, Cap, Hkv, D), read in place.

In both, a window of None or <= 0 means global, and D is 64 or 128.
Each row's keys are cut into splits of a fixed number of keys (the C
entry's `*_splits`), one block a split; when a row has more than one
split, a second kernel merges them from an f32 scratch that the wrapper
allocates. One call counts one launch, whatever it runs. CPU tensors take
the plain versions (`ref.paged_planar_decode_attention_ref`,
`ref.planar_decode_attention_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_PAGED_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
               + [ctypes.c_void_p])
_DENSE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
               + [ctypes.c_void_p])
_LIBS = {True: "paged_planar_decode_attention",
         False: "planar_decode_attention"}


def dynamic_smem_bytes(d: int, *, fp8: bool, paged: bool) -> int:
    """Dynamic shared memory of the split kernel for head dim d, as the C
    entry computes it: 0 when the kernel has no instance for d."""
    lib = _LIBS[paged]
    fn = _build.function(lib, f"{lib}_smem", [ctypes.c_int] * 2)
    return int(fn(d, int(fp8)))


def dense_splits(cap: int) -> int:
    """Splits of a dense row of `cap` keys, as the C entry cuts it."""
    fn = _build.function(_LIBS[False], "planar_decode_attention_splits",
                         [ctypes.c_int])
    return int(fn(cap))


def paged_splits(block_size: int, max_blocks: int) -> int:
    """Splits of a row of `max_blocks` table blocks of `block_size` keys,
    as the C entry cuts it."""
    fn = _build.function(_LIBS[True], "paged_planar_decode_attention_splits",
                         [ctypes.c_int] * 2)
    return int(fn(block_size, max_blocks))


def _check(q, planes: dict, *, fp8: bool, paged: bool) -> None:
    """Shapes, types, the 16-byte loads of q and of the planes, and the
    head dims the split kernel has."""
    b, h, d = q.shape
    hkv = planes["k_hi"].shape[2]
    if h % hkv:
        raise ValueError(f"need H % Hkv == 0 (H={h}, Hkv={hkv})")
    _common.expect(q, "q", torch.float32, (b, h, d))
    for name, p in planes.items():
        _common.expect(p, name, torch.uint8, planes["k_hi"].shape)
    for name, p in (("q", q), *planes.items()):
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    if dynamic_smem_bytes(d, fp8=fp8, paged=paged) == 0:
        raise ValueError(f"head dim D={d}: the decode kernels have D = 64 "
                         f"and 128")


def _scratch(b, h, d, ns, device):
    """f32 per-split partials (acc, then m and l) when a row has more than
    one split; otherwise the kernel writes `out` directly."""
    if ns <= 1:
        return None
    return torch.empty(b * h * ns * (d + 2), dtype=torch.float32,
                       device=device)


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
    _check(q, {"k_hi": k_hi, "k_lo": k_lo, "v_hi": v_hi, "v_lo": v_lo},
           fp8=fp8, paged=True)
    _common.expect(tables, "tables", torch.int32, (b, mb))
    _common.expect(lens, "lens", torch.int32, (b,))
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    part = _scratch(b, h, d, paged_splits(bs, mb), q.device)
    fn = _build.function("paged_planar_decode_attention",
                         "paged_planar_decode_attention", _PAGED_ARGS)
    w = 0 if window is None else int(window)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_hi.data_ptr(),
                 0 if fp8 else k_lo.data_ptr(), v_hi.data_ptr(),
                 0 if fp8 else v_lo.data_ptr(), tables.data_ptr(),
                 lens.data_ptr(), out.data_ptr(),
                 0 if part is None else part.data_ptr(), b, h, hkv, d, bs,
                 mb, w, int(fp8), float(d ** -0.5),
                 _common.stream_handle(q.device))
    _build.check(err, "paged_planar_decode_attention")
    paged_planar_decode_attention.launches += 1
    return out


paged_planar_decode_attention.launches = 0


def planar_decode_attention(q, k_hi, k_lo, v_hi, v_lo, lens, *,
                            fp8: bool = False,
                            window: int | None = None) -> torch.Tensor:
    """q (B,H,D) f32; planes (B,Cap,Hkv,D) u8, dense per slot; lens (B,)
    int32 valid keys per row, each >= 1 (decode has written the new
    token) -> (B,H,D) f32. In fp8 mode the lo planes are not read."""
    if not _common.on_cuda(q, k_hi, k_lo, v_hi, v_lo, lens):
        return ref.planar_decode_attention_ref(
            q, k_hi, k_lo, v_hi, v_lo, lens, fp8=fp8, window=window)
    b, h, d = q.shape
    _, cap, hkv, _ = k_hi.shape
    _check(q, {"k_hi": k_hi, "k_lo": k_lo, "v_hi": v_hi, "v_lo": v_lo},
           fp8=fp8, paged=False)
    if k_hi.shape[0] != b:
        raise ValueError(f"planes hold {k_hi.shape[0]} rows, q {b}")
    _common.expect(lens, "lens", torch.int32, (b,))
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    part = _scratch(b, h, d, dense_splits(cap), q.device)
    fn = _build.function("planar_decode_attention", "planar_decode_attention",
                         _DENSE_ARGS)
    w = 0 if window is None else int(window)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_hi.data_ptr(),
                 0 if fp8 else k_lo.data_ptr(), v_hi.data_ptr(),
                 0 if fp8 else v_lo.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), 0 if part is None else part.data_ptr(), b, h,
                 hkv, d, cap, w, int(fp8), float(d ** -0.5),
                 _common.stream_handle(q.device))
    _build.check(err, "planar_decode_attention")
    planar_decode_attention.launches += 1
    return out


planar_decode_attention.launches = 0
