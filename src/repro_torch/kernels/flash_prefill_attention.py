"""K6: causal GQA flash attention for prefill.

Port of `repro/kernels/flash_prefill_attention.py::flash_prefill_attention`
(a Pallas TPU kernel) to the CUDA kernel in
`csrc/flash_prefill_attention.cu`. The input type alone picks the body:
f16 and bf16 run on the tensor cores (mma.sync, cp.async), f32 on f32
FMAs; both count as launches of this kernel. Both bodies have instances
for head dims 64, 80 (zamba2-2.7b's shared attention), 96 (phi-3-vision),
128 and 256 (gemma3-1b's global layers) and take any
GQA group G = H / Hkv up to 64 (deepseek-coder-33b's G = 7 too: a block's
rows past G * (64 // G) are dead, masked on load and never stored); on
the card any other shape raises (`check_shape`). Any S is taken: the
kernel masks the ragged last tiles itself (the JAX wrapper required S to
divide its blocks). CPU tensors take the plain version
(`ref.flash_prefill_attention_ref`), which takes any shape.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
         + [ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ROWS = 64        # query rows a block of the kernel: G * (64 // G) live
HEAD_DIMS = (64, 80, 96, 128, 256)   # the head dims with an instance


def check_shape(h: int, hkv: int, d: int) -> None:
    """The kernel's shape rule: D one of HEAD_DIMS, and G = H / Hkv a
    whole number no larger than the 64 query rows of a block. Raises
    ValueError otherwise."""
    if (d not in HEAD_DIMS or min(h, hkv) <= 0 or h % hkv
            or h // hkv > _ROWS):
        raise ValueError(f"need D in {HEAD_DIMS} and H/Hkv a whole number "
                         f"up to {_ROWS} (H={h}, Hkv={hkv}, D={d})")


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,Hkv,D), one of f32/f16/bf16 for all three ->
    (B,S,H,D) f32, causal, q scaled by D^-0.5 in f32."""
    if not _common.on_cuda(q, k, v):
        return ref.flash_prefill_attention_ref(q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected f32, f16 or bf16")
    check_shape(h, hkv, d)
    _common.expect(q, "q", q.dtype, (b, s, h, d))
    _common.expect(k, "k", q.dtype, (b, s, hkv, d))
    _common.expect(v, "v", q.dtype, (b, s, hkv, d))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_prefill_attention", "flash_prefill_attention",
                         _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, s, h, hkv, d, float(d ** -0.5),
                 _common.stream_handle(q.device))
    _build.check(err, "flash_prefill_attention")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
