"""K8: offline NestedFP encode, f16 weights -> (upper, lower) byte planes.

Port of `repro/kernels/nestedfp_encode.py::nestedfp_encode` (a Pallas TPU
kernel) to the CUDA kernel in `csrc/nestedfp_encode.cu`. `to_serving` on
the card nests every applicable weight through it. Any shape is taken:
the kernel works on the flat tensor and masks the ragged tail (the JAX
wrapper required block multiples). CPU tensors take the plain version
(`ref.nestedfp_encode_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _common, ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


def nestedfp_encode(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w f16 (any shape, contiguous) -> (upper, lower) u8 of w's shape.
    The caller has checked applicability (|w| <= 1.75)."""
    if not _common.on_cuda(w):
        return ref.nestedfp_encode_ref(w)
    _common.expect(w, "w", torch.float16, w.shape)
    upper = torch.empty(w.shape, dtype=torch.uint8, device=w.device)
    lower = torch.empty(w.shape, dtype=torch.uint8, device=w.device)
    fn = _build.function("nestedfp_encode", "nestedfp_encode", _ARGS)
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), upper.data_ptr(), lower.data_ptr(), w.numel(),
                 _common.stream_handle(w.device))
    _build.check(err, "nestedfp_encode")
    nestedfp_encode.launches += 1
    return upper, lower


nestedfp_encode.launches = 0
