"""NestedFP dual-precision weight format (paper §4.2), on torch tensors.

An FP16 (E5M10) value with |w| <= 1.75 has its exponent MSB equal to 0 and
splits losslessly into two bytes:

  upper = [S][E3 E2 E1 E0][M1 M2 M3']   -- a *valid* float8_e4m3fn encoding
                                            of w * 2^8 (RNE-rounded mantissa)
  lower = [M3 M4 M5 M6 M7 M8 M9 M10]    -- raw low mantissa bits

M3 is stored twice: rounded in `upper`, raw in `lower`; FP16 reconstruction
subtracts lower's MSB from the upper payload to undo the rounding carry
(branch-free, paper Fig. 6):

  corrected = (upper & 0x7F) - (lower >> 7)
  bits      = (upper >> 7) << 15 | (corrected >> 1) << 8 | lower

Bit manipulation widens to int32 first: torch has no reliable uint16
shifts, and an int16 right shift would sign-extend.
"""

from __future__ import annotations

import dataclasses

import torch

# |w| <= 1.75  <=>  (bits & 0x7FFF) <= 0x3F00  (0x3F00 == f16 1.75)
F16_NESTED_ABS_MAX_BITS = 0x3F00
NESTED_SCALE_LOG2 = 8                # fixed global scale 2^8 (paper §4.2)
FP8_DEQUANT_SCALE = 2.0 ** -NESTED_SCALE_LOG2
E4M3_MAX = 448.0


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f16 bit patterns as int32 in [0, 65535]."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def _bits_to_f16(bits: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of int32 patterns -> f16 (via a signed int16)."""
    bits = bits & 0xFFFF
    signed = bits - ((bits & 0x8000) << 1)
    return signed.to(torch.int16).view(torch.float16)


def is_applicable_values(w: torch.Tensor) -> torch.Tensor:
    """Elementwise: can this f16 value be nested? (|w| <= 1.75, incl. +-0)"""
    return (_f16_bits(w) & 0x7FFF) <= F16_NESTED_ABS_MAX_BITS


_APPLICABLE_CHUNK = 1 << 30


def is_applicable(w: torch.Tensor) -> torch.Tensor:
    """Tensor-level applicability (paper 'exception layer' predicate), over
    the whole tensor, checked in flat chunks of 2^30 weights so the int32
    temporaries stay 4 GiB (a deepseek-v3 expert bank holds 3.76 G)."""
    flat = w.reshape(-1)
    ok = torch.ones((), dtype=torch.bool, device=w.device)
    for i in range(0, flat.numel(), _APPLICABLE_CHUNK):
        ok &= torch.all(is_applicable_values(flat[i:i + _APPLICABLE_CHUNK]))
    return ok


def encode(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split an f16 tensor into (upper, lower) uint8 tensors (Fig 4a).

    RNE on the 7 dropped mantissa bits; the carry propagates into the
    exponent through the integer add. Caller ensures applicability."""
    bits = _f16_bits(w)
    sign = bits >> 15
    mag = bits & 0x7FFF
    keep = mag >> 7                       # [0 E3..E0 M1 M2 M3], bit7 = 0
    low = mag & 0x7F                      # dropped mantissa bits M4..M10
    round_up = (low > 0x40) | ((low == 0x40) & ((keep & 1) == 1))
    keep = keep + round_up.to(torch.int32)
    upper = ((sign << 7) | (keep & 0x7F)).to(torch.uint8)
    lower = (mag & 0xFF).to(torch.uint8)
    return upper, lower


def decode(upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """Lossless FP16 reconstruction (Fig 4b / Fig 6), branch-free, on
    bytes: the high byte is sign | ((upper & 0x7F) - (lower >> 7)) >> 1,
    the low byte is `lower`, laid side by side (little-endian) and read
    as f16. The subtraction never underflows for what `encode` emits;
    for any other pair the high byte is 0xFF, as the int32 form of the
    same formula gives."""
    dropped = lower >> 7
    payload = upper & 0x7F
    hi = ((upper & 0x80) | ((payload - dropped) >> 1)
          | ((payload < dropped).to(torch.uint8) << 7))
    return torch.stack((lower, hi), dim=-1).view(torch.float16).squeeze(-1)


def fp8_view(upper: torch.Tensor) -> torch.Tensor:
    """Reinterpret the upper tensor as float8_e4m3fn == w * 2^8 (RNE)."""
    return upper.view(torch.float8_e4m3fn)


def fp8_dequant(upper: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Materialize the FP8-mode weight values (w rounded to E4M3 grid)."""
    return fp8_view(upper).to(dtype).mul_(FP8_DEQUANT_SCALE)


@dataclasses.dataclass
class NestedTensor:
    """A linear-layer weight stored once, readable at two precisions.

    Exactly one of the two layouts is live:
      applicable:    upper/lower uint8 tensors (together: the f16 bytes)
      exception:     raw f16 tensor (paper §4.2 'Handling Exception Layers')
    Both layouts occupy exactly 2 bytes/weight."""

    upper: torch.Tensor | None
    lower: torch.Tensor | None
    raw: torch.Tensor | None          # f16, only for exception tensors

    @classmethod
    def from_f16(cls, w: torch.Tensor, force_exception: bool = False
                 ) -> "NestedTensor":
        """Offline pre-processing; decides applicability on the host, then
        encodes through K8 (`ops.encode`: the CUDA kernel for a tensor on
        the card, `encode` above for one on the CPU)."""
        # imported here: the kernel modules import this one
        from repro_torch.kernels import ops
        w = w.to(torch.float16).contiguous()
        if not force_exception and bool(is_applicable(w)):
            upper, lower = ops.encode(w)
            return cls(upper=upper, lower=lower, raw=None)
        return cls(upper=None, lower=None, raw=w)

    @property
    def is_exception(self) -> bool:
        return self.raw is not None

    @property
    def shape(self):
        src = self.raw if self.raw is not None else self.upper
        return tuple(src.shape)

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.upper, self.lower, self.raw) if t is not None]

    def to(self, device) -> "NestedTensor":
        mv = (lambda t: None if t is None else t.to(device))
        return NestedTensor(mv(self.upper), mv(self.lower), mv(self.raw))

    def read_f16(self) -> torch.Tensor:
        """FP16-mode weights (bit-exact original)."""
        if self.is_exception:
            return self.raw
        return decode(self.upper, self.lower)

    def read_fp8(self) -> tuple[torch.Tensor, float]:
        """FP8-mode weights: (e4m3 tensor, scalar dequant scale). Exception
        tensors have no 8-bit form and run in f16 in both modes."""
        if self.is_exception:
            raise ValueError("exception tensor has no FP8 form; use read_f16()")
        return fp8_view(self.upper), FP8_DEQUANT_SCALE


# ---------------------------------------------------------------------------
# Power-of-two per-channel scaling (the JAX package's beyond-paper format).
# Multiplying an f16 value by 2^k only shifts its exponent, bit-exact while
# the result stays normal and in range, so per-channel exponents k_c give
# each output channel the full E4M3 resolution and rescue channels with
# absmax > 1.75, while FP16 reads stay lossless. A channel whose shift
# would be inexact (a subnormal shifted down) keeps k_c = 0. The FP8-mode
# dequant scale becomes the vector 2^-8 * 2^-k. Plain tensor functions:
# no kernel reads pow2 planes (none does in the JAX package either).
# ---------------------------------------------------------------------------

def _scaled(w: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(w * 2^k) in f32, rounded to f16; k broadcasts over the channels on
    w's last axis."""
    scale = torch.exp2(k.to(torch.float32)).to(torch.float16)
    return (w.to(torch.float32) * scale.to(torch.float32)).to(torch.float16)


def _exact_shift(w: torch.Tensor, k: torch.Tensor, ws: torch.Tensor
                 ) -> torch.Tensor:
    """Elementwise: does ws / 2^k give back w's f16 bits?"""
    scale = torch.exp2(k.to(torch.float32)).to(torch.float16)
    back = (ws.to(torch.float32) / scale.to(torch.float32)).to(torch.float16)
    return _f16_bits(back) == _f16_bits(w)


def pow2_channel_exponents(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel exponent k so that absmax_c * 2^k <= 1.75, k in
    [-14, 14], int32. w: (..., N) with channels on the last axis."""
    lead = tuple(range(w.dim() - 1))
    absmax = w.to(torch.float32).abs().amax(dim=lead) if lead else \
        w.to(torch.float32).abs()
    k = torch.floor(torch.log2(1.75 / torch.clamp(absmax, min=1e-30)))
    return torch.clamp(k, -14, 14).to(torch.int32)


def encode_pow2(w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(upper, lower, k): the channel-scaled nested encoding. FP16 reads
    stay bit-exact: a channel whose shift is inexact, or still out of
    range, falls back to k_c = 0; the caller checks the tensor's
    applicability on the scaled values."""
    w = w.to(torch.float16)
    lead = tuple(range(w.dim() - 1))
    k = pow2_channel_exponents(w)
    ws = _scaled(w, k)
    ok = _exact_shift(w, k, ws) & is_applicable_values(ws)
    ok = ok.all(dim=lead) if lead else ok
    k = torch.where(ok, k, torch.zeros_like(k))
    upper, lower = encode(_scaled(w, k))
    return upper, lower, k


def decode_pow2(upper: torch.Tensor, lower: torch.Tensor, k: torch.Tensor
                ) -> torch.Tensor:
    """Bit-exact inverse of encode_pow2 (for applicable channels)."""
    inv = torch.exp2(-k.to(torch.float32))
    return (decode(upper, lower).to(torch.float32) * inv).to(torch.float16)


def fp8_dequant_scale_pow2(k: torch.Tensor) -> torch.Tensor:
    """Per-channel FP8 dequant vector: 2^-8 * 2^-k, f32."""
    return (FP8_DEQUANT_SCALE * torch.exp2(-k.to(torch.float32))
            ).to(torch.float32)


def is_applicable_pow2(w: torch.Tensor) -> torch.Tensor:
    """Tensor applicability under per-channel pow2 scaling (a superset of
    the paper's fixed-scale applicability)."""
    w = w.to(torch.float16)
    k = pow2_channel_exponents(w)
    ws = _scaled(w, k)
    return torch.all(_exact_shift(w, k, ws)) & is_applicable(ws)


def split_stats(w: torch.Tensor) -> dict:
    """Applicability diagnostics for a weight tensor (paper Table 3)."""
    w = w.to(torch.float16)
    elem_ok = is_applicable_values(w)
    return {
        "numel": int(w.numel()),
        # the mean as XLA takes it: the f32 sum times the f32 1/n
        "applicable_fraction": float(
            elem_ok.to(torch.float32).sum()
            * torch.tensor(1.0 / max(w.numel(), 1), dtype=torch.float32)),
        "tensor_applicable": bool(elem_ok.all()),
        "abs_max": float(w.to(torch.float32).abs().max()),
    }


# ---------------------------------------------------------------------------
# Byte-planar f16 ("NestedKV"): any f16 tensor splits into its high and low
# bytes. The high byte [S EEEEE MM] is exactly a float8_e5m2 encoding of
# the truncated value, so FP8-mode attention reads only the high plane.
# ---------------------------------------------------------------------------

def split_bytes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f16 -> (hi, lo) uint8 planes. hi is a valid float8_e5m2 tensor."""
    bits = _f16_bits(x)
    return (bits >> 8).to(torch.uint8), (bits & 0xFF).to(torch.uint8)


def join_bytes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Lossless inverse of split_bytes."""
    return _bits_to_f16((hi.to(torch.int32) << 8) | lo.to(torch.int32))


def e5m2_view(hi: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Read the high plane alone as float8_e5m2 (truncated-f16 values)."""
    return hi.view(torch.float8_e5m2).to(dtype)
