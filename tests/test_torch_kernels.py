"""The kernels of the PyTorch port, against the JAX package's Pallas
kernels run in interpret mode on the CPU (the eight that replace one),
and the per-token quantizer against the JAX package's function.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions to the Pallas kernels on seeded inputs.
The CUDA kernels themselves are held to the plain versions on the card
by tests/test_torch_gpu.py (and by chip_smoke.py)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import nestedfp as jnf  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.linear import NestedLinearParams as JNLP  # noqa: E402
from repro.core.linear import nested_linear as j_nested_linear  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_prefill_attention import (  # noqa: E402
    flash_prefill_attention as j_flash_prefill)
from repro.kernels.nestedfp8_matmul import (  # noqa: E402
    nestedfp8_matmul_fused_quant as j_fused_quant)
from repro.kernels.nestedfp_encode import nestedfp_encode as j_encode  # noqa: E402
from repro.kernels.planar_decode_attention import (  # noqa: E402
    paged_planar_decode_attention as j_paged_attn)
from repro.kernels.planar_decode_attention import (  # noqa: E402
    planar_decode_attention as j_dense_attn)
from repro.models.layers import attn_core_prefill as j_core_prefill  # noqa: E402
from repro_torch.core import nestedfp as tnf  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.linear import NestedLinearParams as TNLP  # noqa: E402
from repro_torch.core.linear import nested_linear as t_nested_linear  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

GEMM_TOL = dict(rtol=1e-5, atol=1e-4)
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK = (64, 128, 128)
GEMM_SHAPES = [(16, 256, 128), (100, 200, 90), (1, 300, 77), (33, 64, 128)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _gemm_inputs(seed, m, k, n, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, lead + (m, k)).astype(np.float32)
    w = rng.uniform(-1.6, 1.6, (k, n)).astype(np.float16)
    return x, w


class TestNestedFP16:
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    def test_plain_matches_pallas(self, shape):
        x, w = _gemm_inputs(0, *shape)
        ju, jl = jnf.encode(jnp.asarray(w))
        want = jops.matmul_nested_f16(jnp.asarray(x, jnp.float16), ju, jl,
                                      backend="pallas_interpret", block=BLOCK)
        tu, tl = tnf.encode(_t(w))
        got = tops.matmul_nested_f16(_t(x).half(), tu, tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)

    def test_leading_dims_flatten(self):
        x, w = _gemm_inputs(1, 5, 256, 128, lead=(2,))
        ju, jl = jnf.encode(jnp.asarray(w))
        want = jops.matmul_nested_f16(jnp.asarray(x, jnp.float16), ju, jl,
                                      backend="pallas_interpret", block=BLOCK)
        got = tops.matmul_nested_f16(_t(x).half(), *tnf.encode(_t(w)))
        assert got.shape == (2, 5, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)

    def test_equals_plain_f16_on_original_weights(self):
        x, w = _gemm_inputs(2, 24, 128, 64)
        a = tops.matmul_nested_f16(_t(x).half(), *tnf.encode(_t(w)))
        b = tops.matmul_f16(_t(x).half(), _t(w))
        np.testing.assert_array_equal(a.numpy(), b.numpy())


class TestNestedFP8:
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    @pytest.mark.parametrize("act_quant", ["per_tensor", "per_token"])
    def test_plain_matches_pallas(self, shape, act_quant):
        x, w = _gemm_inputs(3, *shape)
        jq_fn = getattr(jquant, f"quantize_act_{act_quant}")
        tq_fn = getattr(tquant, f"quantize_act_{act_quant}")
        jxq, js = jq_fn(jnp.asarray(x))
        txq, ts = tq_fn(_t(x))
        if act_quant == "per_token":
            js, ts = js.reshape(-1, 1), ts.reshape(-1, 1)
        ju, _ = jnf.encode(jnp.asarray(w))
        tu, _ = tnf.encode(_t(w))
        want = jops.matmul_nested_fp8(jxq, ju, js, backend="pallas_interpret",
                                      block=BLOCK)
        got = tops.matmul_nested_fp8(txq, tu, ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)

    def test_per_token_rows_independent_of_batch(self):
        x, w = _gemm_inputs(4, 12, 256, 64)
        tu, _ = tnf.encode(_t(w))
        xq, s = tquant.quantize_act_per_token(_t(x))
        full = tops.matmul_nested_fp8(xq, tu, s)
        one = tops.matmul_nested_fp8(xq[3:4], tu, s[3:4])
        np.testing.assert_array_equal(full[3:4].numpy(), one.numpy())

    @staticmethod
    def _mma_body(xq, upper, scale):
        """K2's CUDA arithmetic (the mma body of csrc/fp8_mma_gemm.cuh) in
        plain torch: each k32 product of the e4m3 values (mma.sync
        m16n8k32) added to f32 accumulators, k from 0 upwards, then the
        RowScale epilogue (acc * s) * 2^-8."""
        codes = xq.float()
        w = tnf.fp8_view(upper).float()
        total = torch.zeros((codes.shape[0], w.shape[1]))
        for k in range(0, codes.shape[1], 32):
            total = total + codes[:, k:k + 32] @ w[k:k + 32]
        return total * scale * 2.0 ** -8

    @pytest.mark.parametrize("act_quant", ["per_tensor", "per_token"])
    def test_mma_arithmetic_matches_pallas(self, act_quant):
        x, w = _gemm_inputs(28, 40, 512, 128)
        jxq, js = getattr(jquant, f"quantize_act_{act_quant}")(jnp.asarray(x))
        txq, ts = getattr(tquant, f"quantize_act_{act_quant}")(_t(x))
        if act_quant == "per_token":
            js, ts = js.reshape(-1, 1), ts.reshape(-1, 1)
        ju, _ = jnf.encode(jnp.asarray(w))
        want = jops.matmul_nested_fp8(jxq, ju, js, backend="pallas_interpret",
                                      block=BLOCK)
        got = self._mma_body(txq, tnf.encode(_t(w))[0], ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)

    def test_row_epilogue_order_equals_jax(self):
        """K2's epilogue applies a row's scale inside the kernel as
        (acc * s) * 2^-8; the JAX package runs its Pallas kernel with a
        unit scale, (acc * 1 * 2^-8), and multiplies by s outside
        (repro/kernels/ops.py::matmul_nested_fp8). Multiplying by 2^-8 is
        exact for normal values, so the two agree bitwise over normal f32
        ranges of sums and scales."""
        rng = np.random.default_rng(29)
        n = 200_000
        acc = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-60, 60, n)
               ).astype(np.float32)
        s = (rng.uniform(0.5, 1, n) * 2.0 ** rng.integers(-40, 10, n)
             ).astype(np.float32)
        ours = (_t(acc) * _t(s)) * 2.0 ** -8
        ja = jnp.asarray(acc)
        jax_order = np.asarray((ja * jnp.float32(1.0) * jnp.float32(2.0 ** -8))
                               * jnp.asarray(s))
        np.testing.assert_array_equal(ours.numpy(), jax_order)
        assert np.all(np.abs(jax_order[jax_order != 0])
                      >= np.finfo(np.float32).tiny)


class TestPerTokenQuant:
    """The per-token quantizer in front of K2: its plain version
    (`ref.quantize_per_token_ref`, which is `quant.quantize_act_per_token`)
    bitwise the JAX package's `quantize_act_per_token`, codes and scales;
    the CUDA kernel is held bitwise to the plain version on the card."""

    @staticmethod
    def _rows(dtype):
        """Rows of f32 values representable in `dtype`: random rows over
        many magnitudes, an all-zero row, rows whose largest |x| sits at
        +amax and at -amax exactly, and a row of values next to e4m3
        midpoints (x / scale one f32 ulp either side of a midpoint)."""
        rng = np.random.default_rng(30)
        x = (rng.standard_normal((12, 160))
             * np.exp(rng.uniform(-6, 6, (12, 1)))).astype(np.float32)
        x[3] = 0.0
        x[4, 7] = np.abs(x[4]).max() * 2          # +amax
        x[5, 9] = -np.abs(x[5]).max() * 2         # -amax
        x[6, :4] = [-0.0, 0.0, 1e-30, -1e-30]     # signed zeros, underflow
        amax = np.float32(3.0)
        scale = amax / np.float32(448.0)
        codes = np.arange(256, dtype=np.uint8)
        vals = jnp.asarray(codes).view(jnp.float8_e4m3fn).astype(jnp.float32)
        vals = np.unique(np.abs(np.asarray(vals)[np.isfinite(vals)]))
        mids = ((vals[:-1] + vals[1:]) / 2).astype(np.float32)[::4][:52]
        near = np.concatenate([np.nextafter(mids * scale, np.float32(0)),
                               mids * scale,
                               np.nextafter(mids * scale, np.float32(9))])
        x[7] = 0.0
        x[7, 0] = amax
        x[7, 1:1 + near.size] = near[:159] * np.where(
            np.arange(min(near.size, 159)) % 2, 1, -1)
        t = torch.from_numpy(x).to(dtype)
        return t.float().numpy(), t

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    def test_plain_matches_jax_bitwise(self, dtype):
        x32, tx = self._rows(getattr(torch, dtype))
        jx = jnp.asarray(x32).astype(getattr(jnp, dtype))
        jq, js = jquant.quantize_act_per_token(jx)
        tq, ts = tref.quantize_per_token_ref(tx)
        assert tq.dtype == torch.float8_e4m3fn and ts.shape == (12, 1)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
        assert ts[3].item() == np.float32(1e-12) / np.float32(448)
        assert not tq[3].view(torch.uint8).any()
        assert tq[4, 7].float().item() == 448.0
        assert tq[5, 9].float().item() == -448.0

    def test_scale_is_an_ieee_division(self):
        """amax / 448 divides: over 20000 amax values about half differ
        from amax * (1/448) by an ulp, and the scales equal numpy's f32
        division and JAX's."""
        rng = np.random.default_rng(31)
        amax = (rng.uniform(1, 2, 20000) * 2.0 ** rng.integers(-30, 30, 20000)
                ).astype(np.float32)
        x = np.zeros((amax.size, 3), np.float32)
        x[:, 1] = -amax
        _, ts = tquant.quantize_act_per_token(_t(x))
        want = amax / np.float32(448)
        np.testing.assert_array_equal(ts.numpy()[:, 0], want)
        _, js = jquant.quantize_act_per_token(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(js)[:, 0], want)
        assert (want != amax * (np.float32(1) / np.float32(448))).mean() > 0.3

    def test_ops_flattens_leading_dims_on_the_cpu(self):
        before = tops.all_launch_counters()
        x = _t(_gemm_inputs(32, 5, 96, 1, lead=(2,))[0]).bfloat16()
        q, s = tops.quantize_act_per_token(x)
        assert q.shape == (2, 5, 96) and s.shape == (2, 5, 1)
        wq, ws = tquant.quantize_act_per_token(x)
        assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
        assert torch.equal(s, ws)
        assert tops.all_launch_counters() == before


class TestF16:
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    def test_plain_matches_pallas(self, shape):
        x, w = _gemm_inputs(5, *shape)
        w[0, 0] = 3.0                       # an exception-tensor weight
        want = jops.matmul_f16(jnp.asarray(x, jnp.float16), jnp.asarray(w),
                               backend="pallas_interpret", block=BLOCK)
        got = tops.matmul_f16(_t(x).half(), _t(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


class TestPlainGemmRows:
    """Each plain GEMM gives a row the same bits alone as inside a batch
    of any M, on any CPU: they sum in f64 and round once to f32, where an
    f32 BLAS picks its summation order from M (one f32 ulp apart)."""

    K, N = 4096, 64

    @staticmethod
    def _gemms(x, w):
        u, lo = tnf.encode(w)
        amax = tquant.absmax(x)
        xq, s = tquant.quantize_act_per_token(x)
        return {
            "f16": lambda r: tref.matmul_f16_ref(x[r].half(), w),
            "nested_f16": lambda r: tref.nestedfp16_matmul_ref(x[r].half(),
                                                               u, lo),
            "nested_fp8": lambda r: tref.nestedfp8_matmul_ref(xq[r], u, s[r]),
            "fused_quant": lambda r: tref.nestedfp8_matmul_fused_quant_ref(
                x[r], u, amax),
        }

    @pytest.mark.parametrize("m", [1, 3, 12, 19, 64])
    @pytest.mark.parametrize("gemm", ["f16", "nested_f16", "nested_fp8",
                                      "fused_quant"])
    def test_rows_bitwise_independent_of_m(self, gemm, m):
        x, w = _gemm_inputs(29, 64, self.K, self.N)
        fn = self._gemms(_t(x), _t(w))[gemm]
        batch = fn(slice(0, m))
        for r in range(m):
            assert torch.equal(batch[r:r + 1], fn(slice(r, r + 1))), r


def _paged_inputs(seed, b=3, h=4, hkv=2, d=64, bs=16, mb=4):
    rng = np.random.default_rng(seed)
    nb = 1 + b * mb
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = perm.reshape(b, mb).copy()
    tables[2, :2] = tables[0, :2]           # COW-shared prefix blocks
    lens = np.asarray([50, 0, 37][:b], np.int32)
    for r in range(b):
        tables[r, -(-int(lens[r]) // bs):] = 0   # holes -> trash block
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kv = rng.normal(size=(2, nb, bs, hkv, d)).astype(np.float16)
    planes = [np.asarray(p) for p in (*jnf.split_bytes(jnp.asarray(kv[0])),
                                       *jnf.split_bytes(jnp.asarray(kv[1])))]
    return q, planes, tables, lens


class TestPagedPlanarDecodeAttention:
    @pytest.mark.parametrize("fp8", [False, True])
    @pytest.mark.parametrize("window", [None, 0, -1, 5, 19])
    def test_plain_matches_pallas(self, fp8, window):
        q, planes, tables, lens = _paged_inputs(6)
        jargs = dict(fp8=fp8, interpret=True)
        if window is not None and window > 0:
            jargs["window"] = window
        elif window is not None:
            jargs["window_arr"] = jnp.asarray([window], jnp.int32)
        want = np.asarray(j_paged_attn(
            jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(tables),
            jnp.asarray(lens), **jargs))
        tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
        got = tops.paged_decode_attention(_t(q), tp, _t(tables), _t(lens),
                                          fp8=fp8, window=window).numpy()
        live = lens > 0
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[live], want[live], **ATTN_TOL)

    def test_gqa_head_mapping(self):
        # q head i reads kv head i // G: permuting kv heads moves outputs
        q, planes, tables, lens = _paged_inputs(7, h=4, hkv=2)
        tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
        out = tops.paged_decode_attention(_t(q), tp, _t(tables), _t(lens),
                                          fp8=False)
        swapped = {k: v.flip(2).contiguous() for k, v in tp.items()}
        q_sw = _t(q).reshape(3, 2, 2, 64).flip(1).reshape(3, 4, 64)
        out_sw = tops.paged_decode_attention(q_sw.contiguous(), swapped,
                                             _t(tables), _t(lens), fp8=False)
        np.testing.assert_allclose(
            out_sw.reshape(3, 2, 2, 64).flip(1).reshape(3, 4, 64).numpy(),
            out.numpy(), rtol=1e-6, atol=1e-6)


def _dense_inputs(seed, b=3, h=4, hkv=2, d=64, cap=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kv = rng.normal(size=(2, b, cap, hkv, d)).astype(np.float16)
    planes = [np.asarray(p) for p in (*jnf.split_bytes(jnp.asarray(kv[0])),
                                       *jnf.split_bytes(jnp.asarray(kv[1])))]
    lens = np.asarray([1, 37, 64][:b], np.int32)
    return q, planes, lens


class TestPlanarDecodeAttention:
    """K5: dense per-slot planes (B, Cap, Hkv, D), ragged lens >= 1."""

    @pytest.mark.parametrize("fp8", [False, True])
    @pytest.mark.parametrize("window", [None, 7])
    def test_plain_matches_pallas(self, fp8, window):
        q, planes, lens = _dense_inputs(13)
        want = np.asarray(j_dense_attn(
            jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(lens),
            fp8=fp8, block_c=16, window=window, interpret=True))
        tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
        got = tops.planar_decode_attention(_t(q), tp, _t(lens), fp8=fp8,
                                           window=window).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    def test_equals_paged_over_an_identity_table(self):
        """K5 and K4 share their math: dense row b is paged blocks
        b*MB .. b*MB + MB - 1."""
        q, planes, lens = _dense_inputs(14, cap=64)
        tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
        dense = tops.planar_decode_attention(_t(q), tp, _t(lens), fp8=False)
        pool = {k: v.reshape(-1, 16, *v.shape[2:]) for k, v in tp.items()}
        tables = torch.arange(3 * 4, dtype=torch.int32).reshape(3, 4)
        paged = tops.paged_decode_attention(_t(q), pool, tables, _t(lens),
                                            fp8=False)
        np.testing.assert_allclose(dense.numpy(), paged.numpy(), rtol=1e-5,
                                   atol=1e-6)


# The card's K4/K5 body (csrc/decode_attention.cuh) feeds mma.sync
# m16n8k16 from the plane bytes by ldmatrix and byte permutes. Its index
# maps are mirrored here lane by lane: a wrong slot or selector gives
# garbage, not a small error.
_LOG2E = 1.4426950408889634
_STEP = 16            # keys a warp takes a step


def _byte_perm(x: int, y: int, sel: int) -> int:
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)]
    pool += [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _f16_pair(word: int) -> tuple[float, float]:
    h = np.asarray([word & 0xFFFF, word >> 16], np.uint16).view(np.float16)
    return float(h[0]), float(h[1])


def _split2(x: float, y: float) -> tuple[int, int]:
    """The kernel's split2: f16 words of rn(x), rn(y) and of the f32
    residuals, x in the low half."""
    v = np.asarray([x, y], np.float32)
    hi = v.astype(np.float16)
    lo = (v - hi.astype(np.float32)).astype(np.float16)
    hw, lw = hi.view(np.uint16).astype(int), lo.view(np.uint16).astype(int)
    return int(hw[0] | hw[1] << 16), int(lw[0] | lw[1] << 16)


def _ldsm_x4(smem: np.ndarray, addrs: list[int], trans: bool) -> list[list[int]]:
    """ldmatrix .x4 (.trans): lanes 8i..8i+7 give the rows of matrix i;
    each lane gets one 32-bit word of each matrix."""
    regs = [[0] * 4 for _ in range(32)]
    for i in range(4):
        mat = [smem[a:a + 16].view(np.uint16) for a in addrs[8 * i:8 * i + 8]]
        for lane in range(32):
            r, c = lane // 4, 2 * (lane % 4)
            u0, u1 = ((mat[c][r], mat[c + 1][r]) if trans
                      else (mat[r][c], mat[r][c + 1]))
            regs[lane][i] = int(u0) | int(u1) << 16
    return regs


def _mma(c, a, b0, b1):
    """mma.sync m16n8k16 row.col over per-lane fragments, f64 sums."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    C = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, 2 * t:2 * t + 2] = _f16_pair(a[lane][0])
        A[g + 8, 2 * t:2 * t + 2] = _f16_pair(a[lane][1])
        A[g, 2 * t + 8:2 * t + 10] = _f16_pair(a[lane][2])
        A[g + 8, 2 * t + 8:2 * t + 10] = _f16_pair(a[lane][3])
        B[2 * t:2 * t + 2, g] = _f16_pair(b0[lane])
        B[2 * t + 8:2 * t + 10, g] = _f16_pair(b1[lane])
        C[g, 2 * t:2 * t + 2] = c[lane][0:2]
        C[g + 8, 2 * t:2 * t + 2] = c[lane][2:4]
    out = A @ B + C
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c[lane] = [out[g, 2 * t], out[g, 2 * t + 1], out[g + 8, 2 * t],
                   out[g + 8, 2 * t + 1]]


def _join(kind: str, fp8: bool, hi: int, lo: int) -> tuple[int, int]:
    sel = {("k", False): (0x5140, 0x7362), ("k", True): (0x1404, 0x3424),
           ("v", False): (0x6240, 0x7351), ("v", True): (0x2404, 0x3414)}
    s0, s1 = sel[kind, fp8]
    if fp8:
        return _byte_perm(hi, 0, s0), _byte_perm(hi, 0, s1)
    return _byte_perm(lo, hi, s0), _byte_perm(lo, hi, s1)


class TestDecodeFragments:
    """One warp's step of the card's K4/K5 body: 16 keys of plane bytes
    in a padded ring slot (planes k_hi, v_hi, k_lo, v_lo), QK^T with q as
    two f16 terms in rows g and g + 8, PV with p * 2^12 likewise, and the
    float4 each thread ends with."""

    @staticmethod
    def _slot(d, fp8, k, v):
        ld = d + 16
        planes = []
        for x in (k, v):
            bits = x.view(np.uint16)
            planes.append((bits >> 8).astype(np.uint8))
            planes.append((bits & 0xFF).astype(np.uint8))
        order = [planes[0], planes[2]] + ([] if fp8 else [planes[1], planes[3]])
        smem = np.zeros(len(order) * _STEP * ld, np.uint8)
        for p, pl in enumerate(order):
            for key in range(_STEP):
                at = (p * _STEP + key) * ld
                smem[at:at + d] = pl[key]
        return smem, ld

    @staticmethod
    def _a_off(lane, ld):
        return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 16

    @pytest.mark.parametrize("fp8", [False, True])
    @pytest.mark.parametrize("d", [64, 128])
    def test_step_products_follow_the_fragment_maps(self, d, fp8):
        rng = np.random.default_rng(40)
        g_rows = 4
        k = rng.normal(size=(_STEP, d)).astype(np.float16)
        v = rng.normal(size=(_STEP, d)).astype(np.float16)
        if fp8:     # e5m2 values: f16 with a zero low byte
            k = (k.view(np.uint16) & 0xFF00).view(np.float16)
            v = (v.view(np.uint16) & 0xFF00).view(np.float16)
        q = (rng.normal(size=(g_rows, d)) * 300).astype(np.float32)
        smem, ld = self._slot(d, fp8, k, v)
        plane = _STEP * ld
        kb_n = d // 16
        qa = [[[0] * 4 for _ in range(32)] for _ in range(kb_n)]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kb in range(kb_n):
                x = q[g, 16 * kb + 4 * t:16 * kb + 4 * t + 4] if g < g_rows \
                    else np.zeros(4, np.float32)
                qa[kb][lane][0], qa[kb][lane][1] = _split2(x[0], x[1])
                qa[kb][lane][2], qa[kb][lane][3] = _split2(x[2], x[3])
        offs = [self._a_off(lane, ld) for lane in range(32)]
        sc = [[[0.0] * 4 for _ in range(32)] for _ in range(2)]
        for kb in range(d // 32):
            kh = _ldsm_x4(smem, [o + kb * 32 for o in offs], False)
            kl = (_ldsm_x4(smem, [2 * plane + o + kb * 32 for o in offs],
                           False) if not fp8 else [[0] * 4] * 32)
            for mt in range(4):
                b = [_join("k", fp8, kh[ln][mt], kl[ln][mt]) for ln in range(32)]
                _mma(sc[mt & 1], qa[2 * kb + (mt >> 1)], [x[0] for x in b],
                     [x[1] for x in b])
        q_hi = q.astype(np.float16).astype(np.float32)  # the two f16 terms
        q_two = q_hi.astype(np.float64) + (q - q_hi).astype(np.float16)
        want_s = q_two @ k.astype(np.float64).T
        p = rng.uniform(0, 1, size=(8, _STEP))
        pa = [[0] * 4 for _ in range(32)]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for n in range(2):
                for e in range(2):
                    key = 8 * n + 2 * t + e
                    if g < g_rows:
                        np.testing.assert_allclose(
                            sc[n][lane][e] + sc[n][lane][2 + e],
                            want_s[g, key], rtol=1e-9, atol=1e-9)
            pw = (p[g] * 4096).astype(np.float32)
            pa[lane][0], pa[lane][1] = _split2(pw[2 * t], pw[2 * t + 1])
            pa[lane][2], pa[lane][3] = _split2(pw[8 + 2 * t], pw[9 + 2 * t])
        acc = [[[[0.0] * 4 for _ in range(32)] for _ in range(2)]
               for _ in range(kb_n)]
        for vb in range(d // 32):
            vh = _ldsm_x4(smem, [plane + o + vb * 32 for o in offs], True)
            vl = (_ldsm_x4(smem, [3 * plane + o + vb * 32 for o in offs],
                           True) if not fp8 else [[0] * 4] * 32)
            for half in range(2):
                j0 = [_join("v", fp8, vh[ln][2 * half], vl[ln][2 * half])
                      for ln in range(32)]
                j1 = [_join("v", fp8, vh[ln][2 * half + 1],
                            vl[ln][2 * half + 1]) for ln in range(32)]
                for par in range(2):
                    _mma(acc[2 * vb + half][par], pa,
                         [x[par] for x in j0], [x[par] for x in j1])
        p32 = (p * 4096).astype(np.float32)      # the two f16 terms of p
        p_hi = p32.astype(np.float16).astype(np.float32)
        p_two = p_hi.astype(np.float64) + (p32 - p_hi).astype(np.float16)
        want_o = p_two @ v.astype(np.float64)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for db in range(kb_n):
                a0, a1 = acc[db][0][lane], acc[db][1][lane]
                got = [a0[0] + a0[2], a1[0] + a1[2], a0[1] + a0[3],
                       a1[1] + a1[3]]
                np.testing.assert_allclose(
                    got, want_o[g, 16 * db + 4 * t:16 * db + 4 * t + 4],
                    rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("d", [64, 128])
    def test_loads_and_reads_cover_the_slot_without_bank_conflicts(self, d):
        """cp.async: lane + 32 it covers every (key, 16-byte chunk) of a
        plane once; ldmatrix: the 8 rows of each matrix of every x4 read
        hit 32 distinct banks."""
        ld, ch = d + 16, d // 16
        seen = sorted(((lane + 32 * it) // ch, (lane + 32 * it) % ch)
                      for it in range(_STEP * ch // 32) for lane in range(32))
        assert seen == [(t, c) for t in range(_STEP) for c in range(ch)]
        for kb in range(d // 32):
            offs = [self._a_off(lane, ld) + kb * 32 for lane in range(32)]
            for i in range(4):
                banks = {(a // 4 + w) % 32 for a in offs[8 * i:8 * i + 8]
                         for w in range(4)}
                assert len(banks) == 32


def _split_keys(block_size: int) -> int:
    """Keys a split holds: 512, rounded down to whole table blocks."""
    return block_size if block_size >= 512 else (512 // block_size) * block_size


def _split_design(q, k, v, lens, *, limit, split, window):
    """The card's K4/K5 arithmetic in plain torch: q (B,H,D) f32, k and v
    (B, limit, Hkv, D) f32 holding the f16 (or e5m2) values in logical key
    order. Per (row, kv head, group of 8 query heads): splits of `split`
    keys, inside a split steps of 16 kept keys dealt to 4 warps in turn,
    q * 2^e and p * 2^12 as two f16 terms, exp2 of log2(e)-scaled scores,
    the warps merged in order, then the splits in order."""
    b_n, h_n, d = q.shape
    hkv = k.shape[2]
    g_n = h_n // hkv
    out = torch.zeros((b_n, h_n, d))

    def two(x):
        hi = x.to(torch.float16).float()
        return hi, (x - hi).to(torch.float16).float()

    for b in range(b_n):
        n = int(lens[b])
        khi = min(n, limit)
        klo = n - window if window and window > 0 and n - window > 0 else 0
        if khi <= klo:
            continue
        for h in range(hkv):
            for g0 in range(0, g_n, 8):
                rows = slice(h * g_n + g0, h * g_n + min(g0 + 8, g_n))
                qs = q[b, rows] * d ** -0.5
                amax = float(qs.abs().max())
                e = max(-100, min(100, 14 - math.frexp(amax)[1])) if amax else 0
                q_hi, q_lo = two(qs * 2.0 ** e)
                down = 2.0 ** -e * _LOG2E
                parts = []
                for s0 in range(klo // split * split, khi, split):
                    lo, hi = max(klo, s0), min(khi, s0 + split)
                    n_st = -(-(hi - lo) // _STEP)
                    warps = []
                    for w in range(min(n_st, 4)):
                        m = torch.full((qs.shape[0], 1), -1e30)
                        l = torch.zeros_like(m)
                        acc = torch.zeros_like(qs)
                        for i, j in enumerate(range(w, n_st, 4)):
                            keys = torch.arange(lo + 16 * j, lo + 16 * j + 16)
                            kept = keys < hi
                            kt = torch.where(kept[:, None], k[b, keys.clamp(max=limit - 1), h], 0.0)
                            vt = torch.where(kept[:, None], v[b, keys.clamp(max=limit - 1), h], 0.0)
                            sc = ((q_hi @ kt.T) + (q_lo @ kt.T)) * down
                            sc = torch.where(kept[None], sc, -1e30)
                            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                            corr = torch.exp2(m - m_new)
                            p = torch.exp2(sc - m_new)
                            l = l * corr + p.sum(-1, keepdim=True)
                            if i > 0:
                                acc = acc * corr
                            p_hi, p_lo = two(p * 4096.0)
                            acc = acc + (p_hi @ vt + p_lo @ vt)
                            m = m_new
                        warps.append((m, l, acc))
                    big = torch.stack([x[0] for x in warps]).amax(0)
                    o = sum(torch.exp2(x[0] - big) * x[2] for x in warps)
                    lsum = sum(torch.exp2(x[0] - big) * x[1] for x in warps)
                    parts.append((big, lsum, o / 4096.0))
                big = torch.stack([x[0] for x in parts]).amax(0)
                o = sum(torch.exp2(x[0] - big) * x[2] for x in parts)
                lsum = sum(torch.exp2(x[0] - big) * x[1] for x in parts)
                out[b, rows] = o / torch.clamp(lsum, min=1e-30)
    return out


def _planes_values(planes, fp8):
    k_hi, k_lo, v_hi, v_lo = (_t(p) for p in planes)
    if fp8:
        return (tnf.e5m2_view(k_hi, torch.float16).float(),
                tnf.e5m2_view(v_hi, torch.float16).float())
    return (tnf.join_bytes(k_hi, k_lo).float(),
            tnf.join_bytes(v_hi, v_lo).float())


class TestDecodeSplitDesign:
    """The split + combine arithmetic of the card's K4/K5 body
    (`_split_design`), held to the Pallas kernels in interpret mode at the
    unchanged 2e-4: lens 1, S-1, S, S+1 and several splits (S = 512),
    windows whose first kept key lands mid-split and on a split edge, K4
    rows of len 0, a block size that does not divide 512, and G = 10 (two
    head groups)."""

    @pytest.mark.parametrize("fp8", [False, True])
    @pytest.mark.parametrize("window", [None, 273, 300])
    @pytest.mark.parametrize("h,hkv", [(4, 2), (20, 2)])
    def test_dense_split_design_matches_pallas(self, h, hkv, window, fp8):
        """lens 785 and 600: window 273 starts row 785 at key 512, a split
        edge; window 300 starts it at 485 and row 600 at 300, mid-split."""
        rng = np.random.default_rng(41)
        b, d, cap = 6, 64, 1024
        q = rng.normal(size=(b, h, d)).astype(np.float32)
        kv = rng.normal(size=(2, b, cap, hkv, d)).astype(np.float16)
        planes = [np.asarray(p) for p in (
            *jnf.split_bytes(jnp.asarray(kv[0])),
            *jnf.split_bytes(jnp.asarray(kv[1])))]
        lens = np.asarray([1, 511, 512, 513, 785, 600], np.int32)
        want = np.asarray(j_dense_attn(
            jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(lens),
            fp8=fp8, block_c=256, window=window, interpret=True))
        k, v = _planes_values(planes, fp8)
        got = _split_design(_t(q), k, v, lens, limit=cap,
                            split=_split_keys(1), window=window).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    @pytest.mark.parametrize("fp8", [False, True])
    @pytest.mark.parametrize("window", [None, 128, 300])
    @pytest.mark.parametrize("bs,mb,lens", [
        (32, 20, [0, 1, 511, 512, 513, 640]),
        (24, 24, [0, 503, 504, 505, 576])])
    def test_paged_split_design_matches_pallas(self, bs, mb, lens, window,
                                               fp8):
        rng = np.random.default_rng(42)
        b, h, hkv, d = len(lens), 4, 2, 64
        nb = 1 + b * mb
        tables = rng.permutation(np.arange(1, nb)).astype(np.int32)
        tables = tables.reshape(b, mb)
        tables[-1, :2] = tables[1, :2]          # COW-shared prefix blocks
        lens = np.asarray(lens, np.int32)
        for r in range(b):
            tables[r, -(-int(lens[r]) // bs):] = 0
        q = rng.normal(size=(b, h, d)).astype(np.float32)
        kv = rng.normal(size=(2, nb, bs, hkv, d)).astype(np.float16)
        planes = [np.asarray(p) for p in (
            *jnf.split_bytes(jnp.asarray(kv[0])),
            *jnf.split_bytes(jnp.asarray(kv[1])))]
        jargs = dict(fp8=fp8, interpret=True)
        if window:
            jargs["window"] = window
        want = np.asarray(j_paged_attn(
            jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(tables),
            jnp.asarray(lens), **jargs))
        k, v = _planes_values(planes, fp8)
        rows = _t(tables).long()
        k = k[rows].reshape(b, mb * bs, hkv, d)
        v = v[rows].reshape(b, mb * bs, hkv, d)
        got = _split_design(_t(q), k, v, lens, limit=mb * bs,
                            split=_split_keys(bs), window=window).numpy()
        live = lens > 0
        assert np.array_equal(got[~live], np.zeros_like(got[~live]))
        np.testing.assert_allclose(got[live], want[live], **ATTN_TOL)


class TestFlashPrefillAttention:
    """K6: causal GQA prefill attention, q (B,S,H,D), k/v (B,S,Hkv,D)."""

    @staticmethod
    def _qkv(seed, b, s, h, hkv, d):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(b, s, h, d)).astype(np.float32),
                rng.normal(size=(b, s, hkv, d)).astype(np.float32),
                rng.normal(size=(b, s, hkv, d)).astype(np.float32))

    @pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
    def test_plain_matches_pallas(self, h, hkv):
        q, k, v = self._qkv(15, 2, 128, h, hkv, 64)
        want = np.asarray(j_flash_prefill(*map(jnp.asarray, (q, k, v)),
                                          block=(32, 64), interpret=True))
        got = tops.flash_prefill_attention(_t(q), _t(k), _t(v)).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    def test_ragged_s_matches_jax_reference_prefill(self):
        # the Pallas kernel needs S to divide its blocks; the port does not
        q, k, v = self._qkv(16, 2, 45, 4, 2, 64)
        want = np.asarray(j_core_prefill(*map(jnp.asarray, (q, k, v)),
                                         block_k=16))
        got = tops.flash_prefill_attention(_t(q), _t(k), _t(v)).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    def test_first_position_attends_only_itself(self):
        q, k, v = self._qkv(17, 1, 20, 4, 2, 64)
        got = tops.flash_prefill_attention(_t(q), _t(k), _t(v)).numpy()
        np.testing.assert_allclose(got[0, 0].reshape(2, 2, 64),
                                   np.repeat(v[0, 0][:, None], 2, axis=1),
                                   rtol=1e-6, atol=1e-6)

    # The card's f16/bf16 body (csrc/flash_prefill_attention.cu) runs both
    # products on the tensor cores. Its arithmetic, emulated below, keeps
    # the plain version's 2e-4: QK^T of the unscaled inputs is exact in
    # f32 before the D^-0.5 scale, and PV takes the f32 probabilities as
    # two terms of the input type, p_hi = rn(p) and p_lo = rn(p - p_hi),
    # whose sum is within 2^-16 p (bf16) of p; one rounding of p alone
    # (2^-9 in bf16) is not (test_one_term_of_p_misses_the_tolerance).
    @staticmethod
    def _tc_body(q, k, v, dtype, terms=2, tile=64):
        """The tensor-core body in plain torch, in its key-tile order: q
        (B,S,H,D), k/v (B,S,Hkv,D) f32 holding values of `dtype`."""
        b, s, h, d = q.shape
        hkv = k.shape[2]
        qg = q.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
        m = torch.full((*qg.shape[:-1], 1), -1e30)
        l, acc = torch.zeros_like(m), torch.zeros_like(qg)
        qpos = torch.arange(s)[:, None]
        for t0 in range(0, s, tile):
            kt, vt = k[:, t0:t0 + tile], v[:, t0:t0 + tile]
            sc = torch.einsum("bhgqd,bthd->bhgqt", qg, kt) * d ** -0.5
            kpos = torch.arange(t0, t0 + kt.shape[1])[None]
            sc = torch.where(kpos <= qpos, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            p_hi = p.to(dtype).float()
            acc = acc * corr + torch.einsum("bhgqt,bthd->bhgqd", p_hi, vt)
            if terms == 2:
                p_lo = (p - p_hi).to(dtype).float()
                acc = acc + torch.einsum("bhgqt,bthd->bhgqd", p_lo, vt)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)

    def _rounded_qkv(self, seed, b, s, h, hkv, d, dtype):
        return [torch.from_numpy(x).to(dtype).float()
                for x in self._qkv(seed, b, s, h, hkv, d)]

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4), (8, 1)])
    def test_tensor_core_design_matches_pallas(self, h, hkv, d, dtype):
        q, k, v = self._rounded_qkv(18, 2, 128, h, hkv, d, dtype)
        want = np.asarray(j_flash_prefill(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), block=(32, 64),
            interpret=True))
        got = self._tc_body(q, k, v, dtype).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_tensor_core_design_ragged_s(self, dtype):
        q, k, v = self._rounded_qkv(19, 2, 45, 4, 2, 64, dtype)
        want = np.asarray(j_core_prefill(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), block_k=16))
        got = self._tc_body(q, k, v, dtype).numpy()
        np.testing.assert_allclose(got, want, **ATTN_TOL)

    def test_one_term_of_p_misses_the_tolerance(self):
        """Why the split: P rounded once to bf16 for the PV product lands
        outside 2e-4 of the f32 plain version on the same inputs."""
        q, k, v = self._rounded_qkv(18, 2, 128, 4, 2, 128, torch.bfloat16)
        want = tref.flash_prefill_attention_ref(q, k, v)
        one = self._tc_body(q, k, v, torch.bfloat16, terms=1)
        two = self._tc_body(q, k, v, torch.bfloat16, terms=2)
        lim = ATTN_TOL["atol"] + ATTN_TOL["rtol"] * want.abs()
        assert not bool(((one - want).abs() <= lim).all())
        assert bool(((two - want).abs() <= lim).all())


class TestFusedQuantFP8:
    """K7: activations quantized with 448/amax, then the FP8 GEMM."""

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    def test_plain_matches_pallas(self, dtype):
        x, w = _gemm_inputs(18, 64, 256, 128)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        amax = jnp.max(jnp.abs(jx.astype(jnp.float32)))
        ju, _ = jnf.encode(jnp.asarray(w))
        want = np.asarray(j_fused_quant(jx, ju, jnp.atleast_1d(amax),
                                        block=BLOCK, interpret=True))
        tx = _t(x).to(getattr(torch, dtype))
        tu, _ = tnf.encode(_t(w))
        got = tops.matmul_nested_fp8_fused_quant(tx, tu, tquant.absmax(tx))
        np.testing.assert_allclose(got.numpy(), want, **GEMM_TOL)

    @staticmethod
    def _mma_body(x, upper, amax):
        """The CUDA mma body's arithmetic in plain torch: x quantized once
        (the pre-pass), then each k32 product (mma.sync m16n8k32) added to
        the f32 accumulators, k from 0 upwards."""
        codes = tnf.fp8_view(tref.fused_quant_codes(x, amax)).float()
        w = tnf.fp8_view(upper).float()
        total = torch.zeros((x.shape[0], w.shape[1]))
        for k in range(0, x.shape[1], 32):
            total = total + codes[:, k:k + 32] @ w[k:k + 32]
        amax = amax.reshape(())
        return total * (amax / 448.0) * 2.0 ** -8

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    def test_mma_arithmetic_matches_pallas(self, dtype):
        x, w = _gemm_inputs(23, 64, 512, 128)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        amax = jnp.max(jnp.abs(jx.astype(jnp.float32)))
        ju, _ = jnf.encode(jnp.asarray(w))
        want = np.asarray(j_fused_quant(jx, ju, jnp.atleast_1d(amax),
                                        block=BLOCK, interpret=True))
        tx = _t(x).to(getattr(torch, dtype))
        got = self._mma_body(tx, tnf.encode(_t(w))[0], tquant.absmax(tx))
        np.testing.assert_allclose(got.numpy(), want, **GEMM_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    def test_prepass_codes_equal_in_tile_codes(self, dtype):
        """The codes the pre-pass writes (its plain version,
        `ref.fused_quant_codes`) are bitwise those the JAX kernel makes
        inside its tile: saturation at +-448 (x beyond the amax given),
        e4m3 subnormals, signed zeros, and an all-zero x whose amax is
        clamped to 1e-12. Read through an identity weight: the GEMM is
        exact, so each JAX output is its code times the dequant scale (to
        an ulp of the epilogue), and rounding output / scale to e4m3 gives
        the code back; -0 codes sum to +0 there, so zeros compare
        unsigned."""
        rng = np.random.default_rng(24)
        x = rng.uniform(-3, 3, (3, 8, 128)).astype(np.float32)
        x[0, 0, :8] = [3.0, -3.0, 5.0, -7.5, 0.0, -0.0, 2e-4, -3e-4]
        x[0, 1] = np.linspace(-0.02, 0.02, 128)       # codes near 0
        x[0, 2, :16] = np.linspace(-9e-5, 9e-5, 16)   # e4m3 subnormals
        x[1] *= 1e-3
        x[2] = 0.0
        eye = np.zeros((128, 128), np.uint8)
        np.fill_diagonal(eye, 0x38)                    # e4m3 1.0
        for i, amax in enumerate((2.5, None, None)):
            jx = jnp.asarray(x[i]).astype(getattr(jnp, dtype))
            tx = _t(x[i]).to(getattr(torch, dtype))
            ta = (torch.tensor([amax]) if amax is not None
                  else tquant.absmax(tx).reshape(1))
            want = np.asarray(j_fused_quant(jx, jnp.asarray(eye),
                                            jnp.asarray(ta.numpy()),
                                            block=(8, 128, 128),
                                            interpret=True))
            scale = np.float32(ta.item()) / np.float32(448) / np.float32(256)
            jcodes = np.asarray(jnp.asarray(want / scale)
                                .astype(jnp.float8_e4m3fn)).view(np.uint8)
            got = tref.fused_quant_codes(tx, ta).numpy()
            unsigned_zero = np.where(got == 0x80, 0, got)
            np.testing.assert_array_equal(unsigned_zero, jcodes)
        codes = tref.fused_quant_codes(_t(x[0]), torch.tensor(2.5))
        assert {0x7E, 0xFE} <= set(codes.flatten().tolist())  # +-448
        assert any(0 < c & 0x7F < 8 for c in codes.flatten().tolist())
        zero = _t(x[2])
        assert tquant.absmax(zero).item() == pytest.approx(1e-12)
        assert not tref.fused_quant_codes(zero, tquant.absmax(zero)).any()

    def test_inverse_is_a_true_division(self):
        """448/amax as the JAX kernel computes it: PyTorch's `448.0 /
        tensor` runs as reciprocal() * 448 and lands one ulp away for a
        quarter of the amax values; here x = 2.4642856 with amax = 3 then
        gave code 384 where the JAX kernel gives 352."""
        rng = np.random.default_rng(25)
        amax = rng.uniform(0.01, 10, 2000).astype(np.float32)
        for a in list(amax[:50]) + [np.float32(3.0)]:
            x = np.float32(a) * np.linspace(-1, 1, 2049, dtype=np.float32)
            x = np.concatenate([x, [np.float32(2.4642856121063232)]])
            jinv = jnp.float32(448.0) / jnp.float32(a)
            want = np.asarray(jnp.clip(jnp.asarray(x) * jinv, -448, 448)
                              .astype(jnp.float8_e4m3fn)).view(np.uint8)
            got = tref.fused_quant_codes(_t(x), torch.tensor(a)).numpy()
            np.testing.assert_array_equal(got, want)

    def test_quantizes_by_multiplying_with_the_inverse(self):
        # x * (448/amax) and x / (amax/448) can land one f32 ulp apart,
        # across an e4m3 rounding midpoint: here 336.0 (codes 320 / 352).
        # The fused kernel multiplies; quantize_act_per_tensor divides.
        x = torch.tensor([[3.750000238418579, 5.0]])
        u = torch.full((2, 1), 0x38, dtype=torch.uint8)       # e4m3 1.0
        amax = tquant.absmax(x)
        got = tref.nestedfp8_matmul_fused_quant_ref(x, u, amax)
        want = torch.tensor([[352.0 + 448.0]]) * (amax / 448.0) * 2 ** -8
        assert torch.equal(got, want)
        xq, scale = tquant.quantize_act_per_tensor(x)
        assert xq.float().tolist() == [[320.0, 448.0]]
        jx = np.zeros((8, 128), np.float32)
        jx[0, :2] = x[0].numpy()
        ju = np.zeros((128, 128), np.uint8)
        ju[:2, 0] = 0x38
        j = np.asarray(j_fused_quant(jnp.asarray(jx), jnp.asarray(ju),
                                     jnp.asarray([5.0], jnp.float32),
                                     block=(8, 128, 128), interpret=True))
        assert j[0, 0] == want.item()

    def test_rows_independent_of_batch_given_amax(self):
        x, w = _gemm_inputs(19, 12, 256, 64)
        tu, _ = tnf.encode(_t(w))
        amax = tquant.absmax(_t(x))
        full = tops.matmul_nested_fp8_fused_quant(_t(x), tu, amax)
        one = tops.matmul_nested_fp8_fused_quant(_t(x)[3:4], tu, amax)
        np.testing.assert_array_equal(full[3:4].numpy(), one.numpy())


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm for selectors 0-7: result byte i is byte
    (s >> 4i) & 7 of the 8 bytes y:x."""
    b = (x | (y << 32)).to_bytes(8, "little")
    return int.from_bytes(bytes(b[(s >> (4 * i)) & 7] for i in range(4)),
                          "little")


def _transpose4x4(w):
    t0 = _byte_perm(w[0], w[1], 0x5140)
    t1 = _byte_perm(w[0], w[1], 0x7362)
    t2 = _byte_perm(w[2], w[3], 0x5140)
    t3 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _tma_sw128(lin: int) -> int:
    """TMA's 128-byte swizzle: bits 4-6 of the shared offset XOR bits 7-9."""
    return lin ^ (((lin >> 7) & 7) << 4)


def _sw128_offset(row: int, chunk: int) -> int:          # the kernel's
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _raw_offset(bn: int, kr: int, n: int) -> int:        # the kernel's
    row = 8 * (kr & 15) + (kr >> 4)
    if bn == 128:
        return row * 128 + ((((n >> 4) ^ (row & 7))) << 4) + (n & 15)
    return row * bn + n


class TestFusedQuantLayout:
    """The index maps of K7's mma body (csrc/nestedfp8_matmul_fused_
    quant.cu), mirrored here: the TMA box of a raw weight tile, the
    transposing load (4 x 4 byte transposes by __byte_perm), the 128-byte
    swizzle of the K-major operands and the ldmatrix addresses that turn
    them into mma.sync m16n8k32 e4m3 fragments."""

    # producer warps that transpose: all four at BN = 128 (a consumer
    # thread loads), warps 1-3 at BN = 32 (warp 0 loads)
    TRANSPOSERS = {128: (0, 4), 32: (1, 3)}

    @pytest.mark.parametrize("bn", [32, 128])
    def test_tma_box_lands_where_raw_offset_reads(self, bn):
        seen = {}
        for i in range(16):
            for kg in range(8):
                for n in range(bn):
                    lin = (i * 8 + kg) * bn + n        # box order (n, kg, i)
                    phys = _tma_sw128(lin) if bn == 128 else lin
                    seen[(16 * kg + i, n)] = phys
        assert sorted(seen.values()) == list(range(128 * bn))
        for (kr, n), phys in seen.items():
            assert _raw_offset(bn, kr, n) == phys

    @pytest.mark.parametrize("bn", [32, 128])
    def test_transposing_load_puts_n_k_where_ldmatrix_reads(self, bn):
        rng = np.random.default_rng(26)
        tile = rng.integers(0, 256, (128, bn), dtype=np.uint8)   # [k][n]
        raw = bytearray(128 * bn)
        for kr in range(128):
            for n in range(bn):
                raw[_raw_offset(bn, kr, n)] = tile[kr, n]
        bop = bytearray(bn * 128)
        written = []
        lds_banks, sts_slots = [], []
        first, count = self.TRANSPOSERS[bn]
        for warp in range(first, first + count):
            for wu in range(warp - first, bn // 16, count):
                for i in range(16):
                    lds_banks.append(sorted(
                        (_raw_offset(bn, 16 * (lane & 7) + i,
                                     4 * (wu * 4 + (lane >> 3))) // 4) % 32
                        for lane in range(32)))
                for lane in range(32):
                    kg, ng = lane & 7, wu * 4 + (lane >> 3)
                    w = [int.from_bytes(raw[_raw_offset(bn, 16 * kg + i,
                                                        4 * ng):][:4],
                                        "little") for i in range(16)]
                    o = [[0] * 4 for _ in range(4)]
                    for q in range(4):
                        oq = _transpose4x4(w[4 * q:4 * q + 4])
                        for j in range(4):
                            o[j][q] = oq[j]
                    for j in range(4):
                        at = _sw128_offset(ng * 4 + j, kg)
                        bop[at:at + 16] = b"".join(
                            v.to_bytes(4, "little") for v in o[j])
                        written.append(at)
                for j in range(4):
                    for quarter in range(4):
                        sts_slots.append({
                            (_sw128_offset((wu * 4 + quarter) * 4 + j,
                                           lane & 7) % 128) // 16
                            for lane in range(8 * quarter, 8 * quarter + 8)})
        # every 16-byte chunk of the operand written once
        assert sorted(written) == list(range(0, bn * 128, 16))
        # the K-major 128B-swizzled layout that the consumers read
        for n in range(bn):
            for k in range(128):
                assert bop[_sw128_offset(n, k >> 4) + (k & 15)] == tile[k, n]
        # conflict-free: the 8 stores of a quarter-warp fill a 128-byte
        # row; at BN = 128 the 32 reads of a warp hit 32 banks
        assert all(len(s) == 8 for s in sts_slots)
        if bn == 128:
            assert all(b == list(range(32)) for b in lds_banks)

    def test_x_codes_box_is_the_operand_layout(self):
        for m in range(128):
            for k in range(128):
                assert _tma_sw128(m * 128 + k) == _sw128_offset(m, k >> 4) + (k & 15)

    @staticmethod
    def _ldmatrix(buf, addrs):
        """ldmatrix .b16 (x len(addrs) / 8 matrices): lanes 8i..8i+7 name
        the 16-byte rows of matrix i; lane l receives bytes 4(l%4)..+3 of
        row l/4 of each matrix, as one 32-bit word a matrix."""
        return [[bytes(buf[addrs[8 * i + lane // 4] + 4 * (lane % 4):][:4])
                 for i in range(len(addrs) // 8)] for lane in range(32)]

    @pytest.mark.parametrize("mt,nt,cm,cn", [(1, 1, 1, 4), (1, 4, 4, 1),
                                             (1, 4, 8, 1), (4, 4, 2, 4)])
    def test_ldmatrix_gives_the_mma_fragments(self, mt, nt, cm, cn):
        """With the kernel's lane addresses, each lane holds the e4m3
        bytes that mma.sync m16n8k32 .row.col expects: a_r = A[g + 8(r%2)]
        [16(r/2) + 4t ..+3], b_r = B[16r + 4t ..+3][g] (g = lane/4,
        t = lane%4), for every warp of each tile config (by_m) and
        every k32 step of a 128-byte k tile (x2 loads when a warp has one
        n8 tile: lanes 0-15 name the rows)."""
        bm, bn = 16 * mt * cm, 8 * nt * cn
        rng = np.random.default_rng(28)
        a = rng.integers(0, 256, (bm, 128), dtype=np.uint8)     # [m][k]
        bt = rng.integers(0, 256, (bn, 128), dtype=np.uint8)    # [n][k]
        abuf, bbuf = bytearray(bm * 128), bytearray(bn * 128)
        for r in range(bm):
            for k in range(128):
                abuf[_sw128_offset(r, k >> 4) + (k & 15)] = a[r, k]
        for r in range(bn):
            for k in range(128):
                bbuf[_sw128_offset(r, k >> 4) + (k & 15)] = bt[r, k]
        for warp in range(cm * cn):
            wm, wn = warp // cn, warp % cn
            for kk in range(4):
                for i in range(mt):
                    got = self._ldmatrix(abuf, [_sw128_offset(
                        wm * mt * 16 + 16 * i + (ln & 7) + ((ln >> 3) & 1) * 8,
                        2 * kk + (ln >> 4)) for ln in range(32)])
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        row0 = wm * mt * 16 + 16 * i + g
                        for r in range(4):
                            k0 = 32 * kk + 16 * (r // 2) + 4 * t
                            assert got[lane][r] == bytes(
                                a[row0 + 8 * (r % 2), k0:k0 + 4])
                for j in range(0, nt, 2 if nt > 1 else 1):
                    lanes = 32 if nt > 1 else 16
                    got = self._ldmatrix(bbuf, [_sw128_offset(
                        wn * nt * 8 + 8 * j + (ln & 7) + (ln >> 4) * 8,
                        2 * kk + ((ln >> 3) & 1)) for ln in range(lanes)])
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for r in range(len(got[lane])):
                            n = wn * nt * 8 + 8 * (j + r // 2) + g
                            k0 = 32 * kk + 16 * (r % 2) + 4 * t
                            assert got[lane][r] == bytes(bt[n, k0:k0 + 4])


def _nested4_to_f16x4(u: int, l: int) -> tuple[int, int]:   # the kernel's
    """K1's packed rebuild of four weights (wgmma_gemm.cuh): u, l hold four
    upper and four lower bytes; returns the (lo, hi) words of four f16."""
    m32 = 0xFFFFFFFF
    c = (l >> 7) & 0x01010101
    e = (((u | 0x80808080) - c) & m32) ^ 0x80808080
    h = (u & 0x80808080) | (e & 0x80808080) | ((e >> 1) & 0x7F7F7F7F)
    return _byte_perm(l, h, 0x5140), _byte_perm(l, h, 0x7362)


class TestWgmmaLayout:
    """The bit tricks and index maps of K1's and K3's TMA + wgmma body
    (csrc/wgmma_gemm.cuh), mirrored here: the packed four-at-a-time
    rebuild, the in-place rebuild of a raw plane block into the MN-major
    128B-swizzled operand, the TMA box that puts K3's f16 weights in the
    same place, the smem descriptors wgmma reads both operands by, and the
    epilogue's accumulator map."""

    def test_packed_rebuild_equals_decode_on_every_byte_pair(self):
        pairs = np.arange(65536, dtype=np.uint32)
        up, lo = (pairs >> 8).astype(np.uint8), (pairs & 0xFF).astype(np.uint8)
        want = tnf.decode(_t(up), _t(lo)).view(torch.int16).numpy()
        want = want.astype(np.uint16)
        uw = up.reshape(-1, 4).astype(np.uint32)
        lw = lo.reshape(-1, 4).astype(np.uint32)
        got = []
        for ub, lb in zip(uw.tolist(), lw.tolist()):
            u = ub[0] | ub[1] << 8 | ub[2] << 16 | ub[3] << 24
            l = lb[0] | lb[1] << 8 | lb[2] << 16 | lb[3] << 24
            for word in _nested4_to_f16x4(u, l):
                got += [word & 0xFFFF, word >> 16]
        np.testing.assert_array_equal(np.asarray(got, np.uint16), want)

    @staticmethod
    def _operand_offset(k: int, n: int) -> int:
        """Byte offset of f16 weight (k, n) of one 64-column block in the
        MN-major operand: 64 k rows of 128 bytes, 16-byte chunks XORed
        with k % 8 (the kernel's sw128_offset)."""
        return _sw128_offset(k, n >> 3) + 2 * (n & 7)

    @pytest.mark.parametrize("rt", [128, 96])
    def test_in_place_rebuild_gives_the_operand(self, rt):
        """A block arrives as raw upper (bytes 0-4095, 64 k x 64 n) and
        lower (4096-8191) boxes; the rt threads of a rebuild group load all
        of it, meet at the named barrier, then store the rebuilt f16: every
        16-byte chunk is written once, lands where wgmma reads weight
        (k, n), and a quarter-warp's stores fill one 128-byte row."""
        rng = np.random.default_rng(30)
        wts = rng.uniform(-1.75, 1.75, (64, 64)).astype(np.float16)
        up, lo = (x.numpy() for x in tnf.encode(_t(wts)))
        blk = bytearray(up.tobytes() + lo.tobytes())
        units = -(-512 // rt)
        loaded = {}
        for pt in range(rt):                       # loads first ...
            for q in range(units):
                at = (pt + rt * q) * 8
                if at < 4096:
                    loaded[pt, q] = (int.from_bytes(blk[at:at + 8], "little"),
                                     int.from_bytes(blk[4096 + at:][:8],
                                                    "little"))
        written, rows = [], {}
        for pt in range(rt):                       # ... then the stores
            for q in range(units):
                i = pt + rt * q
                if i >= 512:
                    break
                u, l = loaded[pt, q]
                a = _nested4_to_f16x4(u & 0xFFFFFFFF, l & 0xFFFFFFFF)
                b = _nested4_to_f16x4(u >> 32, l >> 32)
                at = _sw128_offset(i // 8, i % 8)
                blk[at:at + 16] = b"".join(w.to_bytes(4, "little")
                                           for w in (*a, *b))
                written.append(at)
                rows.setdefault((pt // 8, q), set()).add(at // 128)
        assert sorted(written) == list(range(0, 8192, 16))
        assert all(len(r) == 1 for r in rows.values())
        got = np.frombuffer(bytes(blk), np.uint16)
        for k in range(64):
            for n in range(64):
                assert got[self._operand_offset(k, n) // 2] == \
                    wts[k, n].view(np.uint16)

    def test_k3_tma_box_lands_in_the_operand_layout(self):
        """K3's f16 box of 64 k rows x 64 columns under TMA's 128-byte
        swizzle puts weight (k, n) where K1's rebuild writes it."""
        for k in range(64):
            for n in range(64):
                assert _tma_sw128(k * 128 + 2 * n) == \
                    self._operand_offset(k, n)

    @staticmethod
    def _desc_read(start: int, lbo: int, sbo: int, mn: int, k: int,
                   mn_major: bool) -> int:
        """Where wgmma reads element (mn, k) of a 128B-swizzled operand
        by its descriptor (CuTe's canonical GMMA layouts, 16-byte units):
        MN-major ((8,n),(8,k)):((1,LBO),(8,SBO)), K-major
        ((8,n),2):((8,SBO),1); the swizzle acts on the address bits."""
        if mn_major:
            lin = start + (mn // 64) * lbo + (k // 8) * sbo \
                + (k % 8) * 128 + 2 * (mn % 64)
        else:
            lin = start + (mn // 8) * sbo + (mn % 8) * 128 + 2 * k
        return _tma_sw128(lin)

    @pytest.mark.parametrize("bmx", [8, 256])
    def test_descriptors_read_both_operands(self, bmx):
        """Each k16 step kk of a stage: A (64 weight columns x 16 k) at
        start + 2048 kk, MN-major with SBO 1024; B (bmx rows of x x 16 k)
        at start + 32 kk in the TMA box of x (bmx rows of 128 bytes),
        K-major with SBO 1024."""
        for kk in range(4):
            for m in range(64):
                for k in range(16):
                    assert self._desc_read(2048 * kk, 8192, 1024, m, k,
                                           True) == \
                        self._operand_offset(16 * kk + k, m)
            for r in range(bmx):
                for k in range(16):
                    assert self._desc_read(32 * kk, 16, 1024, r, k,
                                           False) == \
                        _tma_sw128(r * 128 + 2 * (16 * kk + k))

    @pytest.mark.parametrize("bmx,cw", [(8, 1), (128, 1), (256, 2)])
    def test_epilogue_stores_each_output_once(self, bmx, cw):
        """The m64nNk16 accumulator map (thread t of warpgroup wg holds
        rows 16 w + lane/4 (+8) and columns 8 j' + 2 (lane % 4) (+1)):
        weight column n and x row m of every register cover the tile once."""
        seen = []
        for wg in range(cw):
            for warp in range(4):
                for lane in range(32):
                    for j in range(bmx // 2):
                        n = 64 * wg + 16 * warp + lane // 4 + 8 * ((j >> 1) & 1)
                        m = 2 * (lane & 3) + 8 * (j >> 2) + (j & 1)
                        seen.append((n, m))
        assert sorted(seen) == [(n, m) for n in range(64 * cw)
                                for m in range(bmx)]


class TestAbsmax:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                       torch.bfloat16])
    def test_own_type_max_equals_f32_first(self, dtype):
        """quant.absmax takes the max in x's own type and casts the one
        result; casting x to f32 first gives the same bits (abs and max
        are exact), for +-0, subnormals, and an all-zero x."""
        tiny = torch.finfo(dtype).smallest_normal
        cases = [
            torch.tensor([[0.0, -0.0], [tiny / 4, -tiny / 2]]),
            torch.tensor([[-0.0, 0.0]]),
            torch.zeros((3, 5)),
            torch.from_numpy(np.random.default_rng(27).normal(
                size=(16, 33)).astype(np.float32)) * 100,
        ]
        for x in cases:
            x = x.to(dtype)
            old = torch.clamp(x.to(torch.float32).abs().max(), min=1e-12)
            new = tquant.absmax(x)
            assert new.dtype == torch.float32
            assert torch.equal(new, old)


class TestEncode:
    """K8: f16 -> (upper, lower) bytes."""

    def test_every_applicable_pattern_matches_pallas(self):
        mags = np.arange(jnf.F16_NESTED_ABS_MAX_BITS + 1, dtype=np.uint16)
        bits = np.concatenate([mags, mags | 0x8000])          # 32258 values
        bits = np.pad(bits, (0, 128 * 256 - bits.size))
        w = bits.view(np.float16).reshape(128, 256)
        ju, jl = j_encode(jnp.asarray(w), block=(128, 256), interpret=True)
        tu, tl = tops.encode(_t(w))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    def test_from_f16_nests_through_encode(self):
        w = np.random.default_rng(20).uniform(-1.7, 1.7, (33, 17)).astype(
            np.float16)
        t = tnf.NestedTensor.from_f16(_t(w))
        u, lo = tops.encode(_t(w))
        assert torch.equal(t.upper, u) and torch.equal(t.lower, lo)
        assert torch.equal(t.read_f16(), _t(w))


class TestNestedLinear:
    """core/linear.py against the JAX package's nested_linear (ref backend):
    both modes, both activation-scale granularities, the exception-tensor
    path, the bias, and bf16-rounded outputs (fast_accum)."""

    @pytest.mark.parametrize("mode,act_quant,exception,fast_accum", [
        ("fp16", "per_tensor", False, False),
        ("fp8", "per_tensor", False, False),
        ("fp8", "per_token", False, False),
        ("fp8", "per_token", True, False),
        ("fp16", "per_tensor", True, False),
        ("fp16", "per_tensor", False, True),
        ("fp8", "per_token", False, True),
    ])
    def test_matches_jax(self, mode, act_quant, exception, fast_accum):
        x, w = _gemm_inputs(11, 6, 96, 40, lead=(2,))
        if exception:
            w[5, 7] = -2.5
        b = np.random.default_rng(12).normal(size=(40,)).astype(np.float32)
        jp = JNLP(jnf.NestedTensor.from_f16(jnp.asarray(w)), jnp.asarray(b))
        tp = TNLP(tnf.NestedTensor.from_f16(_t(w)), _t(b))
        assert tp.weight.is_exception == exception == jp.weight.is_exception
        kw = dict(mode=mode, act_quant=act_quant, fast_accum=fast_accum,
                  out_dtype=jnp.float32)
        want = np.asarray(j_nested_linear(jp, jnp.asarray(x), backend="ref",
                                          **kw), np.float32)
        kw["out_dtype"] = torch.float32
        got = t_nested_linear(tp, _t(x), **kw).numpy()
        assert got.shape == want.shape == (2, 6, 40)
        # bf16 outputs: sums that differ in their last f32 bit may round
        # to neighbouring bf16 values, one ulp = 0.125 for |y| < 32
        tol = dict(rtol=1e-2, atol=0.125) if fast_accum else GEMM_TOL
        np.testing.assert_allclose(got, want, **tol)


class TestRouting:
    def test_cpu_tensors_take_plain_versions_without_counting(self):
        before = tops.all_launch_counters()
        x, w = _gemm_inputs(8, 4, 64, 32)
        tops.matmul_nested_f16(_t(x).half(), *tnf.encode(_t(w)))
        tops.matmul_f16(_t(x).half(), _t(w))
        tops.matmul_nested_fp8_fused_quant(_t(x), tnf.encode(_t(w))[0],
                                           tquant.absmax(_t(x)))
        q, planes, lens = _dense_inputs(21)
        tops.planar_decode_attention(
            _t(q), dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"),
                            map(_t, planes))), _t(lens), fp8=True)
        qkv = torch.zeros((1, 8, 2, 64))
        tops.flash_prefill_attention(qkv, qkv, qkv)
        tops.quantize_act_per_token(_t(x))
        assert tops.all_launch_counters() == before
        assert len(before) == 9         # eight TPU kernels, the quantizer

    def test_mixed_devices_raise(self):
        x = torch.zeros((4, 64), dtype=torch.float16)
        u = torch.zeros((64, 32), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError):
            tops.matmul_nested_f16(x, u, u)
