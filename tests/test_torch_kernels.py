"""The eight kernels of the PyTorch port, against the JAX package's Pallas
kernels run in interpret mode on the CPU.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions to the Pallas kernels on seeded inputs.
The CUDA kernels themselves are held to the plain versions on the card
by tests/test_torch_gpu.py (and by chip_smoke.py)."""

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


class TestF16:
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    def test_plain_matches_pallas(self, shape):
        x, w = _gemm_inputs(5, *shape)
        w[0, 0] = 3.0                       # an exception-tensor weight
        want = jops.matmul_f16(jnp.asarray(x, jnp.float16), jnp.asarray(w),
                               backend="pallas_interpret", block=BLOCK)
        got = tops.matmul_f16(_t(x).half(), _t(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


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
    """K7: activations quantized inside the GEMM with 448/amax."""

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

    def test_quantizes_by_multiplying_with_the_inverse(self):
        # x * (448/amax) and x / (amax/448) can land one f32 ulp apart,
        # across an e4m3 rounding midpoint: here 368.0 (codes 352 / 384).
        # The fused kernel multiplies; quantize_act_per_tensor divides.
        x = torch.tensor([[2.4642856121063232, 3.0]])
        u = torch.full((2, 1), 0x38, dtype=torch.uint8)       # e4m3 1.0
        amax = tquant.absmax(x)
        got = tref.nestedfp8_matmul_fused_quant_ref(x, u, amax)
        want = torch.tensor([[384.0 + 448.0]]) * (amax / 448.0) * 2 ** -8
        assert torch.equal(got, want)
        xq, scale = tquant.quantize_act_per_tensor(x)
        assert xq.float().tolist() == [[352.0, 448.0]]

    def test_rows_independent_of_batch_given_amax(self):
        x, w = _gemm_inputs(19, 12, 256, 64)
        tu, _ = tnf.encode(_t(w))
        amax = tquant.absmax(_t(x))
        full = tops.matmul_nested_fp8_fused_quant(_t(x), tu, amax)
        one = tops.matmul_nested_fp8_fused_quant(_t(x)[3:4], tu, amax)
        np.testing.assert_array_equal(full[3:4].numpy(), one.numpy())


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
        assert tops.all_launch_counters() == before
        assert len(before) == 8

    def test_mixed_devices_raise(self):
        x = torch.zeros((4, 64), dtype=torch.float16)
        u = torch.zeros((64, 32), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError):
            tops.matmul_nested_f16(x, u, u)
