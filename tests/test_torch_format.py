"""NestedFP format and activation quantizers of the PyTorch port against the
JAX package: byte-identical over every f16 bit pattern and on seeded
random activations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import nestedfp as jnf  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import nestedfp as tnf  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402

ALL_F16 = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.float16)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 1 and x.dtype.kind not in "iub":
        return x.view(np.uint8)
    return x


class TestEncodeDecode:
    def test_encode_all_patterns_byte_identical(self):
        ju, jl = jnf.encode(jnp.asarray(ALL_F16))
        tu, tl = tnf.encode(_t(ALL_F16))
        np.testing.assert_array_equal(_np(tu), np.asarray(ju))
        np.testing.assert_array_equal(_np(tl), np.asarray(jl))

    def test_decode_all_byte_pairs_identical(self):
        # every (upper, lower) pair, including ones encode never emits
        u = np.repeat(np.arange(256, dtype=np.uint8), 256)
        l = np.tile(np.arange(256, dtype=np.uint8), 256)
        want = np.asarray(jnf.decode(jnp.asarray(u), jnp.asarray(l)))
        got = tnf.decode(_t(u), _t(l)).numpy()
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))

    def test_roundtrip_lossless_on_applicable_patterns(self):
        ok = tnf.is_applicable_values(_t(ALL_F16)).numpy()
        assert ok.sum() == np.asarray(
            jnf.is_applicable_values(jnp.asarray(ALL_F16))).sum()
        w = ALL_F16[ok]
        back = tnf.decode(*tnf.encode(_t(w))).numpy()
        np.testing.assert_array_equal(back.view(np.uint16), w.view(np.uint16))

    def test_fp8_view_and_dequant_match(self):
        w = np.random.default_rng(0).uniform(-1.75, 1.75, (64, 48)).astype(
            np.float16)
        ju, _ = jnf.encode(jnp.asarray(w))
        tu, _ = tnf.encode(_t(w))
        np.testing.assert_array_equal(
            tnf.fp8_dequant(tu).numpy(), np.asarray(jnf.fp8_dequant(ju)))

    def test_nested_tensor_exception_layout(self):
        w = np.random.default_rng(1).uniform(-1, 1, (16, 8)).astype(np.float16)
        t = tnf.NestedTensor.from_f16(_t(w))
        assert not t.is_exception and t.shape == (16, 8)
        np.testing.assert_array_equal(t.read_f16().numpy().view(np.uint16),
                                      w.view(np.uint16))
        w[3, 5] = 2.0
        e = tnf.NestedTensor.from_f16(_t(w))
        j = jnf.NestedTensor.from_f16(jnp.asarray(w))
        assert e.is_exception and j.is_exception
        assert e.upper is None and e.lower is None
        np.testing.assert_array_equal(e.read_f16().numpy(), np.asarray(j.raw))
        with pytest.raises(ValueError):
            e.read_fp8()
        assert bool(tnf.is_applicable(_t(w))) is False


class TestBytePlanes:
    def test_split_join_all_patterns(self):
        jh, jl = jnf.split_bytes(jnp.asarray(ALL_F16))
        th, tl = tnf.split_bytes(_t(ALL_F16))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        back = tnf.join_bytes(th, tl).numpy()
        np.testing.assert_array_equal(back.view(np.uint16),
                                      ALL_F16.view(np.uint16))

    @pytest.mark.parametrize("dtype", ["float32", "float16"])
    def test_e5m2_view_all_hi_bytes(self, dtype):
        hi = np.arange(256, dtype=np.uint8)
        want = np.asarray(jnf.e5m2_view(jnp.asarray(hi), getattr(jnp, dtype)))
        got = tnf.e5m2_view(_t(hi), getattr(torch, dtype)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_array_equal(got[fin], want[fin])


class TestActivationQuant:
    @pytest.mark.parametrize("shape", [(7, 96), (2, 5, 64), (1, 1, 300)])
    def test_per_token_byte_identical(self, shape):
        x = np.random.default_rng(2).normal(0, 3, shape).astype(np.float32)
        x[0, ..., 0] = 0.0
        jq, js = jquant.quantize_act_per_token(jnp.asarray(x))
        tq, ts = tquant.quantize_act_per_token(_t(x))
        np.testing.assert_array_equal(_np(tq), _np(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts.shape == tuple(js.shape)

    @pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
    def test_per_tensor_byte_identical(self, scale):
        x = (np.random.default_rng(3).standard_normal((33, 128))
             * scale).astype(np.float32)
        jq, js = jquant.quantize_act_per_tensor(jnp.asarray(x))
        tq, ts = tquant.quantize_act_per_tensor(_t(x))
        np.testing.assert_array_equal(_np(tq), _np(jq))
        assert float(ts) == float(js)

    def test_all_zero_rows_use_eps(self):
        x = np.zeros((3, 16), np.float32)
        jq, js = jquant.quantize_act_per_token(jnp.asarray(x))
        tq, ts = tquant.quantize_act_per_token(_t(x))
        np.testing.assert_array_equal(_np(tq), _np(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
