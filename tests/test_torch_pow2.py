"""The port's per-channel pow2 scaling, `split_stats`, baseline weight
quantizers and error metrics against the JAX package's, on seeded
inputs: format bytes, exponents and codes bitwise, metrics within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import nestedfp as jnf  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import nestedfp as tnf  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402


def _weights(seed: int, shape=(64, 24)) -> np.ndarray:
    """f16 weights whose channels (last axis) cover each branch of the
    pow2 rule: ordinary ones (shift up), channels above 1.75 (shift down),
    one above 1.75 that also holds subnormals a shift down would round
    (falls back to k = 0), an all-zero channel, one of subnormals alone,
    one at exactly 1.75 and one beyond the f16 range of a shift (k
    clipped to 14)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 1, shape[-1])
         ).astype(np.float16)
    w[:, 1] *= np.float16(6.0)                         # above 1.75
    w[:, 2] = w[:, 1]
    w[3, 2] = np.float16(3 * 2.0 ** -24)               # inexact when halved
    w[:, 3] = 0                                        # all zero
    w[:, 4] = (rng.integers(-1023, 1024, shape[0]) * 2.0 ** -24
               ).astype(np.float16)                    # subnormals only
    w[:, 5] = np.float16(1.75) * np.sign(rng.normal(size=shape[0]))
    w[:, 6] = np.float16(2.0 ** -20)                   # k clipped to 14
    w[0, 7] = np.float16(100.0)                        # far above 1.75
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(64, 24), (3, 16, 12), (40,)])
def test_pow2_functions_equal_jax_bitwise(seed, shape):
    rows = int(np.prod(shape[:-1]))
    w = _weights(seed, (max(rows, 4), shape[-1]))[:rows].reshape(shape)
    tw = torch.from_numpy(w.copy())
    jk = np.asarray(jnf.pow2_channel_exponents(jnp.asarray(w)))
    tk = tnf.pow2_channel_exponents(tw)
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), jk)
    ju, jl, jk2 = (np.asarray(a) for a in jnf.encode_pow2(jnp.asarray(w)))
    tu, tl, tk2 = tnf.encode_pow2(tw)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tk2.numpy(), jk2)
    jd = np.asarray(jnf.decode_pow2(*map(jnp.asarray, (ju, jl, jk2))))
    td = tnf.decode_pow2(tu, tl, tk2)
    np.testing.assert_array_equal(td.numpy().view(np.uint16),
                                  jd.view(np.uint16))
    js = np.asarray(jnf.fp8_dequant_scale_pow2(jnp.asarray(jk2)))
    ts = tnf.fp8_dequant_scale_pow2(tk2)
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  js.view(np.uint32))
    assert bool(tnf.is_applicable_pow2(tw)) == bool(
        jnf.is_applicable_pow2(jnp.asarray(w)))


def test_pow2_covers_every_branch():
    """The seeded inputs reach each branch of the rule: a shift down, a
    fallback to k = 0 for an inexact shift, the clip at 14, and an
    applicable tensor once the channel above 1.75 is left out."""
    w = _weights(0)
    _, _, k = tnf.encode_pow2(torch.from_numpy(w))
    k = k.numpy()
    assert k[1] < 0 and k[2] == 0 and k[3] == 14 and k[6] == 14
    assert k[5] == 0 and (k[8:] > 0).any()
    assert not bool(tnf.is_applicable_pow2(torch.from_numpy(w)))
    ok = torch.from_numpy(np.delete(w, [2, 7], axis=1))
    assert bool(tnf.is_applicable_pow2(ok))
    assert not bool(tnf.is_applicable(ok))
    u, lo, kk = tnf.encode_pow2(ok)
    assert torch.equal(tnf.decode_pow2(u, lo, kk).view(torch.int16),
                       ok.view(torch.int16))


@pytest.mark.parametrize("seed", [0, 3])
def test_split_stats_equal_jax(seed):
    for w in (_weights(seed), _weights(seed)[:, 8:]):
        assert tnf.split_stats(torch.from_numpy(w.copy())) == \
            jnf.split_stats(jnp.asarray(w))


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_weight_quantizers_equal_jax_bitwise(seed, dtype):
    w = _weights(seed).astype(dtype)
    w[:, 3] = 0                                  # an all-zero channel
    tw = torch.from_numpy(w.copy())
    for tf, jf in ((tquant.quantize_weight_per_channel,
                    jquant.quantize_weight_per_channel),
                   (tquant.quantize_weight_per_tensor,
                    jquant.quantize_weight_per_tensor)):
        tq, ts = tf(tw)
        jq, js = jf(jnp.asarray(w))
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
        assert ts.dtype == torch.float32
        assert tuple(ts.shape) == tuple(np.shape(js))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 5])
def test_quant_error_metrics_equal_jax(seed):
    w = np.random.default_rng(seed).normal(size=(96, 80)).astype(np.float32)
    tq, ts = tquant.quantize_weight_per_channel(torch.from_numpy(w))
    w_hat = (tq.to(torch.float32) * ts).numpy()
    for hat in (w_hat, w, np.zeros_like(w)):
        got = tquant.quant_error_metrics(torch.from_numpy(w),
                                         torch.from_numpy(hat))
        want = jquant.quant_error_metrics(jnp.asarray(w), jnp.asarray(hat))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
