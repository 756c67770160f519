"""The dense-slot steps of the hybrid family in the port (zamba2-2.7b),
against the JAX package on the same weights (`M.init_params` ->
`to_serving` -> `from_jax_serving`, every out_proj an exception tensor),
inputs from a numpy seed.

- `prefill` pre-allocates the shared attention's f16 caches at capacity
  and runs the grouped stack (Mamba2 layers, the shared block after every
  attn_every-th); three `decode_step`s follow over f16 or planarized
  shared caches (K5 on the card) at the reduced head dim 64 and at
  zamba2's own 80. FP16 within 3e-3, FP8 within 0.25, with greedy
  agreement where the reference's top-2 margin exceeds twice the error
  (F-port-1); the state and the shared caches after the steps too.
- The bf16 serving steps (`steps.serve_rt`) within 0.1 / 0.5, the staged
  decode step's key (the shared caches' capacity) and its replay check.
- The caches' shapes and dtypes, planarized "shared" included.
- The plain K5 / K6 at head dim 80 against the Pallas kernels in
  interpret mode, at 2e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, one_torch_thread, serving_pair  # noqa: E402,F401
from repro.kernels.flash_prefill_attention import (  # noqa: E402
    flash_prefill_attention as j_flash_prefill)
from repro.kernels.planar_decode_attention import (  # noqa: E402
    planar_decode_attention as j_dense_attn)
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from test_torch_dense import BF16_TOL, FP8_TOL, FP16_TOL, _check_logits  # noqa: E402
from test_torch_kernels import ATTN_TOL, _dense_inputs, _t  # noqa: E402
from test_torch_ssm import plant_out_proj  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "zamba2-2.7b"
S, STEPS = 20, 3
_PAIRS: dict = {}


def hybrid_pair(head_dim=None):
    """(jcfg, tcfg, JAX serving params, the port's copy); head_dim=80 is
    zamba2's own shared-attention head dim at the reduced width."""
    if head_dim not in _PAIRS:
        over = {} if head_dim is None else {"head_dim": head_dim}
        jcfg, tcfg = configs(ARCH, **over)
        jsp, tsp = serving_pair(jcfg, tcfg.n_layers, False,
                                plant=plant_out_proj)
        _PAIRS[head_dim] = (jcfg, tcfg, jsp, tsp)
    return _PAIRS[head_dim]


def _tokens(cfg, seed, b=3):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, S)).astype(np.int32)


def _np(t):
    return t.float().numpy() if t.dtype != torch.uint8 else t.numpy()


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("head_dim", [None, 80])
def test_prefill_and_decode_match_jax(head_dim, mode, planar):
    jcfg, tcfg, jsp, tsp = hybrid_pair(head_dim)
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode=mode, dtype=torch.float32)
    toks = _tokens(tcfg, 1)
    cap = S + 8
    want, jc, jn = JM.prefill(jrt, jsp, jcfg, {"tokens": jnp.asarray(toks)},
                              capacity=cap)
    got, tc, tn = TM.prefill(trt, tsp, tcfg, {"tokens": torch.from_numpy(toks)},
                             capacity=cap)
    assert tn == jn == S
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    _check_logits(got, want, tol)
    for n in ("k", "v"):          # f16, written at [0, S), zero beyond
        g, w = tc["shared"][n].numpy(), np.asarray(jc["shared"][n])
        assert g.dtype == w.dtype == np.float16 and g.shape == w.shape
        assert not g[:, :, S:].view(np.uint16).any()
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=0, atol=5e-3 if mode == "fp16" else tol)
    if planar:
        jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
        assert set(tc["shared"]) == {"k_hi", "k_lo", "v_hi", "v_lo"}
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt), jc, S + i)
        got, tc2 = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                  S + i)
        assert tc2 is tc                     # written in place
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for n, plane in tc["ssm"].items():
        np.testing.assert_allclose(_np(plane), np.asarray(jc["ssm"][n],
                                                          np.float32),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_steps_match_jax_steps(mode):
    """bf16 serving steps at zamba2's head dim 80: prefill, planarize, then
    staged decode steps (one key: the shared caches' capacity)."""
    jcfg, tcfg, jsp, tsp = hybrid_pair(80)
    toks = _tokens(tcfg, 2)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=S + 8)(
        jsp, {"tokens": jnp.asarray(toks)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=S + 8)(
        tsp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_TOL[mode])
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = jd(jsp, jc, jnp.asarray(nxt), S + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=BF16_TOL[mode])
        nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    (key,) = td.keys()
    assert key[1] == S + 8 and key[2]         # the shared capacity, planar
    same = td.check_replay(tsp, tc, torch.from_numpy(nxt), S + STEPS)
    assert same == {"logits": True, "conv_x": True, "conv_bc": True,
                    "ssm": True, "k_hi": True, "k_lo": True, "v_hi": True,
                    "v_lo": True}
    with pytest.raises(ValueError, match="capacity 28"):
        td(tsp, tc, torch.from_numpy(nxt), S + 8)


def test_cache_shapes_and_dtypes_match_jax():
    """init_cache: the state (L, B, ...) and the shared caches (L //
    attn_every, B, Cap, Hkv, D) f16; planarized: four u8 planes, the
    state as it was."""
    jcfg, tcfg, jsp, tsp = hybrid_pair(80)
    jc = JM.init_cache(jcfg, 2, 40)
    tc = TM.init_cache(tcfg, 2, 40, device="cpu")
    for cj, ct in ((jc, tc), (JM.planarize_cache(jc), TM.planarize_cache(tc))):
        assert set(cj) == set(ct) == {"ssm", "shared"}
        for sub in ct:
            assert set(ct[sub]) == set(cj[sub])
            for n, t in ct[sub].items():
                assert tuple(t.shape) == tuple(cj[sub][n].shape)
                assert str(t.dtype).split(".")[-1] == str(cj[sub][n].dtype)
    assert tuple(tc["shared"]["k"].shape) == (1, 2, 40, 4, 80)
    assert TM.cache_capacity(tc) == 40
    planar = TM.planarize_cache(tc)
    assert planar["ssm"] is tc["ssm"]


# -- the plain K5 / K6 at head dim 80 against the Pallas kernels ----------

@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_dense_decode_matches_pallas_at_head_dim_80(h, hkv, window, fp8):
    q, planes, lens = _dense_inputs(51, h=h, hkv=hkv, d=80)
    want = np.asarray(j_dense_attn(
        jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(lens),
        fp8=fp8, block_c=16, window=window, interpret=True))
    tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
    got = tops.planar_decode_attention(_t(q), tp, _t(lens), fp8=fp8,
                                       window=window).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_prefill_matches_pallas_at_head_dim_80(h, hkv):
    rng = np.random.default_rng(52)
    q, k, v = (rng.normal(size=(2, 128, n, 80)).astype(np.float32)
               for n in (h, hkv, hkv))
    want = np.asarray(j_flash_prefill(*map(jnp.asarray, (q, k, v)),
                                      block=(32, 64), interpret=True))
    got = tops.flash_prefill_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)
