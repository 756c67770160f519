"""The port's Mamba2 block and the recurrent stacks' paged step against the
JAX package's, on mamba2-2.7b and zamba2-2.7b reduced (d_state 16, head
dim 32, chunk 32; zamba2 one shared-attention application over its 2
layers), with the JAX weights carried across (every layer's `out_proj`
an exception tensor: the JAX package nests the stacked tensor whole).

- The counterparts of the JAX package's own tests of the SSD
  (tests/test_mamba2.py): the chunked scan against the literal
  recurrence, decode steps continuing a prefill's state, a state that
  decays.
- Module parity at rtol 1e-5 / atol 1e-4 (the rule for plain GEMMs):
  `_causal_conv` with and without a state, `ssd_chunked` at lengths that
  are no multiple of the chunk, with and without an initial state,
  `ssd_decode_step`, and `mamba2_block` in its prefill, decode and paged
  phases, an inactive row keeping its state.
- `paged_step` logits within 3e-3 in FP16 and 0.25 in FP8 (F-port-1): a
  prompt in exact-length chunks routed to a slot, then batched decode
  steps with an idle slot."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           serving_pair)
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {"fp16": 3e-3, "fp8": 0.25}          # ROADMAP (F-port-1)
GEMM = dict(rtol=1e-5, atol=1e-4)          # plain-GEMM rule
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")


def plant_out_proj(params):
    """One element of the stacked out_proj set to 2.0: the JAX package
    nests the (L, K, N) tensor whole, so every layer's out_proj stays f16
    (an exception tensor, K3 on the card) while the input projections
    are nested."""
    w = params["layers"]["mamba"]["out_proj"]["w"]
    params["layers"]["mamba"]["out_proj"]["w"] = w.at[1, 0, 0].set(2.0)
    return params


_PAIRS: dict = {}


def ssm_pair(arch):
    """(jcfg, tcfg, JAX serving params, the port's copy), made once."""
    if arch not in _PAIRS:
        jcfg, tcfg = configs(arch)
        jsp, tsp = serving_pair(jcfg, tcfg.n_layers, False,
                                plant=plant_out_proj)
        _PAIRS[arch] = (jcfg, tcfg, jsp, tsp)
    return _PAIRS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return ssm_pair(request.param)


def _rts(mode, dtype=jnp.float32):
    return (JRuntime(mode=mode, backend="ref", dtype=dtype),
            TRuntime(mode=mode, dtype=torch.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# counterparts of tests/test_mamba2.py
# ---------------------------------------------------------------------------

def naive_ssd(x, dt, A, B, C, D):
    """Literal recurrence: S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T."""
    b, l, h, p = x.shape
    rep = h // B.shape[2]
    S = np.zeros((b, h, p, B.shape[3]))
    y = np.zeros((b, l, h, p))
    for t in range(l):
        for bi in range(b):
            for hi in range(h):
                gi = hi // rep
                dA = np.exp(dt[bi, t, hi] * A[hi])
                S[bi, hi] = dA * S[bi, hi] + dt[bi, t, hi] * np.outer(
                    x[bi, t, hi], B[bi, t, gi])
                y[bi, t, hi] = S[bi, hi] @ C[bi, t, gi] + D[hi] * x[bi, t, hi]
    return y, S


def _inputs(b=2, l=48, h=4, p=8, g=2, n=6, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, l, h, p).astype(np.float32)
    dt = r.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    A = -r.uniform(0.5, 2.0, h).astype(np.float32)
    B = r.randn(b, l, g, n).astype(np.float32)
    C = r.randn(b, l, g, n).astype(np.float32)
    D = r.randn(h).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("chunk", [8, 16, 48, 64])
def test_chunked_matches_naive(chunk):
    x, dt, A, B, C, D = _inputs()
    y_ref, S_ref = naive_ssd(x, dt, A, B, C, D)
    y, S = TM2.ssd_chunked(*map(_t, (x, dt, A, B, C, D)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S.numpy(), S_ref, rtol=2e-4, atol=2e-4)


def test_decode_step_continues_prefill_state():
    """prefill(L) state + decode steps == prefill(L + extra)."""
    x, dt, A, B, C, D = map(_t, _inputs(l=40))
    full_y, full_S = TM2.ssd_chunked(x, dt, A, B, C, D, chunk=16)
    split = 32
    _, S = TM2.ssd_chunked(x[:, :split], dt[:, :split], A, B[:, :split],
                           C[:, :split], D, chunk=16)
    ys = []
    for t in range(split, 40):
        y1, S = TM2.ssd_decode_step(S, x[:, t], dt[:, t], A, B[:, t],
                                    C[:, t], D)
        ys.append(y1)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               full_y[:, split:].numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(S.numpy(), full_S.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_state_decays_not_explodes():
    _, S = TM2.ssd_chunked(*map(_t, _inputs(l=96)), chunk=32)
    assert bool(torch.isfinite(S).all())


# ---------------------------------------------------------------------------
# module parity against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [1, 5])
def test_causal_conv_matches_jax(with_state, length):
    r = np.random.default_rng(length)
    u = r.standard_normal((2, length, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    st = (r.standard_normal((2, 3, 24)).astype(np.float16)
          if with_state else None)
    want, wst = JM2._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    got, gst = TM2._causal_conv(_t(u), _t(w), _t(b),
                                None if st is None else _t(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM)
    assert gst.dtype == torch.float32                  # promoted, as JAX's
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("length", [7, 32, 45])
def test_ssd_chunked_matches_jax(initial, length):
    """Lengths below, at and past the chunk of 32 (padded to whole
    chunks), with and without a carried-in state."""
    x, dt, A, B, C, D = _inputs(l=length, h=8, p=16, g=1, n=16, seed=length)
    s0 = (np.random.default_rng(1).standard_normal((2, 8, 16, 16))
          .astype(np.float32) if initial else None)
    want_y, want_s = JM2.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C, D)), chunk=32,
        initial_state=None if s0 is None else jnp.asarray(s0))
    got_y, got_s = TM2.ssd_chunked(*map(_t, (x, dt, A, B, C, D)), chunk=32,
                                   initial_state=None if s0 is None
                                   else _t(s0))
    assert got_y.shape == (2, length, 8, 16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **GEMM)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **GEMM)


def test_ssd_decode_step_matches_jax():
    x, dt, A, B, C, D = _inputs(l=1, h=8, p=16, g=2, n=16, seed=3)
    s0 = np.random.default_rng(2).standard_normal((2, 8, 16, 16)) \
        .astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    want_y, want_s = JM2.ssd_decode_step(jnp.asarray(s0),
                                         *map(jnp.asarray, args))
    got_y, got_s = TM2.ssd_decode_step(_t(s0), *map(_t, args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **GEMM)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **GEMM)


def _layer(jsp, tsp, i):
    return jax.tree.map(lambda a: a[i], jsp["layers"]), tsp["layers"][i]


def _state(tcfg, b, seed):
    """A random state {conv_x, conv_bc f16, ssm f32} of b rows."""
    d_inner, n_heads, _ = TM2.ssm_dims(tcfg)
    s = tcfg.ssm
    r = np.random.default_rng(seed)
    return {"conv_x": r.standard_normal((b, 3, d_inner)).astype(np.float16),
            "conv_bc": r.standard_normal((b, 3, 2 * s.d_state))
            .astype(np.float16),
            "ssm": (0.1 * r.standard_normal(
                (b, n_heads, s.head_dim, s.d_state))).astype(np.float32)}


def _assert_state(got, want, tol, kept=None):
    """The new state planes within `tol`, in the reference's dtypes; with
    kept = (old state, row), that row bitwise its old state."""
    for n in ("conv_x", "conv_bc", "ssm"):
        g, w = got[n].numpy(), np.asarray(want[n])
        assert g.dtype == w.dtype, n
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), **tol)
        if kept is not None:
            np.testing.assert_array_equal(g[kept[1]], kept[0][n][kept[1]])


_PLAIN: dict = {}


def _plain_layer(jcfg, i):
    """Layer i of the JAX training-form params (plain f32 linears), on
    both sides."""
    if jcfg.arch_id not in _PLAIN:
        _PLAIN[jcfg.arch_id] = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda a: a[i], _PLAIN[jcfg.arch_id]["layers"])
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.mark.parametrize("phase,seq", [("prefill", 40), ("decode", 1),
                                       ("paged", 37), ("paged", 1)])
@pytest.mark.parametrize("weights", ["plain", "fp16", "fp8"])
def test_mamba2_block_matches_jax(pair, phase, seq, weights):
    """Each phase; the paged one over 3 rows whose last has kv_len 0 and
    keeps its state verbatim. Plain f32 linears are held to the
    plain-GEMM rule; nested ones (FP16 or FP8 mode, the out_proj an
    exception tensor) to F-port-1's limits, since each nested GEMM
    re-rounds its input to f16 or e4m3."""
    jcfg, tcfg, jsp, tsp = pair
    if weights == "plain":
        jp, tp = _plain_layer(jcfg, 1)
        tol, mode = GEMM, "fp16"
    else:
        jp, tp = _layer(jsp, tsp, 1)
        assert tp["mamba"]["out_proj"].weight.is_exception
        assert not tp["mamba"]["in_x"].weight.is_exception
        tol, mode = dict(rtol=0, atol=TOL[weights]), weights
    b = 3 if phase == "paged" else 2
    x = np.random.default_rng(seq).standard_normal(
        (b, seq, tcfg.d_model)).astype(np.float32)
    st = None if phase == "prefill" else _state(tcfg, b, seq)
    kv = np.asarray([seq + 4, seq, 0], np.int32) if phase == "paged" else None
    jrt, trt = _rts(mode)
    want, wst = JM2.mamba2_block(
        jrt, jp["mamba"], jcfg, jnp.asarray(x), phase=phase,
        cache=None if st is None else jax.tree.map(jnp.asarray, st),
        kv_len=None if kv is None else jnp.asarray(kv))
    got, gst = TM2.mamba2_block(
        trt, tp["mamba"], tcfg, torch.from_numpy(x), phase=phase,
        cache=None if st is None else {k: _t(v) for k, v in st.items()},
        kv_len=None if kv is None else _t(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    _assert_state(gst, wst, tol, kept=None if kv is None else (st, 2))


# ---------------------------------------------------------------------------
# paged_step
# ---------------------------------------------------------------------------

def _jax_paged(jrt, jsp, jcfg, caches, toks, table, qo, kvl, lp, slot):
    ids_or_logits, caches = JM.paged_step(
        jrt, jsp, jcfg, jnp.asarray(toks), caches, jnp.asarray(table),
        q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kvl), block_size=16,
        logit_position=jnp.asarray(lp), return_logits=True,
        slot=None if slot is None else jnp.int32(slot))
    return np.asarray(ids_or_logits), caches


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_paged_step_logits_match_jax(pair, mode):
    """Slot 1's prompt of 40 tokens in two exact chunks (32 + 8, the
    second not a multiple of the chunk), routed to its state row, then
    3 batched decode steps over 3 slots of which slot 2 is idle (its
    state must stay zero); the shared attention's planes of a hybrid ride
    the block pool. Logits within TOL[mode], the state at the end within
    it too."""
    jcfg, tcfg, jsp, tsp = pair
    jrt, trt = _rts(mode)
    n_slots, nb = 3, 12
    jc = JM.init_paged_cache(jcfg, nb, 16, n_slots=n_slots)
    tc = TM.init_paged_cache(tcfg, nb, 16, n_slots=n_slots, device="cpu")
    tables = np.zeros((n_slots, 4), np.int32)
    tables[0], tables[1] = [1, 2, 3, 4], [5, 6, 7, 8]
    rng = np.random.default_rng(9)
    prompts = {0: rng.integers(1, tcfg.vocab_size, 19).astype(np.int32),
               1: rng.integers(1, tcfg.vocab_size, 40).astype(np.int32)}
    nxt = {}
    for slot, chunks in ((0, [(0, 19)]), (1, [(0, 32), (32, 8)])):
        for start, take in chunks:
            toks = prompts[slot][None, start:start + take]
            args = (tables[slot:slot + 1], np.asarray([start], np.int32),
                    np.asarray([start + take], np.int32),
                    np.asarray([take - 1], np.int32))
            want, jc = _jax_paged(jrt, jsp, jcfg, jc, toks, *args, slot)
            got = TM.paged_step(
                trt, tsp, tcfg, torch.from_numpy(toks), tc,
                torch.from_numpy(tables), q_offset=_t(args[1]),
                kv_len=_t(args[2]), block_size=16,
                logit_position=_t(args[3]),
                rows=torch.tensor([slot], dtype=torch.int32),
                slot=torch.tensor([slot], dtype=torch.int32),
                return_logits=True)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=TOL[mode])
        nxt[slot] = int(want[0].argmax())
    lens = np.asarray([19, 40, 0], np.int32)
    toks = np.zeros((n_slots, 1), np.int32)
    for _ in range(3):
        toks[0, 0], toks[1, 0] = nxt[0], nxt[1]
        kvl = np.where(lens > 0, lens + 1, 0).astype(np.int32)
        want, jc = _jax_paged(jrt, jsp, jcfg, jc, toks, tables, lens, kvl,
                              np.zeros(n_slots, np.int32), None)
        got = TM.paged_step(trt, tsp, tcfg, torch.from_numpy(toks), tc,
                            torch.from_numpy(tables), q_offset=_t(lens),
                            kv_len=_t(kvl), block_size=16,
                            return_logits=True)
        np.testing.assert_allclose(got.numpy()[:2], want[:2], rtol=0,
                                   atol=TOL[mode])
        nxt = {0: int(want[0].argmax()), 1: int(want[1].argmax())}
        lens = np.where(lens > 0, lens + 1, 0).astype(np.int32)
    for n, plane in tc["ssm"].items():
        assert not plane[:, 2].any(), f"idle slot 2's {n} was written"
        np.testing.assert_allclose(plane.float().numpy(),
                                   np.asarray(jc["ssm"][n], np.float32),
                                   rtol=0, atol=TOL[mode])


def test_recurrent_descriptors(pair):
    """The descriptor of each family equals the JAX package's, and the
    pools the engine makes from it have the JAX pools' shapes and dtypes
    (a pure SSM has no paged plane)."""
    jcfg, tcfg, _, _ = pair
    jd, td = JM.cache_descriptor(jcfg), TM.cache_descriptor(tcfg)
    assert td.kind == jd.kind and not td.prefix_cacheable
    assert td.bytes_per_token == jd.bytes_per_token
    assert td.bytes_per_slot == jd.bytes_per_slot > 0
    assert [(p.name, p.shape, p.dtype) for p in td.slot_planes] == \
        [(p.name, tuple(p.shape), p.dtype) for p in jd.slot_planes]
    assert [(p.name, p.n_layers, p.token_shape) for p in td.planes] == \
        [(p.name, p.n_layers, tuple(p.token_shape)) for p in jd.planes]
    jc = JM.init_paged_cache(jcfg, 5, 16, n_slots=3)
    tc = TM.init_paged_cache(tcfg, 5, 16, n_slots=3, device="cpu")
    assert {k: {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
                for n, p in v.items()} for k, v in tc.items()} == \
        {k: {n: (tuple(p.shape), str(p.dtype)) for n, p in v.items()}
         for k, v in jc.items()}
    with pytest.raises(ValueError, match="n_slots"):
        TM.init_paged_cache(tcfg, 5, 16, device="cpu")
    with pytest.raises(ValueError, match="planar"):
        TM.cache_descriptor(tcfg, planar=True)
    if tcfg.family == "hybrid":
        with pytest.raises(ValueError, match="attn_every"):
            TM.cache_descriptor(dataclasses.replace(tcfg, n_layers=3))
