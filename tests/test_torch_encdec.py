"""The encoder-decoder family in the port (seamless-m4t-large-v2), against
the JAX package on the same weights (`M.init_params` -> `to_serving` ->
`from_jax_serving`), inputs from a numpy seed.

- The config equals the JAX package's field by field, full and reduced.
- `cross_attention` (over the memory, and over a given cache) and
  `encode_memory` (the stub frontend's projection, the bidirectional
  encoder stack, `enc_norm`) in f32.
- The dense-slot steps: `prefill` with stub frames (the encoder runs
  inside), then three `decode_step`s through the cross caches, FP16
  within 3e-3 and FP8 within 0.25 with greedy agreement where the
  reference's top-2 margin exceeds twice the error (F-port-1), the
  decoder on the JAX encoder's memory; the whole chain (4 layers deep)
  FP8 within 0.35 (F-port-8's limit), f16 and planar self-attention
  caches; the bf16 serving steps within 0.1 / 0.5;
  the caches: "attn" f16 at capacity, "cross" in the activation dtype,
  unpadded, as the JAX package returns them, and `init_cache`'s f16.
- Both engines refuse encdec with NotImplementedError, and `paged_step`
  with ValueError, as the JAX package does.
- The streamed build is bitwise `to_serving(init_params)`; the
  structural reckoning of the full config equals the JAX package's;
  checkpoints of the encoder and cross trees cross both ways."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (configs, flatten_serving,  # noqa: E402
                           one_torch_thread, serving_pair)  # noqa: F401
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.convert import to_serving as j_to_serving  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (from_jax_serving,  # noqa: E402
                                        serving_memory_bytes, to_serving)
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from test_torch_dense import BF16_TOL, FP8_TOL, FP16_TOL, _check_logits  # noqa: E402
from test_torch_moe_load import _assert_trees_equal, _fields  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "seamless-m4t-large-v2"
S, STEPS = 24, 3
F32 = dict(rtol=1e-5, atol=1e-5)
DEEP_FP8_TOL = 0.35          # FP8 stacks deeper than 2 layers (ROADMAP §3)
_PAIR: list = []


def encdec_pair():
    """(jcfg, tcfg, JAX serving params, the port's copy), made once; layer
    1's self-attention wo an exception tensor."""
    if not _PAIR:
        jcfg, tcfg = configs(ARCH)
        jsp, tsp = serving_pair(jcfg, tcfg.n_layers, True)
        _PAIR.append((jcfg, tcfg, jsp, tsp))
    return _PAIR[0]


def _batch(cfg, seed, b=3, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.normal(size=(b, TM.encdec_enc_len(s), cfg.frontend_dim)
                        ).astype(np.float32)
    return toks, frames


def _rts(mode):
    return (JRuntime(mode=mode, backend="ref", dtype=jnp.float32),
            TRuntime(mode=mode, dtype=torch.float32))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(reduced):
    t, j = TARCHS[ARCH], JARCHS[ARCH]
    if reduced:
        t, j = t.reduced(), j.reduced()
    tf, jf = _fields(t), _fields(j)
    assert tf == {k: jf[k] for k in tf} and set(tf) == set(jf)
    assert t.cache_kind == j.cache_kind == "encdec"
    assert t.n_enc_layers == (2 if reduced else 24)
    assert [TM.encdec_enc_len(s) for s in (1, 512, 1024, 4096)] == \
        [JM.encdec_enc_len(s) for s in (1, 512, 1024, 4096)] == \
        [64, 64, 128, 512]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_cross_attention_matches_jax(mode):
    """Over the memory (its projections made and returned), then over
    that cache (the memory not read)."""
    jcfg, tcfg, jsp, tsp = encdec_pair()
    jrt, trt = _rts(mode)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 64, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jsp["layers"])["cross"]
    tp = tsp["layers"][1]["cross"]
    want, jc = JL.cross_attention(jrt, jp, jcfg, jnp.asarray(x),
                                  jnp.asarray(mem))
    got, tc = TL.cross_attention(trt, tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(mem))
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == tuple(jc[n].shape) == (2, 64, 4, 64)
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=0,
                                   atol=tol)
    again, same = TL.cross_attention(trt, tp, tcfg, torch.from_numpy(x), None,
                                     cache=tc)
    assert same is tc
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_attn_core_train_matches_jax():
    """Materialized scores: causal with q_offset and window, cross,
    bidirectional, and a kv_len prefix, in f32."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 11, 2, 64)).astype(np.float32)
            for _ in range(2))
    for kw in ({}, {"q_offset": 4, "window": 5}, {"cross": True},
               {"causal": False}, {"kv_len": 9, "causal": False}):
        want = np.asarray(JL.attn_core_train(*map(jnp.asarray, (q, k, v)),
                                             **kw))
        got = TL.attn_core_train(*map(torch.from_numpy, (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), want, **F32), kw


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_encode_memory_matches_jax(mode):
    jcfg, tcfg, jsp, tsp = encdec_pair()
    jrt, trt = _rts(mode)
    _, frames = _batch(tcfg, 7, b=2)
    want = JM.encode_memory(jrt, jsp, jcfg, jnp.asarray(frames))
    got = TM.encode_memory(trt, tsp, tcfg, torch.from_numpy(frames))
    assert tuple(got.shape) == tuple(want.shape) == (2, 64, tcfg.d_model)
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("memory", ["shared", "own"])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_prefill_and_decode_match_jax(mode, planar, memory, monkeypatch):
    """memory "shared": the port's decoder reads the JAX encoder's memory
    (a 2-layer stack, held at F-port-1's 3e-3 / 0.25); "own": each side
    runs its own encoder, so the FP8 chain is 2 encoder + 2 decoder
    layers deep, where e4m3 re-rounding parts two correct
    implementations by more than 0.25 (0.15-0.31 on these weights over
    four seeds; the decoder alone reads 0.06-0.23): it is held at 0.35,
    the limit that ROADMAP §3 sets for FP8 stacks deeper than 2 layers
    (F-port-8). FP16 is held at 3e-3 either way."""
    jcfg, tcfg, jsp, tsp = encdec_pair()
    jrt, trt = _rts(mode)
    toks, frames = _batch(tcfg, 1)
    cap = S + 8
    want, jc, jn = JM.prefill(jrt, jsp, jcfg, {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        capacity=cap)
    if memory == "shared":
        jm = np.array(JM.encode_memory(jrt, jsp, jcfg, jnp.asarray(frames)))
        monkeypatch.setattr(TM, "encode_memory",
                            lambda *a: torch.from_numpy(jm))
    got, tc, tn = TM.prefill(trt, tsp, tcfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)},
        capacity=cap)
    assert tn == jn == S
    tol = FP16_TOL if mode == "fp16" else (
        FP8_TOL if memory == "shared" else DEEP_FP8_TOL)
    _check_logits(got, want, tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["cross"][n].numpy(),
                                   np.asarray(jc["cross"][n]), rtol=0, atol=tol)
    if planar:
        jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
        assert set(tc["attn"]) == {"k_hi", "k_lo", "v_hi", "v_lo"}
        assert set(tc["cross"]) == {"k", "v"}      # cross stays as it is
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt), jc, S + i)
        got, _ = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                S + i)
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_steps_match_jax_steps(mode):
    """bf16 serving steps, frames in bf16 as `batch_specs` shapes them;
    the staged decode step's key holds the cross caches too."""
    jcfg, tcfg, jsp, tsp = encdec_pair()
    toks, frames = _batch(tcfg, 3)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=S + 8)(jsp, {
        "tokens": jnp.asarray(toks),
        "frames": jnp.asarray(frames).astype(jnp.bfloat16)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=S + 8)(tsp, {
        "tokens": torch.from_numpy(toks),
        "frames": torch.from_numpy(frames).to(torch.bfloat16)})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_TOL[mode])
    assert tc["cross"]["k"].dtype == torch.bfloat16
    assert str(jc["cross"]["k"].dtype) == "bfloat16"
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
    assert key[1] == S + 8                     # "attn"'s capacity, not 64
    assert {n for n, *_ in key[3]} == {"k_hi", "k_lo", "v_hi", "v_lo",
                                       "k", "v"}
    same = td.check_replay(tsp, tc, torch.from_numpy(nxt), S + STEPS)
    assert same == {"logits": True, "k_hi": True, "k_lo": True, "v_hi": True,
                    "v_lo": True, "k": True, "v": True}


def test_cache_shapes_and_dtypes_match_jax():
    """prefill: "attn" f16 (L, B, Cap, Hkv, D), "cross" (L, B, Senc, Hkv,
    D) in the activation dtype, unpadded; init_cache: both f16, the cross
    length encdec_enc_len(Cap)."""
    jcfg, tcfg, jsp, tsp = encdec_pair()
    jrt, trt = _rts("fp16")
    toks, frames = _batch(tcfg, 8, b=2, s=10)
    _, jc, _ = JM.prefill(jrt, jsp, jcfg, {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        capacity=16)
    _, tc, _ = TM.prefill(trt, tsp, tcfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)},
        capacity=16)
    assert set(tc) == set(jc) == {"attn", "cross"}
    for sub in ("attn", "cross"):
        for n, t in tc[sub].items():
            assert tuple(t.shape) == tuple(jc[sub][n].shape)
            assert str(t.dtype).split(".")[-1] == str(jc[sub][n].dtype)
    assert tuple(tc["attn"]["k"].shape) == (2, 2, 16, 4, 64)
    assert tuple(tc["cross"]["k"].shape) == (2, 2, 64, 4, 64)
    assert TM.cache_capacity(tc) == 16
    ji = JM.init_cache(jcfg, 2, 1024)
    ti = TM.init_cache(tcfg, 2, 1024, planar=True, device="cpu")
    assert set(ti) == set(ji) == {"attn", "cross"}
    for sub in ("attn", "cross"):
        assert set(ti[sub]) == set(ji[sub]) == {"k", "v"}
        for n, t in ti[sub].items():
            assert tuple(t.shape) == tuple(ji[sub][n].shape)
            assert t.dtype == torch.float16
    assert ti["cross"]["k"].shape[2] == 128


def test_both_engines_refuse_encdec():
    jcfg, tcfg, jsp, tsp = encdec_pair()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        JEngine(jcfg, jsp, n_slots=2, capacity=32)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        TEngine(tcfg, tsp, n_slots=2, capacity=32, device="cpu")
    with pytest.raises(NotImplementedError):
        JM.cache_descriptor(jcfg)
    with pytest.raises(NotImplementedError):
        TM.cache_descriptor(tcfg)
    jrt, trt = _rts("fp16")
    tok = np.ones((1, 1), np.int32)
    with pytest.raises(ValueError, match="decoder-only"):
        JM.paged_step(jrt, jsp, jcfg, jnp.asarray(tok), {}, jnp.zeros((1, 1)),
                      q_offset=jnp.zeros(1), kv_len=jnp.ones(1), block_size=16)
    with pytest.raises(ValueError, match="decoder-only"):
        TM.paged_step(trt, tsp, tcfg, torch.from_numpy(tok), {},
                      torch.zeros((1, 1), dtype=torch.int32),
                      q_offset=torch.zeros(1), kv_len=torch.ones(1),
                      block_size=16)


# -- loading -----------------------------------------------------------------

def _plant(i, path, w):
    if (i, path) in ((1, "cross/wo/w"), (("enc_layers", 0), "attn/wo/w")):
        w[0, 0] = 2.0


def test_streamed_build_is_bitwise_to_serving_of_init_params():
    """The encoder layers first, then the decoder layers with their cross
    blocks, `enc_norm` and the unnested `frontend_proj` last; planted
    exception tensors in a decoder's cross wo and an encoder's wo."""
    cfg = TARCHS[ARCH].reduced()
    params = TM.init_params(cfg, seed=6, device="cpu")
    _plant(1, "cross/wo/w", params["layers"][1]["cross"]["wo"]["w"])
    _plant(("enc_layers", 0), "attn/wo/w",
           params["enc_layers"][0]["attn"]["wo"]["w"])
    got = TM.init_serving_params(cfg, seed=6, device="cpu", plant=_plant)
    _assert_trees_equal(got, to_serving(params))
    assert len(got["enc_layers"]) == cfg.n_enc_layers
    assert got["layers"][1]["cross"]["wo"].weight.is_exception
    assert got["enc_layers"][0]["attn"]["wo"].weight.is_exception
    assert not got["layers"][0]["cross"]["wk"].weight.is_exception
    assert got["frontend_proj"]["w"].dtype == torch.float32
    assert "cross" not in got["enc_layers"][0]


def test_structural_reckoning_equals_jax():
    """Nested bytes of the full config on meta tensors: 24 encoder layers,
    24 decoder layers with cross-attention (~3.1 GB nested)."""
    cfg = TARCHS[ARCH]
    meta = to_serving(TM.init_params(cfg, device="meta"), structural=True)
    mem = serving_memory_bytes(meta)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   JARCHS[ARCH]))
    jtree = j_to_serving(shapes, structural=True)
    leaves = jax.tree_util.tree_leaves(jtree)
    assert mem["nested_bytes"] == sum(int(np.prod(x.shape)) for x in leaves
                                      if x.dtype == jnp.uint8)
    assert mem["other_bytes"] == sum(int(np.prod(x.shape)) * x.dtype.itemsize
                                     for x in leaves if x.dtype != jnp.uint8)
    assert 3.0e9 < mem["nested_bytes"] < 3.2e9


def test_from_jax_serving_carries_every_tree():
    """enc_layers split per layer, the cross subtrees, enc_norm and
    frontend_proj, bitwise the JAX serving tree's."""
    jcfg, tcfg, jsp, tsp = encdec_pair()
    flat = flatten_serving(jsp)
    assert len(tsp["enc_layers"]) == tcfg.n_enc_layers
    for i in range(tcfg.n_enc_layers):
        np.testing.assert_array_equal(
            tsp["enc_layers"][i]["attn"]["wq"].weight.upper.numpy(),
            flat["enc_layers/attn/wq/weight/upper"][i])
    for i in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            tsp["layers"][i]["cross"]["wv"].weight.lower.numpy(),
            flat["layers/cross/wv/weight/lower"][i])
        np.testing.assert_array_equal(tsp["layers"][i]["ln_cross"].numpy(),
                                      flat["layers/ln_cross"][i])
    np.testing.assert_array_equal(tsp["enc_norm"].numpy(), flat["enc_norm"])
    np.testing.assert_array_equal(tsp["frontend_proj"]["w"].numpy(),
                                  flat["frontend_proj/w"])


def test_checkpoints_cross_both_ways(tmp_path):
    jcfg, tcfg = JARCHS[ARCH].reduced(), TARCHS[ARCH].reduced()
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jio.save(str(tmp_path / "j"), {"params": params}, step=4)
    got, step = tio.restore(str(tmp_path / "j"), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu",
        serving=True)
    assert step == 4
    want = from_jax_serving(flatten_serving(j_to_serving(params)),
                            tcfg.n_layers, device="cpu")
    _assert_trees_equal(got["params"], want, ordered=False)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    tio.save(str(tmp_path / "t"), {"params": tp})
    back, _ = jio.restore(str(tmp_path / "t"), {"params": params})
    b = back["params"]
    for i in range(tcfg.n_enc_layers):
        np.testing.assert_array_equal(
            np.asarray(b["enc_layers"]["mlp"]["up"]["w"][i]),
            tp["enc_layers"][i]["mlp"]["up"]["w"].numpy())
    for i in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            np.asarray(b["layers"]["cross"]["wk"]["w"][i]),
            tp["layers"][i]["cross"]["wk"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(b["enc_norm"]),
                                  tp["enc_norm"].numpy())
