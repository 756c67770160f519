"""The dense-slot serving steps of the PyTorch port against the JAX
package's, on the same weights: `prefill` of ragged-length prompts into
f16 caches, optionally `planarize_cache`, then greedy `decode_step`s, in
fp16 and fp8 (per-tensor activation scale, the paper's scheme), over f16
and byte-planar caches; plus `launch/steps.py`.

Tolerances are those of tests/test_torch_model.py, for the reasons given
there (F-port-1): the two frameworks sum f32 in different orders and
both re-round activations to f16 or e4m3 before every nested GEMM, so
values next to a rounding boundary land on neighbouring codes. That also
holds for the cached keys and values themselves: the prefilled caches are
compared as values (to 5e-3 in fp16 mode, as the paged pools), while the
bytes that do not depend on the summation order — where the cache was
written, and the planes split from one f16 cache — are compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, flatten_serving, serving_pair  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_serving  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402

FP16_TOL = 3e-3
FP8_TOL = 0.25
# bf16 activations and bf16-rounded GEMM outputs (the serving runtime):
# a bf16 step is 2^-8 of a value, and both sides round often enough that
# neighbouring codes are common; logits (|z| <= ~4) then move by up to
# ~0.06 in fp16 mode and, where a step also flips an e4m3 code, ~0.25 in
# fp8 mode (measured on these inputs)
BF16_TOL = {"fp16": 0.1, "fp8": 0.5}
S, CAP, STEPS = 45, 56, 3

CASES = {
    "qwen": ("qwen1.5-0.5b", {}, False),
    # GQA with G = 2, untied head, one exception tensor
    "llama-gqa2": ("llama3.1-8b", {"n_kv_heads": 2}, True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def model_pair(request):
    arch, over, plant = CASES[request.param]
    jcfg, tcfg = configs(arch, **over)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant)
    return request.param, jcfg, tcfg, jsp, tsp


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (3, S)).astype(
        np.int32)


def _check_logits(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= tol, err.max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err.max()
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _values(caches, kind):
    c = {k: np.asarray(v) for k, v in caches["attn"].items()}
    if kind in c:
        return c[kind]
    bits = (c[f"{kind}_hi"].astype(np.uint16) << 8) | c[f"{kind}_lo"]
    return bits.view(np.float16)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_prefill_and_decode_match_jax(model_pair, mode, planar):
    _, jcfg, tcfg, jsp, tsp = model_pair
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode=mode, dtype=torch.float32)
    toks = _prompts(jcfg.vocab_size)
    want, jc, jn = JM.prefill(jrt, jsp, jcfg, {"tokens": jnp.asarray(toks)},
                              capacity=CAP)
    got, tc, tn = TM.prefill(trt, tsp, tcfg, {"tokens": torch.from_numpy(toks)},
                             capacity=CAP)
    assert tn == jn == S
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    _check_logits(got, want, tol)
    # caches: (L, B, Cap, Hkv, D) f16, written at [0, S), zero beyond
    for kind in ("k", "v"):
        g, w = _values(tc, kind), _values(jc, kind)
        assert g.shape == w.shape == (tcfg.n_layers, 3, CAP,
                                      tcfg.n_kv_heads, 64)
        assert g.dtype == w.dtype == np.float16
        assert not g[:, :, S:].view(np.uint16).any()
        assert not w[:, :, S:].view(np.uint16).any()
        if mode == "fp16":       # as tests/test_torch_model.py's pools
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), rtol=5e-3,
                                       atol=5e-3)
    if planar:
        jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt), jc, S + i)
        got, tc2 = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                  S + i)
        assert tc2 is tc                     # written in place
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    # decode wrote one token a step at positions S .. S+STEPS-1, nothing else
    g = _values(tc, "k")
    assert g[:, :, S:S + STEPS].view(np.uint16).any(axis=(0, 1, 3, 4)).all()
    assert not g[:, :, S + STEPS:].view(np.uint16).any()


def test_planarize_bytes_equal_jax(model_pair):
    """The same f16 cache splits into the same four planes."""
    _, jcfg, tcfg, _, _ = model_pair
    rng = np.random.default_rng(1)
    shape = (tcfg.n_layers, 2, 16, tcfg.n_kv_heads, 64)
    k, v = (rng.normal(size=shape).astype(np.float16) for _ in range(2))
    jp = JM.planarize_cache({"attn": {"k": jnp.asarray(k), "v": jnp.asarray(v)}})
    tp = TM.planarize_cache({"attn": {"k": torch.from_numpy(k),
                                      "v": torch.from_numpy(v)}})
    assert list(tp["attn"]) == ["k_hi", "k_lo", "v_hi", "v_lo"]
    for name in tp["attn"]:
        np.testing.assert_array_equal(tp["attn"][name].numpy(),
                                      np.asarray(jp["attn"][name]))


def test_init_cache_matches_jax(model_pair):
    _, jcfg, tcfg, _, _ = model_pair
    for planar in (False, True):
        jc = JM.init_cache(jcfg, 2, 24, planar=planar)["attn"]
        tc = TM.init_cache(tcfg, 2, 24, planar=planar, device="cpu")["attn"]
        assert sorted(jc) == sorted(tc)
        for name in tc:
            assert tuple(tc[name].shape) == tuple(jc[name].shape)
            assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)


def test_fp8_decode_reads_only_hi_planes(model_pair):
    _, _, tcfg, _, tsp = model_pair
    trt = TRuntime(mode="fp8", dtype=torch.float32)
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=2))
    _, tc, _ = TM.prefill(trt, tsp, tcfg, {"tokens": toks}, capacity=CAP)
    tc = TM.planarize_cache(tc)
    trashed = {"attn": {n: p.clone() for n, p in tc["attn"].items()}}
    for n in ("k_lo", "v_lo"):
        trashed["attn"][n].random_(0, 256,
                                   generator=torch.Generator().manual_seed(3))
    nxt = toks[:, -1:]
    a, _ = TM.decode_step(trt, tsp, tcfg, nxt, tc, S)
    b, _ = TM.decode_step(trt, tsp, tcfg, nxt, trashed, S)
    assert torch.equal(a, b)


def test_planar_decode_matches_f16_decode(model_pair, monkeypatch):
    """fp16 mode over the planes (K5) and over the f16 cache (the plain
    attn_core_decode) read the same values: the joined hi|lo planes are
    the f16 cache bit for bit, and layer 0's attention outputs (same
    inputs on both paths) agree to 1e-5, the two online-softmax sums
    differing only in f32 order. Past layer 0 each nested GEMM re-rounds
    its input to f16, so an ulp of difference can flip an f16 code and
    the logits are held at F-port-1's fp16 limit, with greedy agreement
    wherever the top-2 margin is clear."""
    _, _, tcfg, _, tsp = model_pair
    trt = TRuntime(mode="fp16", dtype=torch.float32)
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=4))
    _, tc, _ = TM.prefill(trt, tsp, tcfg, {"tokens": toks}, capacity=CAP)
    planes = TM.planarize_cache(tc)
    for kind in ("k", "v"):
        joined = (planes["attn"][f"{kind}_hi"].to(torch.int32) << 8
                  | planes["attn"][f"{kind}_lo"].to(torch.int32))
        assert torch.equal(joined, tc["attn"][kind].view(torch.int16)
                           .to(torch.int32) & 0xFFFF)
    first = {}

    def record(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            first.setdefault(name, out.reshape(out.shape[0], -1))
            return out
        return wrapped

    monkeypatch.setattr(TL, "attn_core_decode",
                        record("f16", TL.attn_core_decode))
    monkeypatch.setattr(ops, "planar_decode_attention",
                        record("planar", ops.planar_decode_attention))
    a, _ = TM.decode_step(trt, tsp, tcfg, toks[:, -1:], tc, S)
    b, _ = TM.decode_step(trt, tsp, tcfg, toks[:, -1:], planes, S)
    torch.testing.assert_close(first["planar"], first["f16"], rtol=1e-5,
                               atol=1e-5)
    _check_logits(b, a, FP16_TOL)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_steps_match_jax_steps(model_pair, mode):
    """launch/steps.py against the JAX package's: bf16 activations,
    fast_accum, per-tensor scales (the one fast_accum case; BF16_TOL)."""
    _, jcfg, tcfg, jsp, tsp = model_pair
    toks = _prompts(jcfg.vocab_size, seed=5)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=CAP)(
        jsp, {"tokens": jnp.asarray(toks)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=CAP)(
        tsp, {"tokens": torch.from_numpy(toks)})
    _check_logits(got, want, BF16_TOL[mode])
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(2):
        want, jc = jd(jsp, jc, jnp.asarray(nxt), S + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), S + i)
        _check_logits(got, want, BF16_TOL[mode])
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]


def test_serve_rt_matches_jax():
    for mode in ("fp16", "fp8"):
        j, t = JS.serve_rt(mode), TS.serve_rt(mode)
        assert (t.mode, t.fast_accum, t.act_quant) == \
            (j.mode, j.fast_accum, j.act_quant)
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_steps_round_trip_the_model_functions(model_pair):
    """The step builders are M.prefill / M.decode_step under serve_rt,
    bit for bit, and a per-row cache_len equals the scalar one."""
    _, _, tcfg, _, tsp = model_pair
    rt = TS.serve_rt("fp16")
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=6))
    a, ca = TS.make_prefill_step(tcfg, "fp16", capacity=CAP)(
        tsp, {"tokens": toks})
    b, cb, _ = TM.prefill(rt, tsp, tcfg, {"tokens": toks}, capacity=CAP)
    assert torch.equal(a, b)
    for n in ca["attn"]:
        assert torch.equal(ca["attn"][n], cb["attn"][n])
    nxt = toks[:, :1]
    a, _ = TS.make_decode_step(tcfg, "fp16")(tsp, ca, nxt, S)
    b, _ = TM.decode_step(rt, tsp, tcfg, nxt, cb,
                          torch.full((3,), S, dtype=torch.int32))
    assert torch.equal(a, b)


def test_decode_step_needs_a_free_position(model_pair):
    _, _, tcfg, _, tsp = model_pair
    trt = TRuntime(mode="fp16", dtype=torch.float32)
    caches = TM.init_cache(tcfg, 3, 8, device="cpu")
    with pytest.raises(ValueError, match="capacity 8"):
        TM.decode_step(trt, tsp, tcfg, torch.ones((3, 1), dtype=torch.int32),
                       caches, 8)


def test_prefill_logit_position(model_pair):
    _, _, tcfg, _, tsp = model_pair
    trt = TRuntime(mode="fp16", dtype=torch.float32)
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=7))
    short, _, _ = TM.prefill(trt, tsp, tcfg, {"tokens": toks[:, :20]})
    at, _, _ = TM.prefill(trt, tsp, tcfg, {"tokens": toks},
                          logit_position=19)
    torch.testing.assert_close(at, short, rtol=1e-5, atol=1e-5)


def test_layer_prefill_core_matches_jax():
    """The plain attn_core_prefill and attn_core_decode against the JAX
    package's, windowed and global."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 30, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 30, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 30, 2, 32)).astype(np.float32)
    for window in (None, 5):
        want = JL.attn_core_prefill(*map(jnp.asarray, (q, k, v)),
                                    window=window, block_k=8)
        got = TL.attn_core_prefill(*map(torch.from_numpy, (q, k, v)),
                                   window=window, block_k=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        lens = np.asarray([30, 3], np.int32)
        want = JL.attn_core_decode(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lens),
                                   window=window)
        got = TL.attn_core_decode(torch.from_numpy(q[:, :1]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(lens), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("entry", ["init_params", "init_paged_cache",
                                   "init_cache", "from_jax_serving"])
def test_default_device_needs_a_gpu(entry):
    """device=None means the card: without one every entry point raises
    (the tests pass device="cpu")."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_arch("qwen1.5-0.5b").reduced()
    calls = {
        "init_params": lambda: TM.init_params(cfg),
        "init_paged_cache": lambda: TM.init_paged_cache(cfg, 4, 8),
        "init_cache": lambda: TM.init_cache(cfg, 2, 16),
        "from_jax_serving": lambda: from_jax_serving(
            flatten_serving({"layers": {}}), 0),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_dense_path_on_cpu_counts_no_launches(model_pair):
    _, _, tcfg, _, tsp = model_pair
    before = ops.all_launch_counters()
    trt = TRuntime(mode="fp8", dtype=torch.float32)
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=9))
    _, tc, _ = TM.prefill(trt, tsp, tcfg, {"tokens": toks}, capacity=CAP)
    TM.decode_step(trt, tsp, tcfg, toks[:, :1], TM.planarize_cache(tc), S)
    assert ops.all_launch_counters() == before
