"""`paged_step` of the PyTorch port against the JAX package's, on the same
weights: chunked prefill of two ragged rows, then batched decode, in fp16
and fp8, planar and non-planar pools.

Tolerances, and why they are not 2e-4 end to end: the two frameworks sum
f32 GEMMs and reductions in different orders, so activations differ in
their last bits (~1e-7 relative). Both modes then re-round activations to
a narrow type before every nested GEMM — f16 in fp16 mode, e4m3 in fp8
mode — and where a value sits next to a rounding boundary the two sides
round it to neighbouring codes. In fp16 mode these one-ulp (2^-11) steps
are frequent and small: logits move by ~1e-3 (measured <= 1.5e-3 on
these inputs), hence FP16_TOL. In fp8 mode steps are rare and large (one
e4m3 step is 1/16 of the value): a step where none occurs leaves the
logits equal to ~2e-6, a step where one occurs moves a row by up to
~0.1. So fp8 logits are held to FP8_TOL, and both modes must pick the
same greedy token wherever the JAX top-2 margin exceeds twice the
error. The kernel-level parity (tests/test_torch_kernels.py), where both
sides see identical inputs, holds at rtol 1e-5 / atol 1e-4 and 2e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, serving_pair  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import serving_memory_bytes  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402

FP16_TOL = 3e-3
FP8_TOL = 0.25
BS = 8
TABLES = np.asarray([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)

CASES = {
    "qwen": ("qwen1.5-0.5b", {}, False),
    # GQA with G = 2 (the reduced configs have Hkv = H = 4), untied head,
    # and one exception tensor
    "llama-gqa2": ("llama3.1-8b", {"n_kv_heads": 2}, True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def model_pair(request):
    arch, over, plant = CASES[request.param]
    jcfg, tcfg = configs(arch, **over)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant)
    return request.param, jcfg, tcfg, jsp, tsp


def _schedule(seed, vocab):
    """Chunks as (tokens (2, C), q_offset, kv_len, logit_position, live
    rows): row 0 prefills 23 tokens in chunks of 16 and 7; row 1 prefills
    9 tokens and its first decode token rides the second chunk."""
    rng = np.random.default_rng(seed)
    p0 = rng.integers(1, vocab, 23)
    p1 = rng.integers(1, vocab, 9)
    c1 = np.zeros((2, 16), np.int32)
    c1[0], c1[1, :9] = p0[:16], p1
    c2 = np.zeros((2, 16), np.int32)
    c2[0, :7] = p0[16:]
    return [(c1, [0, 0], [16, 9], [15, 8]),
            (c2, [16, 9], [23, 10], [6, 0])]


def test_exception_tensor_carried(model_pair):
    name, _, _, jsp, tsp = model_pair
    wo = [layer["attn"]["wo"].weight for layer in tsp["layers"]]
    # the JAX tree nests the stacked (L, K, N) tensor as a whole
    assert all(w.is_exception for w in wo) == (name == "llama-gqa2")
    if name == "llama-gqa2":
        np.testing.assert_array_equal(
            wo[1].raw.numpy(), np.asarray(jsp["layers"]["attn"]["wo"].weight.raw[1]))
    assert serving_memory_bytes(tsp)["nested_bytes"] > 0


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_paged_step_logits_match(model_pair, mode, planar):
    _, jcfg, tcfg, jsp, tsp = model_pair
    nb = 1 + TABLES.size
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32,
                   act_quant="per_token")
    trt = TRuntime(mode=mode, dtype=torch.float32, act_quant="per_token")
    jc = JM.init_paged_cache(jcfg, nb, BS, planar=planar)
    tc = TM.init_paged_cache(tcfg, nb, BS, planar=planar, device="cpu")
    steps = _schedule(11, jcfg.vocab_size)
    for _ in range(2):                       # then two C=1 decode steps
        steps.append(None)
    lens = None
    for s in steps:
        if s is None:                       # decode: teacher-forced tokens
            toks = np.asarray(want.argmax(-1), np.int32)[:, None]
            s = (toks, lens, lens + 1, None)
        toks, qo, kvl, lp = (np.asarray(a, np.int32) if a is not None else None
                             for a in s)
        want, jc = JM.paged_step(
            jrt, jsp, jcfg, jnp.asarray(toks), jc, jnp.asarray(TABLES),
            q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kvl), block_size=BS,
            logit_position=None if lp is None else jnp.asarray(lp),
            return_logits=True)
        got = TM.paged_step(
            trt, tsp, tcfg, torch.from_numpy(toks), tc,
            torch.from_numpy(TABLES), q_offset=torch.from_numpy(qo),
            kv_len=torch.from_numpy(kvl), block_size=BS,
            logit_position=None if lp is None else torch.from_numpy(lp),
            return_logits=True)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        assert err.max() <= (FP16_TOL if mode == "fp16" else FP8_TOL), \
            err.max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err.max()
        np.testing.assert_array_equal(got.numpy().argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        lens = kvl
    # the pools were written at the same places, with the same values up
    # to the mode's rounding steps (planar pools compared as joined f16);
    # block 0 is the trash block, whose pad-column writes collide
    for kind in ("k", "v"):
        got_kv = _pool_values(tc, kind)[:, 1:]
        want_kv = _pool_values(jc, kind)[:, 1:]
        np.testing.assert_array_equal(got_kv != 0, want_kv != 0)
        if mode == "fp16":
            np.testing.assert_allclose(got_kv, want_kv, rtol=5e-3, atol=5e-3)


def _pool_values(caches, kind):
    c = {k: np.asarray(v) for k, v in caches["attn"].items()}
    if kind in c:
        return c[kind].astype(np.float32)
    bits = (c[f"{kind}_hi"].astype(np.uint16) << 8) | c[f"{kind}_lo"]
    return bits.view(np.float16).astype(np.float32)


def test_sampling_returns_argmax_ids(model_pair):
    _, _, tcfg, _, tsp = model_pair
    trt = TRuntime(mode="fp16", dtype=torch.float32, act_quant="per_token")
    tc = TM.init_paged_cache(tcfg, 1 + TABLES.size, BS, planar=True,
                            device="cpu")
    toks, qo, kvl, lp = (torch.from_numpy(np.asarray(a, np.int32))
                         for a in _schedule(12, tcfg.vocab_size)[0])
    tab = torch.from_numpy(TABLES)
    kw = dict(q_offset=qo, kv_len=kvl, block_size=BS, logit_position=lp)
    logits = TM.paged_step(trt, tsp, tcfg, toks, tc, tab, return_logits=True,
                           **kw)
    tc2 = TM.init_paged_cache(tcfg, 1 + TABLES.size, BS, planar=True,
                             device="cpu")
    ids = TM.paged_step(trt, tsp, tcfg, toks, tc2, tab, **kw)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), logits.argmax(-1).numpy())
