"""The vision-language family in the port (phi-3-vision-4.2b), against the
JAX package on the same weights (`M.init_params` -> `to_serving` ->
`from_jax_serving`), inputs from a numpy seed.

- The config equals the JAX package's field by field, full and reduced.
- The dense-slot steps: `prefill` with the stub frontend's patch
  embeddings prepended to the text, then three `decode_step`s, f32
  activations, FP16 within 3e-3 and FP8 within 0.25 with greedy
  agreement where the reference's top-2 margin exceeds twice the error
  (F-port-1), at the reduced head dim 64 and at phi3's 96, over f16 and
  planar caches; the bf16 serving steps (`steps.serve_rt`) within 0.1 /
  0.5; the caches' shapes and dtypes.
- The paged engine serves phi3 as a text-only GQA decoder, as the JAX
  engine does: tokens and counters equal on a shared request set.
- The plain K4 / K5 / K6 at head dim 96 against the Pallas kernels in
  interpret mode, at 2e-4.
- The streamed build is bitwise `to_serving(init_params)`, the stub
  frontend's projection unnested; checkpoints cross both ways."""

import dataclasses

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
from repro.configs.base import InputShape  # noqa: E402
from repro.kernels.flash_prefill_attention import (  # noqa: E402
    flash_prefill_attention as j_flash_prefill)
from repro.kernels.planar_decode_attention import (  # noqa: E402
    paged_planar_decode_attention as j_paged_attn)
from repro.kernels.planar_decode_attention import (  # noqa: E402
    planar_decode_attention as j_dense_attn)
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.convert import to_serving as j_to_serving  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_serving, to_serving  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_dense import BF16_TOL, FP8_TOL, FP16_TOL, _check_logits  # noqa: E402
from test_torch_kernels import (ATTN_TOL, _dense_inputs,  # noqa: E402
                                _paged_inputs, _t)
from test_torch_moe_load import _assert_trees_equal, _fields  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "phi-3-vision-4.2b"
S, STEPS = 20, 3
_PAIRS: dict = {}


def vlm_pair(head_dim=None):
    """(jcfg, tcfg, JAX serving params, the port's copy), layer 1's wo an
    exception tensor; head_dim=96 gives phi3's own head dim at the
    reduced width (4 heads of 96)."""
    if head_dim not in _PAIRS:
        over = {} if head_dim is None else {"head_dim": head_dim}
        jcfg, tcfg = configs(ARCH, **over)
        jsp, tsp = serving_pair(jcfg, tcfg.n_layers, True)
        _PAIRS[head_dim] = (jcfg, tcfg, jsp, tsp)
    return _PAIRS[head_dim]


def _batch(cfg, seed, b=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, S)).astype(np.int32)
    patches = rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim)
                         ).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(reduced):
    t, j = TARCHS[ARCH], JARCHS[ARCH]
    if reduced:
        t, j = t.reduced(), j.reduced()
    tf, jf = _fields(t), _fields(j)
    assert tf == {k: jf[k] for k in tf}
    assert set(tf) == set(jf)                  # every field is carried
    assert t.cache_kind == j.cache_kind == "gqa"
    assert t.resolved_head_dim == j.resolved_head_dim == (64 if reduced
                                                          else 96)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("head_dim", [None, 96])
def test_prefill_and_decode_match_jax(head_dim, mode, planar):
    """Patches prepended (16 + 20 positions), logits at the last text
    position, then three decode steps at cache_len 36, 37, 38."""
    jcfg, tcfg, jsp, tsp = vlm_pair(head_dim)
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode=mode, dtype=torch.float32)
    toks, patches = _batch(tcfg, 1)
    n = tcfg.frontend_len + S
    cap = n + 8
    want, jc, jn = JM.prefill(jrt, jsp, jcfg, {
        "tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
        capacity=cap)
    got, tc, tn = TM.prefill(trt, tsp, tcfg, {
        "tokens": torch.from_numpy(toks),
        "patch_embeds": torch.from_numpy(patches)}, capacity=cap)
    assert tn == jn == n
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    _check_logits(got, want, tol)
    if planar:
        jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt), jc, n + i)
        got, _ = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                n + i)
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]


def test_logit_position_counts_from_the_text():
    """logit_position p reads the text's position p, past the patches."""
    jcfg, tcfg, jsp, tsp = vlm_pair()
    jrt = JRuntime(mode="fp16", backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode="fp16", dtype=torch.float32)
    toks, patches = _batch(tcfg, 2, b=2)
    want, _, _ = JM.prefill(jrt, jsp, jcfg, {
        "tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
        logit_position=7)
    got, _, _ = TM.prefill(trt, tsp, tcfg, {
        "tokens": torch.from_numpy(toks),
        "patch_embeds": torch.from_numpy(patches)}, logit_position=7)
    _check_logits(got, want, FP16_TOL)
    short, _, _ = TM.prefill(trt, tsp, tcfg, {
        "tokens": torch.from_numpy(toks[:, :8]),
        "patch_embeds": torch.from_numpy(patches)})
    torch.testing.assert_close(got, short, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_steps_match_jax_steps(mode):
    """The serving steps (bf16 activations, bf16-rounded GEMM outputs),
    bf16 patch embeddings as `batch_specs` shapes them; planar decode."""
    jcfg, tcfg, jsp, tsp = vlm_pair()
    toks, patches = _batch(tcfg, 3)
    n = tcfg.frontend_len + S
    pb = torch.from_numpy(patches).to(torch.bfloat16)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=n + 8)(jsp, {
        "tokens": jnp.asarray(toks),
        "patch_embeds": jnp.asarray(patches).astype(jnp.bfloat16)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=n + 8)(tsp, {
        "tokens": torch.from_numpy(toks), "patch_embeds": pb})
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=BF16_TOL[mode])
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = jd(jsp, jc, jnp.asarray(nxt), n + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), n + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=BF16_TOL[mode])
        nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    assert len(td.keys()) == 1


def test_stub_frontend_matches_batch_specs():
    cfg = TARCHS[ARCH]
    got = TS.stub_frontend(cfg, 2, 1024, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    want = JS.batch_specs(JARCHS[ARCH], InputShape("p", 1024, 2, "prefill"))
    assert set(got) == set(want) - {"tokens"} == {"patch_embeds"}
    assert tuple(got["patch_embeds"].shape) == (2, 576, 1024) == (
        2, *want["patch_embeds"].shape[1:])
    assert got["patch_embeds"].dtype == torch.bfloat16


def test_cache_shapes_and_dtypes_match_jax():
    jcfg, tcfg, jsp, tsp = vlm_pair(96)
    for planar in (False, True):
        jc = JM.init_cache(jcfg, 2, 40, planar=planar)
        tc = TM.init_cache(tcfg, 2, 40, planar=planar, device="cpu")
        assert set(jc) == set(tc) == {"attn"}
        for n, t in tc["attn"].items():
            assert tuple(t.shape) == tuple(jc["attn"][n].shape) == (
                2, 2, 40, 4, 96)
            assert str(t.dtype).split(".")[-1] == str(jc["attn"][n].dtype)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_engine_matches_jax(mode):
    """Text-only requests through both engines (planar KV, 4 slots, a
    shared 16-token system prompt): the same tokens, modes and
    counters."""
    jcfg, tcfg, jsp, tsp = vlm_pair()
    rng = np.random.default_rng(4)
    sys_prompt = [int(t) for t in rng.integers(1, tcfg.vocab_size, 16)]
    reqs = [(f"r{i}", sys_prompt + [int(t) for t in rng.integers(
        1, tcfg.vocab_size, int(rng.integers(6, 18)))], 6) for i in range(5)]
    kw = dict(n_slots=4, capacity=64, forced_mode=mode, kv_planar=True)
    jeng = JEngine(jcfg, jsp, **kw)
    teng = TEngine(tcfg, tsp, device="cpu", **kw)
    assert teng.desc.kind == "gqa" and teng.kv_planar
    for rid, toks, max_new in reqs:
        jeng.submit(JRequest(rid, list(toks), max_new))
        teng.submit(TRequest(rid, list(toks), max_new))
    jfin = {r.request_id: r for r in jeng.run()}
    tfin = {r.request_id: r for r in teng.run()}
    assert set(tfin) == set(jfin) == {r[0] for r in reqs}
    for rid in jfin:
        assert tfin[rid].output == jfin[rid].output, rid
        assert tfin[rid].modes == jfin[rid].modes, rid
    shared = set(teng.stats) & set(jeng.stats)
    assert {k: teng.stats[k] for k in shared} == \
        {k: jeng.stats[k] for k in shared}
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.prefix_cache_stats()["hit_tokens"] > 0
    assert teng.iteration == jeng.iteration


# -- the plain K4 / K5 / K6 at head dim 96 against the Pallas kernels ------

@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_paged_decode_matches_pallas_at_head_dim_96(h, hkv, fp8):
    q, planes, tables, lens = _paged_inputs(41, h=h, hkv=hkv, d=96)
    want = np.asarray(j_paged_attn(
        jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(tables),
        jnp.asarray(lens), fp8=fp8, interpret=True))
    tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
    got = tops.paged_decode_attention(_t(q), tp, _t(tables), _t(lens),
                                      fp8=fp8).numpy()
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_dense_decode_matches_pallas_at_head_dim_96(h, hkv, fp8):
    q, planes, lens = _dense_inputs(42, h=h, hkv=hkv, d=96)
    want = np.asarray(j_dense_attn(
        jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(lens),
        fp8=fp8, block_c=16, interpret=True))
    tp = dict(zip(("k_hi", "k_lo", "v_hi", "v_lo"), map(_t, planes)))
    got = tops.planar_decode_attention(_t(q), tp, _t(lens), fp8=fp8).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_prefill_matches_pallas_at_head_dim_96(h, hkv):
    rng = np.random.default_rng(43)
    q, k, v = (rng.normal(size=(2, 128, n, 96)).astype(np.float32)
               for n in (h, hkv, hkv))
    want = np.asarray(j_flash_prefill(*map(jnp.asarray, (q, k, v)),
                                      block=(32, 64), interpret=True))
    got = tops.flash_prefill_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


# -- loading -----------------------------------------------------------------

def test_streamed_build_is_bitwise_to_serving_of_init_params():
    """Layer 1's wo planted as an exception tensor; `frontend_proj` stays
    f32 and unnested, drawn after the layers."""
    cfg = TARCHS[ARCH].reduced()

    def plant(i, path, w):
        if (i, path) == (1, "attn/wo/w"):
            w[0, 0] = 2.0
    params = TM.init_params(cfg, seed=5, device="cpu")
    plant(1, "attn/wo/w", params["layers"][1]["attn"]["wo"]["w"])
    got = TM.init_serving_params(cfg, seed=5, device="cpu", plant=plant)
    _assert_trees_equal(got, to_serving(params))
    assert got["frontend_proj"]["w"].dtype == torch.float32
    assert got["layers"][1]["attn"]["wo"].weight.is_exception


def test_from_jax_serving_carries_the_frontend():
    jcfg, tcfg, jsp, tsp = vlm_pair()
    flat = flatten_serving(jsp)
    np.testing.assert_array_equal(tsp["frontend_proj"]["w"].numpy(),
                                  flat["frontend_proj/w"])
    assert len(tsp["layers"]) == tcfg.n_layers


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX checkpoint restores into the port nested as read (the
    frontend's projection unnested), equal to the JAX serving tree; a
    port checkpoint restores under the JAX package."""
    jcfg, tcfg = JARCHS[ARCH].reduced(), TARCHS[ARCH].reduced()
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jio.save(str(tmp_path / "j"), {"params": params}, step=3)
    got, step = tio.restore(str(tmp_path / "j"), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu",
        serving=True)
    assert step == 3
    want = from_jax_serving(flatten_serving(j_to_serving(params)),
                            tcfg.n_layers, device="cpu")
    _assert_trees_equal(got["params"], want, ordered=False)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    tio.save(str(tmp_path / "t"), {"params": tp})
    back, _ = jio.restore(str(tmp_path / "t"), {"params": params})
    np.testing.assert_array_equal(
        np.asarray(back["params"]["frontend_proj"]["w"]),
        tp["frontend_proj"]["w"].numpy())
    np.testing.assert_array_equal(
        np.asarray(back["params"]["layers"]["attn"]["wq"]["w"][1]),
        tp["layers"][1]["attn"]["wq"]["w"].numpy())


def test_serve_cli_takes_phi3(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--kv-planar", "--policy", "fp16"])
    assert rc == 0
    assert '"finished": 3' in capsys.readouterr().out


def test_reduced_overrides_keep_the_jax_rule():
    """dataclasses.replace of a reduced config (the tests' head_dim=96)
    agrees across the two packages."""
    j, t = configs(ARCH, head_dim=96)
    assert _fields(t) == {k: _fields(j)[k] for k in _fields(t)}
    assert dataclasses.replace(t, head_dim=None).resolved_head_dim == 64
