"""The dense-slot decode step of `launch/steps.py` as staged on the CPU,
and the dense-slot steps of gemma3-1b at head dim 256 against the JAX
package's.

On a card `make_decode_step` captures one CUDA graph per key and replays
it; on the CPU it stages the same static buffers and runs the step
eagerly on them. So here:

- the staged step is bitwise `model.decode_step` over several steps, with
  an int and with a (B,) cache_len, on planar and f16 caches, in both
  modes;
- its buffers (the packed inputs, the static logits) keep their
  addresses from step to step; two cache sets make two keys, the same
  set one;
- `check_replay` holds a run to the eager step on cloned caches;
- gemma3-1b reduced at head dim 256 (2 layers: layer 0 local with a
  window of 19, layer 1 global, whose prefill attention is K6's plain
  version at D = 256 on the CPU) through `make_prefill_step` and 4 staged
  decode steps, and through `prefill` + `decode_step` in f32, against the
  JAX package at tests/test_torch_dense.py's tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, one_torch_thread, serving_pair  # noqa: E402,F401
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import to_serving  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FP16_TOL, FP8_TOL = 3e-3, 0.25              # tests/test_torch_dense.py
BF16_TOL = {"fp16": 0.1, "fp8": 0.5}
S, CAP, STEPS = 45, 56, 4


@pytest.fixture(scope="module")
def llama():
    """llama3.1-8b reduced (2 layers, GQA), random weights nested on the
    CPU."""
    cfg = get_arch("llama3.1-8b").reduced()
    return cfg, to_serving(TM.init_params(cfg, seed=0, device="cpu"))


def _prefill(cfg, sp, mode, planar, seed=0, b=3):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, S)).astype(np.int32))
    logits, caches = TS.make_prefill_step(cfg, mode, capacity=CAP)(
        sp, {"tokens": toks})
    if planar:
        caches = TM.planarize_cache(caches)
    return logits, caches


def _clone(caches):
    return {"attn": {n: p.clone() for n, p in caches["attn"].items()}}


def _cache_len(kind, at, b):
    return at if kind == "int" else torch.full((b,), at, dtype=torch.int32)


@pytest.mark.parametrize("length", ["int", "rows"])
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_staged_step_is_the_eager_step(llama, mode, planar, length):
    cfg, sp = llama
    logits, staged = _prefill(cfg, sp, mode, planar)
    eager = _clone(staged)
    step, rt = TS.make_decode_step(cfg, mode), TS.serve_rt(mode)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(STEPS):
        cl = _cache_len(length, S + i, 3)
        got, caches = step(sp, staged, nxt, cl)
        want, _ = TM.decode_step(rt, sp, cfg, nxt, eager, cl)
        assert caches is staged
        assert torch.equal(got, want)
        for n in staged["attn"]:
            assert torch.equal(staged["attn"][n], eager["attn"][n]), n
        nxt = want.argmax(-1).to(torch.int32)[:, None]
    assert len(step.keys()) == 1 and step.n_captured == 0


def test_staged_buffers_keep_their_addresses(llama):
    """The returned logits are the key's static buffer, overwritten by
    the next call; the packed inputs stay where they were; tokens of
    int64 on the host and an int cache_len stage like int32 rows."""
    cfg, sp = llama
    logits, caches = _prefill(cfg, sp, "fp16", True)
    step = TS.make_decode_step(cfg, "fp16")
    nxt = logits.argmax(-1)[:, None]                  # int64
    seen, outs = set(), []
    for i in range(STEPS):
        got, _ = step(sp, caches, nxt, S + i if i % 2 else
                      torch.full((3,), S + i, dtype=torch.int64))
        (st,) = step._keys.values()
        seen.add((got.data_ptr(), st.dev.data_ptr(), st.host.data_ptr(),
                  st.tokens.data_ptr(), st.lens.data_ptr()))
        assert got is st.logits
        assert st.tokens.dtype == st.lens.dtype == torch.int32
        assert torch.equal(st.lens, torch.full((3,), S + i, dtype=torch.int32))
        assert torch.equal(st.tokens, nxt.to(torch.int32))
        outs.append(got.clone())
        nxt = got.argmax(-1)[:, None]
    assert len(seen) == 1
    assert not torch.equal(outs[0], outs[-1])
    assert torch.equal(got, outs[-1])


def test_keys_follow_the_caches_and_params(llama):
    """One key per (batch, capacity, planar, cache buffers, params): the
    same cache set keeps one key, a second set makes a second, f16 caches
    of the same shape another, and so does another params tree."""
    cfg, sp = llama
    step = TS.make_decode_step(cfg, "fp16")
    _, a = _prefill(cfg, sp, "fp16", True, seed=1)
    _, b = _prefill(cfg, sp, "fp16", True, seed=2)
    _, f = _prefill(cfg, sp, "fp16", False, seed=3)
    _, two = _prefill(cfg, sp, "fp16", True, seed=4, b=2)
    tok = torch.ones((3, 1), dtype=torch.int32)
    for i in range(2):
        step(sp, a, tok, S + i)
    assert len(step.keys()) == 1
    step(sp, b, tok, S)
    assert len(step.keys()) == 2
    step(sp, a, tok, S + 2)
    assert len(step.keys()) == 2
    step(sp, f, tok, S)
    step(sp, two, tok[:2], S)
    assert len(step.keys()) == 4
    keys = step.keys()
    assert sorted((k[0], k[1], k[2]) for k in keys) == [
        (2, CAP, True), (3, CAP, False), (3, CAP, True), (3, CAP, True)]
    step(dict(sp), a, tok, S)                         # another params tree
    assert len(step.keys()) == 5


def test_check_replay_holds_a_run_to_the_eager_step(llama):
    cfg, sp = llama
    logits, caches = _prefill(cfg, sp, "fp8", True)
    step = TS.make_decode_step(cfg, "fp8")
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    before = _clone(caches)
    want, _ = TM.decode_step(TS.serve_rt("fp8"), sp, cfg, nxt, before, S)
    counts = ops.all_launch_counters()
    same = step.check_replay(sp, caches, nxt, S)
    assert same == {"logits": True, "k_hi": True, "k_lo": True,
                    "v_hi": True, "v_lo": True}
    assert ops.all_launch_counters() == counts      # the CPU launches none
    for n in caches["attn"]:                        # left as one step
        assert torch.equal(caches["attn"][n], before["attn"][n])
    assert torch.equal(step(sp, caches, nxt, S)[0], want)


def test_staged_step_needs_a_free_position(llama):
    cfg, sp = llama
    caches = TM.init_cache(cfg, 3, 8, device="cpu")
    step = TS.make_decode_step(cfg, "fp16")
    with pytest.raises(ValueError, match="capacity 8"):
        step(sp, caches, torch.ones((3, 1), dtype=torch.int32), 8)


# ---------------------------------------------------------------------------
# gemma3-1b reduced at head dim 256, against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma256():
    jcfg, tcfg = configs("gemma3-1b", head_dim=256)
    assert (tcfg.resolved_head_dim, tcfg.n_layers, tcfg.sliding_window) \
        == (256, 2, 19)
    assert list(TM.window_schedule(tcfg)) == [19, -1]   # local, global
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=True)
    toks = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, (2, S)).astype(np.int32)
    return jcfg, tcfg, jsp, tsp, toks


def _check_logits(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= tol, err.max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err.max()
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_gemma_head_dim_256_steps_match_jax(gemma256, mode):
    """make_prefill_step, planarize, then STEPS staged decode steps
    (serve_rt: bf16 activations, BF16_TOL) against the JAX steps."""
    jcfg, tcfg, jsp, tsp, toks = gemma256
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=CAP)(
        jsp, {"tokens": jnp.asarray(toks)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=CAP)(
        tsp, {"tokens": torch.from_numpy(toks)})
    _check_logits(got, want, BF16_TOL[mode])
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = jd(jsp, jc, jnp.asarray(nxt), S + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), S + i)
        _check_logits(got, want, BF16_TOL[mode])
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert len(td.keys()) == 1


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_gemma_head_dim_256_f32_matches_jax(gemma256, mode):
    """prefill + STEPS decode steps in f32 activations over planar caches
    (fp16 3e-3, fp8 0.25)."""
    jcfg, tcfg, jsp, tsp, toks = gemma256
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode=mode, dtype=torch.float32)
    tol = FP16_TOL if mode == "fp16" else FP8_TOL
    want, jc, _ = JM.prefill(jrt, jsp, jcfg, {"tokens": jnp.asarray(toks)},
                             capacity=CAP)
    got, tc, _ = TM.prefill(trt, tsp, tcfg, {"tokens": torch.from_numpy(toks)},
                            capacity=CAP)
    _check_logits(got, want, tol)
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for i in range(STEPS):
        want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt), jc, S + i)
        got, _ = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                S + i)
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
