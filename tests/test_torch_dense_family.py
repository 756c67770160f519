"""The rest of the dense family through both serving paths of the port,
against the JAX package on the same weights: qwen3-8b reduced (qk_norm)
and a deepseek-coder-33b cut that keeps its GQA group of 7 (`reduced()`
alone collapses 56 / 8 heads to 4 / 4, G = 1). The paged engine gives
equal tokens and counters in FP16 and FP8; the dense-slot prefill and
decode steps give logits within the tolerances of test_torch_dense.py
(F-port-1) and the same greedy tokens wherever the margin is clear."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, one_torch_thread, serving_pair  # noqa: E402,F401
from repro.models import model as JM  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import to_serving  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FP16_TOL, FP8_TOL = 3e-3, 0.25
S, CAP, STEPS = 45, 56, 3

MODELS = {
    "qwen3-8b": ("qwen3-8b", {}, False),
    # G = 7 (one kv head for 7 q heads), one exception tensor
    "deepseek-g7": ("deepseek-coder-33b", {"n_heads": 7, "n_kv_heads": 1},
                    True),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_pair(request):
    arch, over, plant = MODELS[request.param]
    jcfg, tcfg = configs(arch, **over)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant)
    return request.param, jcfg, tcfg, jsp, tsp


def test_the_cut_keeps_what_the_full_config_exercises(model_pair):
    name, jcfg, tcfg, _, _ = model_pair
    full = {"qwen3-8b": (True, 1), "deepseek-g7": (False, 7)}[name]
    assert (tcfg.qk_norm, tcfg.n_heads // tcfg.n_kv_heads) == full
    assert jcfg.n_heads == tcfg.n_heads and jcfg.qk_norm == tcfg.qk_norm


def _requests(seed, vocab, n=5, sys_len=16, max_new=6):
    rng = np.random.default_rng(seed)
    sys_prompt = [int(t) for t in rng.integers(1, vocab, sys_len)]
    return [(f"r{i}", sys_prompt + [int(t) for t in rng.integers(
        1, vocab, int(rng.integers(6, 18)))], max_new) for i in range(n)]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_paged_engine_matches_jax(model_pair, mode):
    _, jcfg, tcfg, jsp, tsp = model_pair
    kw = dict(n_slots=4, capacity=64, forced_mode=mode, kv_planar=True)
    jeng = JEngine(jcfg, jsp, **kw)
    teng = TEngine(tcfg, tsp, device="cpu", **kw)
    for rid, toks, max_new in _requests(3, jcfg.vocab_size):
        jeng.submit(JRequest(rid, list(toks), max_new))
        teng.submit(TRequest(rid, list(toks), max_new))
    jfin = {r.request_id: r for r in jeng.run()}
    tfin = {r.request_id: r for r in teng.run()}
    assert set(tfin) == set(jfin)
    for rid in jfin:
        assert tfin[rid].output == jfin[rid].output, rid
        assert tfin[rid].modes == jfin[rid].modes, rid
    shared = set(teng.stats) & set(jeng.stats)
    assert {k: teng.stats[k] for k in shared} == \
        {k: jeng.stats[k] for k in shared}
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.iteration == jeng.iteration
    assert teng.prefix_cache_stats()["hit_tokens"] > 0


def _check_logits(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= tol, err.max()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err.max()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_dense_slot_steps_match_jax(model_pair, mode):
    """prefill of ragged prompts (K6's plain version at the model's G),
    planarize, then greedy decode steps (K5's)."""
    _, jcfg, tcfg, jsp, tsp = model_pair
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    trt = TRuntime(mode=mode, dtype=torch.float32)
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab_size, (3, S)).astype(np.int32)
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
        got, tc = TM.decode_step(trt, tsp, tcfg, torch.from_numpy(nxt), tc,
                                 S + i)
        _check_logits(got, want, tol)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]


def test_streamed_params_serve_as_the_whole_tree(model_pair):
    """The engine over `init_serving_params` equals the engine over
    `to_serving(init_params(...))`: the same tokens (the two trees are
    bitwise equal, test_torch_load.py)."""
    _, _, cfg, _, _ = model_pair
    outs = []
    for sp in (TM.init_serving_params(cfg, seed=2, device="cpu"),
               to_serving(TM.init_params(cfg, seed=2, device="cpu"))):
        eng = TEngine(cfg, sp, n_slots=2, capacity=48, forced_mode="fp16",
                      kv_planar=True, device="cpu")
        for rid, toks, max_new in _requests(4, cfg.vocab_size, n=3):
            eng.submit(TRequest(rid, list(toks), max_new))
        outs.append({r.request_id: r.output for r in eng.run()})
    assert outs[0] == outs[1] and len(outs[0]) == 3
