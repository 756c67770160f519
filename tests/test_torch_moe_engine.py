"""The MoE family through the port's serving paths, against the JAX
package's on the same weights: granite-moe-3b reduced (GQA, 4 experts
top-2, banks padded to 6) and deepseek-v3 reduced (MLA latent planes,
a shared expert, the `mtp` subtree carried).

The paged engine gives the JAX engine's tokens and counters in FP16,
FP8 and dual mode with prefix hits (on MLA latent blocks for deepseek),
with the host tier spilling and restoring blocks, and with speculation;
`kv_planar=True` on MLA falls back to f16 latent planes as the JAX
engine does. The step keys equal the JAX engine's jit keys. Engine
streams that part must part at a top-2 margin below twice the tolerance
or at a routing near-tie (`_torch_parity.assert_streams`, the rule of
`_torch_parity.routing_flips`); the counters, modes, prefix stats and
step counts are held equal either way. The dense-slot steps, the configs and
the loaders are in test_torch_moe_load.py."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (assert_streams, configs,  # noqa: E402,F401
                           one_torch_thread, serving_pair)
from repro.core.policy import DualPrecisionController as JController  # noqa: E402
from repro.core.policy import SLOConfig as JSLO  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.core.policy import DualPrecisionController as TController  # noqa: E402
from repro_torch.core.policy import SLOConfig as TSLO  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = configs(request.param)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=True)
    return jcfg, tcfg, jsp, tsp


def _requests(seed, vocab, n=5, sys_len=16, max_new=6):
    rng = np.random.default_rng(seed)
    sysp = [int(t) for t in rng.integers(1, vocab, sys_len)]
    return [(f"r{i}", sysp + [int(t) for t in rng.integers(
        1, vocab, int(rng.integers(6, 18)))], max_new) for i in range(n)]


def _pattern_requests(seed, vocab, n=3, period=6, reps=4, max_new=12):
    """Prompts that repeat a pattern: n-gram drafts get accepted."""
    rng = np.random.default_rng(seed)
    return [(f"p{i}", [int(t) for t in rng.integers(1, vocab, period)] * reps,
             max_new) for i in range(n)]


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 0.004


def _run_both(pair, reqs, *, dual=False, **kw):
    jcfg, tcfg, jsp, tsp = pair
    jkw, tkw = dict(kw), dict(kw)
    if dual:
        slo = dict(tpot_ms=33.3, hysteresis_steps=2)
        rates = dict(fp16_ms_per_token=1.0, fp8_ms_per_token=0.5,
                     fixed_overhead_ms=1.0)
        jkw.update(controller=JController(JSLO(**slo), **rates),
                   clock=_fake_clock())
        tkw.update(controller=TController(TSLO(**slo), **rates),
                   clock=_fake_clock())
    jeng = JEngine(jcfg, jsp, **jkw)
    teng = TEngine(tcfg, tsp, device="cpu", **tkw)
    for rid, toks, max_new in reqs:
        jeng.submit(JRequest(rid, list(toks), max_new))
        teng.submit(TRequest(rid, list(toks), max_new))
    jfin = {r.request_id: r for r in jeng.run()}
    tfin = {r.request_id: r for r in teng.run()}
    assert set(tfin) == set(jfin)
    jout = {k: r.output for k, r in jfin.items()}
    tout = {k: r.output for k, r in tfin.items()}
    assert_streams(pair, reqs, jout, tout, kw.get("forced_mode") or "fp16")
    # held whether or not a stream parts: no request has a stop token, so
    # a parting changes no stream's length, step or mode (speculation's
    # acceptance would change, and fail here)
    for rid in jfin:
        assert tfin[rid].modes == jfin[rid].modes, rid
    shared = set(teng.stats) & set(jeng.stats)
    assert {k: teng.stats[k] for k in shared} == \
        {k: jeng.stats[k] for k in shared}
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.iteration == jeng.iteration
    return jeng, teng


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_engine_matches_jax(pair, mode):
    """kv_planar=True: granite's pool is byte-planar (K4 on the card),
    deepseek's keeps f16 latents, as the JAX engine decides."""
    reqs = _requests(3, pair[0].vocab_size)
    jeng, teng = _run_both(pair, reqs, n_slots=4, capacity=64,
                           forced_mode=mode, kv_planar=True)
    assert teng.kv_planar == jeng.kv_planar == (pair[1].mla is None)
    planes = {p.name: (p.token_shape, p.dtype) for p in teng.desc.planes}
    assert planes == {p.name: (p.token_shape, p.dtype)
                      for p in jeng.desc.planes}
    if pair[1].mla is not None:
        m = pair[1].mla
        assert planes == {"c_kv": ((m.kv_lora_rank,), "float16"),
                          "k_rope": ((m.qk_rope_dim,), "float16")}
    assert teng.prefix_cache_stats()["hit_tokens"] > 0
    # every step key the JAX engine compiled, the port's engine staged
    assert teng.graphs.keys("prefill") == set(jeng._fused_cache)
    assert teng.graphs.keys("decode") == {
        m for m, fn in jeng._decode.items() if fn._cache_size()}


def test_dual_precision_matches_jax(pair):
    reqs = _requests(2, pair[0].vocab_size, n=6, max_new=5)
    jeng, teng = _run_both(pair, reqs, dual=True, n_slots=4, capacity=64,
                           kv_planar=True)
    assert teng.controller.history == jeng.controller.history
    assert {"fp16", "fp8"} <= set(teng.controller.history)


def test_speculation_matches_jax(pair):
    reqs = _pattern_requests(4, pair[0].vocab_size)
    jeng, teng = _run_both(pair, reqs, n_slots=4, capacity=64,
                           forced_mode="fp16", kv_planar=True,
                           speculate=True)
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.stats["spec_accepted"] > 0
    assert any(k[0] == "spec" for k in teng.graphs.keys())


def _bursts(vocab):
    """Bursts A, B, A: two 96-token system prompts, 3 requests each."""
    rng = np.random.default_rng(0)
    s1, s2 = (rng.integers(1, vocab, size=96).tolist() for _ in range(2))
    return [[(f"{tag}{i}", sysp + np.random.default_rng(7 * i + 1)
              .integers(1, vocab, size=8).tolist(), 6) for i in range(3)]
            for tag, sysp in (("a", s1), ("b", s2), ("c", s1))]


def test_host_tier_spills_and_restores(pair):
    """An 11-block pool spills A's blocks (MLA: c_kv / k_rope latents)
    while B runs and restores them for the third burst: tokens, counters
    and the host tier's stats equal the JAX engine's."""
    jcfg, tcfg, jsp, tsp = pair
    kw = dict(n_slots=2, capacity=128, forced_mode="fp16", block_size=16,
              n_blocks=11, chunk_tokens=64, debug_invariants=True)
    outs = {}
    for side, mk, R in (("jax", lambda: JEngine(jcfg, jsp, **kw), JRequest),
                        ("torch", lambda: TEngine(tcfg, tsp, device="cpu",
                                                  **kw), TRequest)):
        e = mk()
        for burst in _bursts(jcfg.vocab_size):
            for rid, toks, mn in burst:
                e.submit(R(rid, list(toks), mn))
            e.run(max_iters=800)
        outs[side] = (e, {r.request_id: tuple(r.output) for r in e.finished})
    (je, jo), (te, to) = outs["jax"], outs["torch"]
    assert to == jo
    ts = te.tiered_stats()
    assert ts == je.tiered_stats()
    assert ts["spilled_blocks"] > 0 and ts["restored_blocks"] > 0, ts
    assert te.blocks.host.stats == je.blocks.host.stats
    # a restored block carries every plane's layer rows of one block
    per_block = sum(int(np.prod(shp)) * (2 if p.dtype == "float16" else 1)
                    for p in te.desc.planes
                    for shp in [(tcfg.n_layers, 16) + p.token_shape])
    assert ts["restored_bytes"] == ts["restored_blocks"] * per_block


def test_prefix_store_persists_latent_blocks(pair, tmp_path):
    """The port saves its prefix store (MLA: c_kv / k_rope planes); a new
    port engine and a new JAX engine on the same directory both restore
    the system prompt's blocks from the host tier and emit the same
    tokens. (Not the first engine's: restored prefixes change how the
    rows' chunks are batched, and an MoE step's capacity follows its
    chunk width, as in the reference.)"""
    jcfg, tcfg, jsp, tsp = pair
    kw = dict(n_slots=2, capacity=128, forced_mode="fp16", block_size=16,
              n_blocks=24, chunk_tokens=64, debug_invariants=True)
    burst = _bursts(jcfg.vocab_size)[0]

    def serve(e, R):
        for rid, toks, mn in burst:
            e.submit(R(rid, list(toks), mn))
        e.run(max_iters=800)
        return {r.request_id: r.output for r in e.finished}

    first = TEngine(tcfg, tsp, device="cpu", persist_dir=str(tmp_path), **kw)
    serve(first, TRequest)
    assert first.save_prefix_store() > 0
    second = TEngine(tcfg, tsp, device="cpu", persist_dir=str(tmp_path),
                     **kw)
    jsecond = JEngine(jcfg, jsp, persist_dir=str(tmp_path), **kw)
    assert serve(second, TRequest) == serve(jsecond, JRequest)
    assert second.tiered_stats() == jsecond.tiered_stats()
    assert second.blocks.prefix_stats["host_hit_blocks"] > 0
    assert second.stats["restored_blocks"] > 0
