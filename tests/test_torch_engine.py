"""The PyTorch port's serving engine on the CPU against the JAX package's
`Engine`, both with their default host KV tier, on the same weights and
request sets:
equal greedy outputs, equal scheduling decisions, and equal host-side
counters; plus the port's BlockManager against the JAX one under a
seeded op sequence, and the device rule (no GPU => a default Engine
raises)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (configs, serving_pair,  # noqa: E402,F401
                           one_torch_thread)
from repro.core.policy import DualPrecisionController as JController  # noqa: E402
from repro.core.policy import SLOConfig as JSLO  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.kvcache import BlockManager as JBlockManager  # noqa: E402
from repro_torch.core.policy import DualPrecisionController as TController  # noqa: E402
from repro_torch.core.policy import SLOConfig as TSLO  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.kvcache import BlockManager as TBlockManager  # noqa: E402

# many small CPU ops: one intra-op thread keeps a test's time its own under
# several workers (`_torch_parity.one_torch_thread`)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


def _requests(seed, n, vocab, sys_len=16, mean_len=12, max_new=6):
    rng = np.random.default_rng(seed)
    sys_prompt = list(rng.integers(1, vocab, sys_len))
    out = []
    for i in range(n):
        plen = int(rng.integers(mean_len - 6, mean_len + 6))
        out.append((f"r{i}", sys_prompt + list(rng.integers(1, vocab, plen)),
                    max_new))
    return out


def _fake_clock():
    """A clock that advances 4 ms per reading: both engines read it at the
    same points of a step, so the controller sees the same step times."""
    c = itertools.count()
    return lambda: next(c) * 0.004


def _run_both(qwen, reqs, *, dual=False, **kw):
    jcfg, tcfg, jsp, tsp = qwen
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
        jeng.submit(JRequest(rid, [int(t) for t in toks], max_new))
        teng.submit(TRequest(rid, [int(t) for t in toks], max_new))
    jfin = {r.request_id: r for r in jeng.run()}
    tfin = {r.request_id: r for r in teng.run()}
    return jeng, teng, jfin, tfin


def _assert_same(jeng, teng, jfin, tfin):
    assert set(tfin) == set(jfin)
    for rid in jfin:
        assert tfin[rid].output == jfin[rid].output, rid
        assert tfin[rid].modes == jfin[rid].modes, rid
    shared = set(teng.stats) & set(jeng.stats)
    assert {k: teng.stats[k] for k in shared} == \
        {k: jeng.stats[k] for k in shared}
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.iteration == jeng.iteration


CASES = {
    # mode, planar, engine kwargs
    "fp16-planar": ("fp16", True, {}),
    "fp8-planar": ("fp8", True, {}),
    "fp16-plain-pool": ("fp16", False, {}),
    # a pool too small for every request at once: preemption + requeue
    "fp16-planar-scarce": ("fp16", True, {"n_blocks": 8,
                                          "chunk_tokens": 32}),
}
MAX_NEW = {"fp16-planar-scarce": 20}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(qwen, case):
    mode, planar, extra = CASES[case]
    reqs = _requests(1, 5, qwen[0].vocab_size, max_new=MAX_NEW.get(case, 6))
    jeng, teng, jfin, tfin = _run_both(
        qwen, reqs, n_slots=4, capacity=64, forced_mode=mode,
        kv_planar=planar, **extra)
    _assert_same(jeng, teng, jfin, tfin)
    if case.endswith("scarce"):
        assert teng.stats["preemptions"] > 0
    assert teng.prefix_cache_stats()["hit_tokens"] > 0


def test_dual_precision_controller_matches_jax(qwen):
    reqs = _requests(2, 6, qwen[0].vocab_size, max_new=5)
    jeng, teng, jfin, tfin = _run_both(qwen, reqs, dual=True, n_slots=4,
                                       capacity=64, kv_planar=True)
    _assert_same(jeng, teng, jfin, tfin)
    assert teng.controller.history == jeng.controller.history
    assert {"fp16", "fp8"} <= set(teng.controller.history)


def test_stop_token_retires_at_first_emission(qwen):
    """A stop token retires its request right after it is first emitted;
    the slot then serves the next request (one slot)."""
    _, tcfg, _, tsp = qwen
    prompt = list(range(5, 13))

    def run(stop=()):
        eng = TEngine(tcfg, tsp, n_slots=1, capacity=64, forced_mode="fp16",
                      device="cpu")
        eng.submit(TRequest("r0", prompt, max_new=6, stop_tokens=stop))
        eng.submit(TRequest("r1", prompt, max_new=6))
        return {r.request_id: r.output for r in eng.run()}

    ref = run()["r0"]
    cut = next(i for i, t in enumerate(ref) if ref.index(t) == i and i >= 1)
    fin = run((ref[cut],))
    assert fin["r0"] == ref[:cut + 1]
    assert fin["r1"] == ref


def test_default_device_needs_a_gpu(qwen):
    _, tcfg, _, tsp = qwen
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tcfg, tsp, n_slots=2, capacity=64)


@pytest.mark.parametrize("arg", [{"mesh": object()}, {"fault_hook": print}])
def test_deferred_features_raise(qwen, arg):
    """Serving meshes are ported: a mesh that is not a `launch.mesh.Mesh`
    is refused with a TypeError, and a Mesh is served (tokens of the
    unsharded engine). The fault hook is ported (the router's,
    serving/faults.py) and is kept as given."""
    _, tcfg, _, tsp = qwen
    if "mesh" in arg:
        with pytest.raises(TypeError, match="Mesh"):
            TEngine(tcfg, tsp, n_slots=2, capacity=64, device="cpu", **arg)
        outs = []
        for mesh in (None, make_serving_mesh(2, devices=["cpu"] * 2)):
            eng = TEngine(tcfg, tsp, n_slots=2, capacity=64, device="cpu",
                          forced_mode="fp16", mesh=mesh)
            eng.submit(TRequest("m", list(range(5, 17)), 4))
            outs.append([r.output for r in eng.run()])
        assert outs[0] == outs[1] and len(outs[0][0]) == 4
    else:
        eng = TEngine(tcfg, tsp, n_slots=2, capacity=64, device="cpu", **arg)
        assert eng.fault_hook is print


def test_submit_validation(qwen):
    _, tcfg, _, tsp = qwen
    eng = TEngine(tcfg, tsp, n_slots=2, capacity=32, device="cpu")
    for bad in (TRequest("a", [], 4), TRequest("b", [1, 2], 0),
                TRequest("c", list(range(1, 30)), 8)):
        with pytest.raises(ValueError):
            eng.submit(bad)


def test_block_manager_matches_jax_under_op_soup():
    """One seeded sequence of allocate / attach / ensure / COW / commit /
    release on both BlockManagers: identical tables, refcounts, free and
    LRU lists, prefix index and stats after every op."""
    rng = np.random.default_rng(5)
    kw = dict(n_slots=4, block_size=4, n_blocks=14, max_blocks_per_seq=6,
              prefix_cache=True)
    jb, tb = JBlockManager(**kw), TBlockManager(**kw)
    streams = [list(rng.integers(1, 6, 24)) for _ in range(3)]
    live: dict[int, list[int]] = {}
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0 and len(live) < 4:
            toks = list(streams[rng.integers(0, 3)][: rng.integers(4, 20)])
            disc = tb.prefix_admit_discount(toks)
            assert disc == jb.prefix_admit_discount(toks)
            a = jb.try_allocate("r", len(toks), 2, cached_blocks=disc)
            b = tb.try_allocate("r", len(toks), 2, cached_blocks=disc)
            assert a == b
            if a is not None:
                m = jb.attach_prefix(a, toks)
                assert m == tb.attach_prefix(b, toks)
                # as the engine does: recompute at least the last token,
                # so a fully cached prompt rewrites (and forks) its tail
                jb.set_length(a, min(m, len(toks) - 1))
                tb.set_length(b, min(m, len(toks) - 1))
                live[a] = toks
        elif op == 1 and live:
            idx = list(live)[rng.integers(0, len(live))]
            toks = live[idx]
            n = min(len(toks), tb.seqs[idx].length + int(rng.integers(1, 9)))
            ok = jb.ensure(idx, n)
            assert ok == tb.ensure(idx, n)
            if ok:
                start = tb.seqs[idx].length
                jp = jb.cow_for_write(idx, start, n)
                tp = tb.cow_for_write(idx, start, n)
                assert (jp is None) == (tp is None)
                if tp is not None:
                    assert jp == tp
                    jb.commit(idx, n, toks)
                    tb.commit(idx, n, toks)
        elif op == 2 and live:
            idx = list(live)[rng.integers(0, len(live))]
            jb.release(idx)
            tb.release(idx)
            del live[idx]
        elif op == 3 and live:
            assert jb.youngest() == tb.youngest()
        assert (jb.group_tables() == tb.group_tables()).all()
        assert jb._ref == tb._ref and jb._free == tb._free
        assert [list(x) for x in jb._lru] == [list(x) for x in tb._lru]
        assert jb._index == tb._index
        assert jb.prefix_stats["evictions"] == tb.prefix_stats["evictions"]
        tb.check_invariants()
    st = tb.prefix_stats
    assert st["cow_forks"] > 0 and st["evictions"] > 0 and st["hit_tokens"] > 0
