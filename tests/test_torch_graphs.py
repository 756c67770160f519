"""The engine's step keys and static buffers (`serving/graphs.py`) on the
CPU, where the same buffers are staged and the step runs eagerly: the
port's keys are the JAX engine's jit-cache keys on the same request
sets, every key's buffers keep their addresses for a whole run
(preemption and COW forks included), and `paged_step` with its row
gather inside is bitwise the gather done outside."""

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
from repro_torch.core.policy import DualPrecisionController as TController  # noqa: E402
from repro_torch.core.policy import SLOConfig as TSLO  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402

# many small CPU ops: one intra-op thread keeps a test's time its own under
# several workers (`_torch_parity.one_torch_thread`)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


def _requests(seed, n, vocab, sys_len=16, mean_len=12, max_new=6):
    """The request sets of tests/test_torch_engine.py."""
    rng = np.random.default_rng(seed)
    sys_prompt = list(rng.integers(1, vocab, sys_len))
    out = []
    for i in range(n):
        plen = int(rng.integers(mean_len - 6, mean_len + 6))
        out.append((f"r{i}", sys_prompt + list(rng.integers(1, vocab, plen)),
                    max_new))
    return out


def _fake_clock():
    c = itertools.count()
    return lambda: next(c) * 0.004


# the request sets of test_torch_engine.py's parity cases:
# (seed, n, max_new, engine kwargs)
CASES = {
    "fp16-planar": (1, 5, 6, dict(forced_mode="fp16")),
    "fp8-planar": (1, 5, 6, dict(forced_mode="fp8")),
    "fp16-planar-scarce": (1, 5, 20, dict(forced_mode="fp16", n_blocks=8,
                                          chunk_tokens=32)),
    "dual": (2, 6, 5, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_keys_are_the_jax_engines(qwen, case):
    """The port's prefill keys are the JAX engine's `_fused_cache` keys,
    its decode keys the modes whose `_decode` executable was compiled."""
    jcfg, tcfg, jsp, tsp = qwen
    seed, n, max_new, extra = CASES[case]
    reqs = _requests(seed, n, jcfg.vocab_size, max_new=max_new)
    jkw, tkw = dict(extra), dict(extra)
    if case == "dual":
        slo = dict(tpot_ms=33.3, hysteresis_steps=2)
        rates = dict(fp16_ms_per_token=1.0, fp8_ms_per_token=0.5,
                     fixed_overhead_ms=1.0)
        jkw.update(controller=JController(JSLO(**slo), **rates),
                   clock=_fake_clock())
        tkw.update(controller=TController(TSLO(**slo), **rates),
                   clock=_fake_clock())
    jeng = JEngine(jcfg, jsp, n_slots=4, capacity=64,
                   kv_planar=True, **jkw)
    teng = TEngine(tcfg, tsp, device="cpu", n_slots=4, capacity=64,
                   kv_planar=True, **tkw)
    for rid, toks, mx in reqs:
        jeng.submit(JRequest(rid, [int(t) for t in toks], mx))
        teng.submit(TRequest(rid, [int(t) for t in toks], mx))
    jfin = {r.request_id: r.output for r in jeng.run()}
    tfin = {r.request_id: r.output for r in teng.run()}
    assert tfin == jfin
    assert teng.graphs.keys("prefill") == set(jeng._fused_cache)
    used = {m for m, fn in jeng._decode.items() if fn._cache_size()}
    assert teng.graphs.keys("decode") == used
    if case == "dual":
        assert used == {"fp16", "fp8"}
    assert teng.graphs.n_captured == 0 and teng.graphs.pool_bytes() == 0


def _pointers(eng):
    g = eng.graphs
    out = {("tables",): g.tables.data_ptr(),
           ("block_manager",): eng.blocks.device_tables().data_ptr()}
    out.update({("pool", n): p.data_ptr()
                for n, p in eng.caches["attn"].items()})
    for key, st in g._steps.items():
        out.update({(key, n): t.data_ptr()
                    for n, t in (("dev", st.dev), ("host", st.host),
                                 ("ids", st.ids), *st.views.items())})
    return out


def test_static_buffers_keep_their_addresses(qwen):
    """A scarce pool (preemption) and repeated prompts of whole blocks
    (COW forks of a shared tail block), in dual mode: after every step,
    every key's buffers, the pool and the device table sit where they
    sat when the key was made."""
    _, tcfg, _, tsp = qwen
    rng = np.random.default_rng(4)
    base = [int(t) for t in rng.integers(1, tcfg.vocab_size, 32)]
    eng = TEngine(tcfg, tsp, device="cpu", n_slots=4, capacity=64,
                  kv_planar=True, n_blocks=9, chunk_tokens=32,
                  controller=TController(TSLO(tpot_ms=33.3,
                                              hysteresis_steps=1),
                                         fp16_ms_per_token=1.0,
                                         fp8_ms_per_token=0.5,
                                         fixed_overhead_ms=1.0),
                  clock=_fake_clock())
    for i in range(6):
        toks = base if i % 2 == 0 else \
            [int(t) for t in rng.integers(1, tcfg.vocab_size, 20)]
        eng.submit(TRequest(f"r{i}", toks, 18))
    seen: dict = {}
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        now = _pointers(eng)
        for k, ptr in now.items():
            assert seen.setdefault(k, ptr) == ptr, k
        assert eng.iteration < 500
    assert len(eng.finished) == 6
    assert eng.stats["preemptions"] > 0
    assert eng.prefix_cache_stats()["cow_forks"] > 0
    assert len(eng.graphs.keys("prefill")) > 1
    assert eng.graphs.keys("decode") == {"fp16", "fp8"}


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_paged_step_row_gather_inside(qwen, mode, planar):
    """paged_step(rows=...) gathers the block-table rows itself; ids and
    every pool byte equal those of the gather done by the caller. The
    trash block 0 is left out: pad positions of rows 1 and 3 collide
    there in no fixed order (two eager calls of either form differ
    there too), and no step reads it."""
    _, tcfg, _, tsp = qwen
    rng = np.random.default_rng(11)
    n_slots, mb, bs, nb = 4, 4, 16, 17
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, nb))[: n_slots * mb]
        .reshape(n_slots, mb).astype(np.int32))
    caches = M.init_paged_cache(tcfg, nb, bs, planar=planar, device="cpu")
    for p in caches["attn"].values():
        if p.dtype == torch.uint8:
            p.copy_(torch.from_numpy(rng.integers(0, 256, p.shape,
                                                  dtype=np.uint8)))
        else:
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)
                                     .astype(np.float16)))
    rows = torch.tensor([2, 0, 3, 0], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (4, 16))
                              .astype(np.int32))
    q_offset = torch.tensor([5, 0, 30, 0], dtype=torch.int32)
    kv_len = torch.tensor([21, 9, 46, 0], dtype=torch.int32)
    lp = torch.tensor([15, 8, 15, 0], dtype=torch.int32)
    rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
    pools = {}
    ids = {}
    for inside in (True, False):
        pools[inside] = {"attn": {n: p.clone()
                                  for n, p in caches["attn"].items()}}
        ids[inside] = M.paged_step(
            rt, tsp, tcfg, tokens, pools[inside],
            tables if inside else tables[rows.long()], q_offset=q_offset,
            kv_len=kv_len, block_size=bs, logit_position=lp,
            rows=rows if inside else None)
    assert torch.equal(ids[True], ids[False])
    for n in caches["attn"]:
        got, want = pools[True]["attn"][n], pools[False]["attn"][n]
        assert torch.equal(got[:, 1:], want[:, 1:])
        # the step wrote this plane (rows 0 and 2 hold real tokens)
        assert not torch.equal(got[:, 1:], caches["attn"][n][:, 1:])


def test_check_replay_leaves_pool_and_counts(qwen):
    """`check_replay` compares a key's run with an eager call on clones,
    and leaves the pool and the launch counters as they were."""
    _, tcfg, _, tsp = qwen
    eng = TEngine(tcfg, tsp, device="cpu", n_slots=2, capacity=64,
                  forced_mode="fp8", kv_planar=True)
    eng.submit(TRequest("a", list(range(3, 24)), 4))
    eng.step()
    eng.step()
    pool = {n: p.clone() for n, p in eng.caches["attn"].items()}
    before = ops.all_launch_counters()
    for key in list(eng.graphs._steps):
        same = eng.graphs.check_replay(key)
        assert set(same) == {"ids", *pool} and all(same.values()), key
    assert ops.all_launch_counters() == before
    for n, p in eng.caches["attn"].items():
        assert torch.equal(p, pool[n])
    assert eng.graphs.keys("decode") == {"fp8"}
    assert eng.graphs.keys("prefill") == {("fp8", 1, 32)}
