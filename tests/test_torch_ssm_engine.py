"""The recurrent families through the port's paged engine, against the JAX
engine on the same weights: mamba2-2.7b reduced (pure SSM: slot-resident
state, no paged plane) and zamba2-2.7b reduced (hybrid: the state plus
the shared attention's f16 K/V blocks), every layer's out_proj an
exception tensor.

- FP16, FP8 and dual mode give the JAX engine's greedy tokens, modes,
  counters, controller history and step keys (the exact-length "chunk"
  keys are the JAX engine's `_chunk_cache`). A stream may part only at a
  top-2 margin of the reference below twice the tolerance (F-port-1).
  `h2d_bytes` differs by exactly 4 bytes a chunk: the port uploads the
  chunk's slot in its packed inputs, which the JAX engine passes as a
  traced scalar it does not count.
- The prefix cache and the host tier are off, and speculation raises
  ValueError, as in the JAX engine.
- The counterparts of the JAX package's own engine tests of these
  families (tests/test_paged_kv.py's TestHybridPagedServing and
  TestSSMPagedScheduling, test_speculative.py's recurrent refusal), run
  on the port's engine.
- A recurrent step key's replay check restores the state, the pool and
  the ids, and (re-)admission zeroes exactly the admitted slot's state."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import assert_streams, one_torch_thread  # noqa: E402,F401
from repro.core.policy import DualPrecisionController as JController  # noqa: E402
from repro.core.policy import SLOConfig as JSLO  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.core.policy import DualPrecisionController as TController  # noqa: E402
from repro_torch.core.policy import SLOConfig as TSLO  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_ssm import ARCHS, ssm_pair  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return ssm_pair(request.param)


@pytest.fixture(scope="module")
def hybrid():
    return ssm_pair("zamba2-2.7b")


def _requests(seed, vocab, n=5, max_new=6):
    """Prompt lengths drawn from {9, 17, 30}: a chunk budget of 16 then
    gives a few exact chunk lengths, each compiled once by the JAX
    engine."""
    rng = np.random.default_rng(seed)
    return [(f"r{i}", [int(t) for t in rng.integers(
        1, vocab, int(rng.choice([9, 17, 30])))], max_new) for i in range(n)]


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
    assert set(tfin) == set(jfin) == {rid for rid, _, _ in reqs}
    assert_streams(pair, reqs, {k: r.output for k, r in jfin.items()},
                    {k: r.output for k, r in tfin.items()},
                    kw.get("forced_mode") or "fp16")
    for rid in jfin:
        assert tfin[rid].modes == jfin[rid].modes, rid
    shared = set(teng.stats) & set(jeng.stats)
    got = {k: teng.stats[k] for k in shared}
    want = {k: jeng.stats[k] for k in shared}
    # the slot of each chunk: packed in the port's upload, an uncounted
    # traced scalar in the JAX engine's call
    want["h2d_bytes"] += 4 * want["prefill_dispatches"]
    assert got == want
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.iteration == jeng.iteration
    return jeng, teng


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_engine_matches_jax(pair, mode):
    """Three slots for five requests (slots are reused, each re-admission
    zeroing its state), a chunk budget of 16 (prompts in several
    exact-length chunks, decode interleaved with them)."""
    reqs = _requests(3, pair[0].vocab_size)
    jeng, teng = _run_both(pair, reqs, n_slots=3, capacity=64,
                           forced_mode=mode, chunk_tokens=16)
    assert teng.graphs.keys("chunk") == set(jeng._chunk_cache)
    assert teng.graphs.keys("prefill") == set()
    assert teng.graphs.keys("decode") == {
        m for m, fn in jeng._decode.items() if fn._cache_size()}
    assert teng.desc.kind == jeng.desc.kind
    assert not teng.blocks.prefix_cache and not teng._host_tier
    assert teng.stats["chunks"] > len(reqs)           # split prompts
    assert teng.slot_state.n_free() == teng.n_slots


def test_dual_precision_matches_jax(pair):
    """A chunk budget of 64: prefill-heavy steps cost the controller's
    model more than the 33.3 ms TPOT target in FP16, so it picks FP8."""
    reqs = _requests(2, pair[0].vocab_size, n=6, max_new=5)
    jeng, teng = _run_both(pair, reqs, dual=True, n_slots=3, capacity=64,
                           chunk_tokens=64)
    assert teng.controller.history == jeng.controller.history
    assert {"fp16", "fp8"} <= set(teng.controller.history)


def test_prefix_cache_and_host_tier_are_off(pair):
    """Asked for both, a recurrent engine keeps neither, as the JAX
    engine: no prefix hits on a shared system prompt, nothing spilled."""
    _, tcfg, _, tsp = pair
    eng = TEngine(tcfg, tsp, n_slots=2, capacity=64, forced_mode="fp16",
                  prefix_cache=True, host_offload=True, device="cpu")
    assert not eng.blocks.prefix_cache and eng.blocks.host is None
    assert not eng.tiered_stats()["enabled"]
    sysp = list(range(5, 37))
    for i in range(3):
        eng.submit(TRequest(f"r{i}", sysp + [40 + i], 2))
    eng.run()
    assert eng.prefix_cache_stats()["hit_tokens"] == 0
    assert eng.stats["spilled_blocks"] == 0


def test_recurrent_family_rejects_speculation(pair):
    """test_speculative.py's refusal: a recurrence cannot roll back."""
    _, tcfg, _, tsp = pair
    with pytest.raises(ValueError, match="roll"):
        TEngine(tcfg, tsp, n_slots=2, capacity=64, speculate=True,
                device="cpu")


# ---------------------------------------------------------------------------
# counterparts of tests/test_paged_kv.py's hybrid and SSM engine tests
# ---------------------------------------------------------------------------

def test_descriptor_shape(hybrid):
    _, cfg, _, _ = hybrid
    desc = TM.cache_descriptor(cfg)
    assert desc.kind == "hybrid" and not desc.prefix_cacheable
    assert {p.name for p in desc.planes} == {"k", "v"}
    assert {p.name for p in desc.slot_planes} == \
        {"conv_x", "conv_bc", "ssm"}
    assert desc.bytes_per_token > 0 and desc.bytes_per_slot > 0
    # shared-attn planes page one logical layer per application group
    assert desc.planes[0].n_layers == cfg.n_layers // cfg.attn_every


def test_batched_matches_solo(hybrid):
    """Batched hybrid serving == solo serving per request (state rows are
    independent; inactive-row masking must hold)."""
    _, cfg, _, sp = hybrid
    prompts = [list(range(4 + 10 * i, 13 + 10 * i)) for i in range(3)]

    def solo(p):
        eng = TEngine(cfg, sp, n_slots=3, capacity=32, forced_mode="fp16",
                      chunk_tokens=512, device="cpu")
        eng.submit(TRequest("s", p, max_new=6))
        return eng.run()[0].output

    eng = TEngine(cfg, sp, n_slots=3, capacity=32, forced_mode="fp16",
                  chunk_tokens=512, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(TRequest(f"r{i}", p, max_new=6))
    fin = {r.request_id: r.output for r in eng.run()}
    for i, p in enumerate(prompts):
        assert fin[f"r{i}"] == solo(p), f"r{i} corrupted by batching"


def test_decode_interleaves_with_chunked_prefill(hybrid):
    """r0 keeps decoding while r1's long prompt prefills in small
    exact-length chunks, and r0's output equals its solo run."""
    _, cfg, _, sp = hybrid

    def solo(p, max_new):
        eng = TEngine(cfg, sp, n_slots=4, capacity=128, forced_mode="fp16",
                      chunk_tokens=512, device="cpu")
        eng.submit(TRequest("s", p, max_new=max_new))
        return eng.run()[0].output

    eng = TEngine(cfg, sp, n_slots=4, capacity=128, forced_mode="fp16",
                  chunk_tokens=8, device="cpu")
    p0 = list(range(4, 12))
    eng.submit(TRequest("r0", p0, max_new=12))
    eng.step()                                  # r0 prefilled + admitted
    eng.submit(TRequest("r1", list(range(2, 66)), max_new=2))
    fin = {r.request_id: r for r in eng.run()}
    assert len(fin["r0"].output) == 12 and len(fin["r1"].output) == 2
    assert fin["r0"].output == solo(p0, 12), \
        "prefill chunks of r1 corrupted r0's slot state"


def test_preemption_completes_all_requests(hybrid):
    """A scarce shared-attention pool forces preemption; every request
    still completes with its full token budget and the slot state is
    released."""
    _, cfg, _, sp = hybrid
    eng = TEngine(cfg, sp, n_slots=3, capacity=32, forced_mode="fp16",
                  block_size=4, n_blocks=10, device="cpu")
    for i in range(3):
        eng.submit(TRequest(f"r{i}", list(range(4 + 9 * i, 12 + 9 * i)),
                            max_new=16))
    fin = {r.request_id: r for r in eng.run()}
    assert eng.stats["preemptions"] >= 1, "scarce pool never preempted"
    assert len(fin) == 3
    assert all(len(r.output) == 16 for r in fin.values())
    eng.blocks.check_invariants()
    assert eng.blocks.blocks_in_use() == 0
    assert eng.slot_state.n_free() == eng.slot_state.n_slots


def test_slot_state_claimed_in_lockstep(hybrid):
    """The SlotManager side mirrors the BlockManager's slot assignment
    while sequences are live."""
    _, cfg, _, sp = hybrid
    eng = TEngine(cfg, sp, n_slots=3, capacity=32, forced_mode="fp16",
                  device="cpu")
    assert eng.slot_state is not None
    assert not eng.blocks.prefix_cache, \
        "recurrent state cannot be prefix-cached"
    for i in range(2):
        eng.submit(TRequest(f"r{i}", list(range(4, 12)), max_new=8))
    eng.step()
    live = {i for i, s in enumerate(eng.blocks.seqs) if s is not None}
    assert set(eng.slot_state.active()) == live
    for i in live:
        assert eng.slot_state.slots[i].request_id \
            == eng.blocks.seqs[i].request_id
    eng.run()
    assert eng.slot_state.n_free() == eng.slot_state.n_slots


def test_free_block_frac_sees_hybrid_pressure(hybrid):
    """Shared-attention block exhaustion on a hybrid model engages the
    controller's FP8 memory-pressure trigger."""
    _, cfg, _, sp = hybrid
    ctrl = TController(TSLO(tpot_ms=1e9, hysteresis_steps=2,
                            free_block_frac_min=0.3),
                       fp16_ms_per_token=1e-9, fp8_ms_per_token=1e-9)
    eng = TEngine(cfg, sp, n_slots=4, capacity=32, controller=ctrl,
                  block_size=4, n_blocks=10, device="cpu")
    for i in range(3):
        eng.submit(TRequest(f"r{i}", list(range(4 + 8 * i, 12 + 8 * i)),
                            max_new=16))
    eng.run()
    assert "fp8" in ctrl.history, \
        "hybrid shared-attn headroom never engaged FP8"


def test_engine_serves_mamba2():
    """Pure SSM: slot-resident state only; block tables degenerate to
    token accounting but scheduling is the same path."""
    _, cfg, _, sp = ssm_pair("mamba2-2.7b")
    desc = TM.cache_descriptor(cfg)
    assert desc.kind == "ssm" and not desc.planes
    assert desc.bytes_per_token == 0 and desc.bytes_per_slot > 0
    eng = TEngine(cfg, sp, n_slots=2, capacity=32, forced_mode="fp16",
                  chunk_tokens=512, device="cpu")
    assert set(eng.caches) == {"ssm"}
    for i in range(3):                           # recycles slots
        eng.submit(TRequest(f"r{i}", list(range(4 + 7 * i, 12 + 7 * i)),
                            max_new=4))
    fin = eng.run()
    assert len(fin) == 3
    assert all(len(r.output) == 4 for r in fin)


# ---------------------------------------------------------------------------
# step keys and slot state on the CPU
# ---------------------------------------------------------------------------

def test_check_replay_restores_state_and_ids(pair):
    """Every key of a recurrent engine (a chunk key, the decode) checks
    bitwise against an eager call, and leaves the state planes, the pool,
    the key's ids and the launch counters as they were."""
    _, tcfg, _, tsp = pair
    eng = TEngine(tcfg, tsp, device="cpu", n_slots=2, capacity=64,
                  forced_mode="fp8")
    eng.submit(TRequest("a", list(range(3, 24)), 4))
    eng.step()
    eng.step()
    caches = {s: {n: p.clone() for n, p in pl.items()}
              for s, pl in eng.caches.items()}
    ids = {k: st.ids.clone() for k, st in eng.graphs._steps.items()}
    before = ops.all_launch_counters()
    assert set(eng.graphs.keys()) == {("chunk", "fp8", 21),
                                      ("decode", "fp8")}
    for key in list(eng.graphs._steps):
        same = eng.graphs.check_replay(key)
        names = {n for pl in caches.values() for n in pl}
        assert set(same) == {"ids", *names} and all(same.values()), key
        assert torch.equal(eng.graphs._steps[key].ids, ids[key])
    assert ops.all_launch_counters() == before
    for s, pl in eng.caches.items():
        for n, p in pl.items():
            assert torch.equal(p, caches[s][n]), n


def test_admission_zeroes_exactly_its_slot(pair):
    """A request admitted into a used slot starts from a zero state, and
    no other slot's state moves at admission."""
    _, tcfg, _, tsp = pair
    eng = TEngine(tcfg, tsp, device="cpu", n_slots=2, capacity=64,
                  forced_mode="fp16")
    for p in eng.caches["ssm"].values():
        p.normal_()                          # garbage in every slot
    before = {n: p.clone() for n, p in eng.caches["ssm"].items()}
    n0 = eng.stats["aux_dispatches"]
    eng.submit(TRequest("a", list(range(3, 24)), 4))
    eng._plan_chunks()                       # admits into slot 0
    assert eng.stats["aux_dispatches"] == n0 + 1
    for n, p in eng.caches["ssm"].items():
        assert not p[:, 0].any(), n
        assert torch.equal(p[:, 1], before[n][:, 1]), n
