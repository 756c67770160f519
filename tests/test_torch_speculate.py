"""N-gram speculative decoding in the PyTorch port against the JAX
package, case for case with tests/test_speculative.py: the draft
proposer, the adaptive draft length, `BlockManager.truncate` (the same
tables, refcounts, free and LRU lists and prefix index on both sides),
and the engines on the same weights and request sets with speculation on
and off. Tokens and engine counters (`stats`, `spec_stats()`,
`prefix_cache_stats()`, `tiered_stats()`) are compared for equality,
since the reference defines them bitwise; on the CPU both frameworks take
the same paths (a verification chunk and a one-token decode both read
the pool through the plain attention)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           serving_pair, settled_jax_tables)
from repro.core.policy import AdaptiveKController as JAdaptiveK  # noqa: E402
from repro.core.policy import SpeculationConfig as JSpec  # noqa: E402
from repro.core.policy import StepObservation as JObs  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.kvcache import BlockManager as JBlockManager  # noqa: E402
from repro.serving.speculate import NgramProposer as JProposer  # noqa: E402
from repro_torch.core.policy import AdaptiveKController as TAdaptiveK  # noqa: E402
from repro_torch.core.policy import SpeculationConfig as TSpec  # noqa: E402
from repro_torch.core.policy import StepObservation as TObs  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.kvcache import TRASH_BLOCK  # noqa: E402
from repro_torch.serving.kvcache import BlockManager as TBlockManager  # noqa: E402
from repro_torch.serving.speculate import NgramProposer as TProposer  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = configs("gemma3-1b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


# ---------------------------------------------------------------------------
# draft proposer
# ---------------------------------------------------------------------------

# (config kwargs, history, k, expected draft): test_speculative.py's cases
PROPOSER_CASES = {
    "most-recent-occurrence": (dict(ngram_max=2, ngram_min=1),
                               [1, 2, 5, 9, 1, 2, 7, 8, 1, 2], 2, [7, 8]),
    "longest-ngram-wins": (dict(ngram_max=3, ngram_min=1),
                           [2, 3, 4, 5, 4, 9, 2, 3, 4], 1, [5]),
    "no-match": ({}, [1, 2, 3, 4, 5], 4, []),
    "too-short": ({}, [7], 4, []),
    "empty": ({}, [], 4, []),
    "k-clamps-3": (dict(ngram_max=1, ngram_min=1), [5, 1, 2, 3, 4, 5], 3,
                   [1, 2, 3]),
    "k-clamps-99": (dict(ngram_max=1, ngram_min=1), [5, 1, 2, 3, 4, 5], 99,
                    [1, 2, 3, 4, 5]),
    "k-zero": (dict(ngram_max=1, ngram_min=1), [5, 1, 2, 3, 4, 5], 0, []),
    "pure-repetition": (dict(ngram_min=1), [6, 6, 6, 6], 3, [6, 6, 6]),
}


@pytest.mark.parametrize("case", sorted(PROPOSER_CASES))
def test_proposer_matches_jax(case):
    kw, hist, k, want = PROPOSER_CASES[case]
    got = TProposer(TSpec(**kw)).propose(list(hist), k)
    assert got == JProposer(JSpec(**kw)).propose(list(hist), k) == want


def test_proposer_matches_jax_on_random_histories():
    rng = np.random.default_rng(0)
    tp, jp = TProposer(TSpec(ngram_min=1)), JProposer(JSpec(ngram_min=1))
    for _ in range(200):
        hist = [int(t) for t in rng.integers(0, 4, rng.integers(0, 30))]
        k = int(rng.integers(0, 9))
        assert tp.propose(hist, k) == jp.propose(hist, k)


# ---------------------------------------------------------------------------
# adaptive draft length
# ---------------------------------------------------------------------------

# (config kwargs, [(drafted, accepted)] per step): test_speculative.py's
# TestAdaptiveK cases, as observation streams
ADAPT_CASES = {
    "grows-to-ceiling": (dict(k_init=2, k_max=4), [(4, 4)] * 20),
    "floors-at-k-min": (dict(k_init=4, k_min=1), [(4, 0)] * 20),
    "no-adapt-below-min-drafted": (dict(k_init=3, adapt_min_drafted=50),
                                   [(4, 0)] * 5),
    "draftless-steps-leave-window": (dict(k_init=2),
                                     [(4, 4)] * 10 + [(0, 0)] * 10),
}


@pytest.mark.parametrize("case", sorted(ADAPT_CASES))
def test_adaptive_k_matches_jax(case):
    kw, stream = ADAPT_CASES[case]
    tc, jc = TAdaptiveK(TSpec(**kw)), JAdaptiveK(JSpec(**kw))
    for d, a in stream:
        common = dict(batch_tokens=1, queue_depth=0, measured_step_ms=None,
                      spec_drafted=d, spec_accepted=a)
        assert tc.decide(TObs(**common)) == jc.decide(JObs(**common))
    assert tc.history == jc.history
    assert tc.acceptance_rate() == jc.acceptance_rate()
    want = {"grows-to-ceiling": 4, "floors-at-k-min": 1,
            "no-adapt-below-min-drafted": 3}.get(case)
    if want is not None:
        assert tc.k == want
    else:
        assert tc.acceptance_rate() == 1.0 and tc.history[9] == tc.k


# ---------------------------------------------------------------------------
# truncate rollback
# ---------------------------------------------------------------------------

def _same_managers(jb, tb):
    assert (jb.group_tables() == tb.group_tables()).all()
    assert jb._ref == tb._ref and jb._free == tb._free
    assert [list(x) for x in jb._lru] == [list(x) for x in tb._lru]
    assert jb._index == tb._index and jb._hash_of == tb._hash_of
    assert jb.prefix_stats == tb.prefix_stats
    assert [None if s is None else (s.length, [(g.blocks, g.hashes, g.slid)
                                               for g in s.groups])
            for s in jb.seqs] == \
        [None if s is None else (s.length, [(g.blocks, g.hashes, g.slid)
                                            for g in s.groups])
         for s in tb.seqs]
    tb.check_invariants()


def _drops_exclusive(bm):
    a = bm.try_allocate("a", 4, 12)
    assert bm.ensure(a, 14)              # 4 blocks
    bm.set_length(a, 9)
    free0 = bm.n_free_blocks()
    assert bm.truncate(a, 6) == 2        # blocks 2, 3 dropped
    assert bm.n_free_blocks() == free0 + 2
    assert bm.seqs[a].length == 6
    tab = bm.group_tables()[0, a]
    assert (tab[2:] == TRASH_BLOCK).all() and (tab[:2] != TRASH_BLOCK).all()


def _above_coverage_noop(bm):
    a = bm.try_allocate("a", 4, 4)
    assert bm.ensure(a, 5)
    bm.set_length(a, 5)
    assert bm.truncate(a, 100) == 0
    assert bm.seqs[a].length == 5


def _shared_survives(bm):
    toks = list(range(12))
    a = bm.try_allocate("a", 12, 0, bm.prefix_admit_discount(toks))
    assert bm.ensure(a, 12)
    bm.commit(a, 12, toks)               # 3 registered full blocks
    b = bm.try_allocate("b", 12, 0, bm.prefix_admit_discount(toks))
    assert bm.attach_prefix(b, toks) == 12
    shared = list(bm.seqs[b].groups[0].blocks)
    assert bm.truncate(b, 4) == 2        # b lets go of 2 shared blocks
    assert bm.seqs[a].groups[0].blocks == shared
    assert bm.lookup_prefix(toks) == 12


def _registered_parks_in_lru(bm):
    toks = list(range(8))
    a = bm.try_allocate("a", 8, 0, bm.prefix_admit_discount(toks))
    assert bm.ensure(a, 8)
    bm.commit(a, 8, toks)
    cached0 = bm.n_cached_blocks()
    bm.truncate(a, 4)                    # drop a committed full block
    assert bm.n_cached_blocks() == cached0 + 1
    assert bm.lookup_prefix(toks) == 8


def _partial_cut_evicts(bm):
    toks = list(range(8))
    a = bm.try_allocate("a", 8, 0, bm.prefix_admit_discount(toks))
    assert bm.ensure(a, 8)
    bm.commit(a, 8, toks)
    assert bm.lookup_prefix(toks) == 8
    ev0 = bm.prefix_stats["evictions"]
    bm.truncate(a, 6)                    # the second block is half valid
    assert bm.prefix_stats["evictions"] == ev0 + 1
    assert bm.lookup_prefix(toks) == 4


def _slid_holes_stay(bm):
    a = bm.try_allocate("a", 4, 24)
    assert bm.ensure(a, 26)
    bm.set_length(a, 25)
    bm.slide_window(a)
    g = bm.seqs[a].groups[1]
    assert g.slid > 0
    holes = list(g.blocks[:g.slid])
    assert all(b == TRASH_BLOCK for b in holes)
    bm.truncate(a, 9)
    n = min(g.slid, len(g.blocks))
    assert g.blocks[:n] == holes[:n]


def _device_mirror(bm):
    a = bm.try_allocate("a", 4, 12)
    assert bm.ensure(a, 14)
    bm.set_length(a, 13)
    np.testing.assert_array_equal(np.asarray(bm.device_tables()),
                                  bm.group_tables())
    dev = bm.device_tables()
    bm.truncate(a, 3)
    # the trashed entries reach the device table, in place
    np.testing.assert_array_equal(np.asarray(bm.device_tables()),
                                  bm.group_tables())
    if isinstance(dev, torch.Tensor):
        assert bm.device_tables().data_ptr() == dev.data_ptr()


# (BlockManager args, kwargs, scenario): test_speculative.py's TestTruncate
TRUNCATE_CASES = {
    "drops-exclusive-blocks": ((2, 4, 8, 8), dict(prefix_cache=False),
                               _drops_exclusive),
    "above-coverage-noop": ((2, 4, 8, 8), {}, _above_coverage_noop),
    "shared-block-survives": ((2, 4, 8, 8), dict(prefix_cache=True),
                              _shared_survives),
    "registered-parks-in-lru": ((2, 4, 8, 8), dict(prefix_cache=True),
                                _registered_parks_in_lru),
    "partial-cut-evicts-tail": ((2, 4, 8, 8), dict(prefix_cache=True),
                                _partial_cut_evicts),
    "slid-holes-stay-holes": ((2, 4, 12, 8),
                              dict(prefix_cache=False,
                                   group_windows=(None, 5)),
                              _slid_holes_stay),
    "device-mirror": ((2, 4, 8, 8), {}, _device_mirror),
}


@pytest.mark.parametrize("case", sorted(TRUNCATE_CASES))
def test_truncate_matches_jax(case):
    args, kw, scenario = TRUNCATE_CASES[case]
    jb, tb = JBlockManager(*args, **kw), TBlockManager(*args, **kw)
    scenario(jb)
    scenario(tb)
    _same_managers(jb, tb)


def test_truncate_matches_jax_under_op_soup():
    """A seeded sequence of allocate / attach / ensure / COW / commit /
    truncate / release with window groups: the same state after every
    op."""
    rng = np.random.default_rng(9)
    kw = dict(n_slots=3, block_size=4, n_blocks=16, max_blocks_per_seq=8,
              prefix_cache=True, group_windows=(None, 6))
    jb, tb = JBlockManager(**kw), TBlockManager(**kw)
    streams = [[int(t) for t in rng.integers(1, 5, 30)] for _ in range(2)]
    live: dict[int, list[int]] = {}
    n_trunc = 0
    for _ in range(300):
        op = int(rng.integers(0, 4))
        if op == 0 and len(live) < 3:
            toks = streams[int(rng.integers(0, 2))][: int(rng.integers(4, 22))]
            disc = tb.prefix_admit_discount(toks)
            a = jb.try_allocate("r", len(toks), 6, cached_blocks=disc)
            assert a == tb.try_allocate("r", len(toks), 6, cached_blocks=disc)
            if a is not None:
                m = jb.attach_prefix(a, toks)
                assert m == tb.attach_prefix(a, toks)
                for bm in (jb, tb):
                    bm.set_length(a, min(m, len(toks) - 1))
                live[a] = toks
        elif op == 1 and live:
            idx = list(live)[int(rng.integers(0, len(live)))]
            toks = live[idx]
            n = min(len(toks), tb.seqs[idx].length + int(rng.integers(1, 7)))
            ok = jb.ensure(idx, n)
            assert ok == tb.ensure(idx, n)
            if ok:
                start = tb.seqs[idx].length
                jp, tp = (bm.cow_for_write(idx, start, n) for bm in (jb, tb))
                assert jp == tp
                if tp is not None:
                    jb.commit(idx, n, toks)
                    tb.commit(idx, n, toks)
        elif op == 2 and live:
            idx = list(live)[int(rng.integers(0, len(live)))]
            cut = int(rng.integers(0, tb.seqs[idx].length + 1))
            assert jb.truncate(idx, cut) == tb.truncate(idx, cut)
            n_trunc += 1
        elif op == 3 and live:
            idx = list(live)[int(rng.integers(0, len(live)))]
            jb.release(idx)
            tb.release(idx)
            del live[idx]
        _same_managers(jb, tb)
    assert n_trunc > 20 and tb.window_freed_blocks > 0


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

REP = [5, 6, 7, 8] * 6                       # repetitive: drafts accept
MIX = [list(range(3, 11)), list(range(40, 48)), REP]


def _spec(on, side):
    if not on:
        return None
    return (JSpec if side == "jax" else TSpec)(ngram_min=1)


def _run(pair, prompts, *, spec, max_new=8, stop_tokens=(), seed_run=None,
         **kw):
    """The JAX engine and the port's on the same prompts; returns
    (jax outputs, port outputs, jax engine, port engine). seed_run: one
    request served to the end first (prefix-cache warm-up)."""
    jcfg, tcfg, jsp, tsp = pair
    kw = dict(dict(n_slots=4, capacity=96), **kw)
    jeng = JEngine(jcfg, jsp, speculate=_spec(spec, "jax"), **kw)
    teng = TEngine(tcfg, tsp, device="cpu", debug_invariants=True,
                   speculate=_spec(spec, "torch"), **kw)
    outs = []
    for eng, R in ((jeng, JRequest), (teng, TRequest)):
        if seed_run is not None:
            eng.submit(R("seed", list(seed_run), max_new=max_new))
            eng.run()
        for i, p in enumerate(prompts):
            eng.submit(R(f"r{i}", list(p), max_new=max_new,
                         stop_tokens=stop_tokens))
        fin = {r.request_id: r.output for r in eng.run()}
        outs.append([fin[k] for k in sorted(fin)])
    return outs[0], outs[1], jeng, teng


def _assert_same(jeng, teng):
    shared = set(teng.stats) & set(jeng.stats)
    assert {k: teng.stats[k] for k in shared} == \
        {k: jeng.stats[k] for k in shared}
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.tiered_stats() == jeng.tiered_stats()
    assert teng.iteration == jeng.iteration
    if teng._spec_k is not None:
        assert teng._spec_k.history == jeng._spec_k.history
    assert teng.graphs.keys("spec") == set(jeng._spec_cache)


@pytest.mark.usefixtures("one_torch_thread", "settled_jax_tables")
class TestSpeculativeEngine:
    @pytest.mark.parametrize("mode", ["fp16", "fp8"])
    @pytest.mark.parametrize("planar", [False, True])
    def test_on_off_match_jax(self, qwen, mode, planar):
        off_j, off_t, je0, te0 = _run(qwen, MIX, spec=False,
                                      forced_mode=mode, kv_planar=planar)
        on_j, on_t, je1, te1 = _run(qwen, MIX, spec=True, forced_mode=mode,
                                    kv_planar=planar)
        assert on_t == on_j == off_j == off_t
        _assert_same(je0, te0)
        _assert_same(je1, te1)
        assert te1.spec_stats()["accepted"] > 0, \
            "repetitive prompt never accepted a draft: vacuous parity"
        assert te1.graphs.keys("spec")

    def test_prefix_sharing(self, qwen):
        """A seed run fills the cache; two requests sharing its prefix
        then run with speculation: accepted runs fork before writing."""
        kw = dict(forced_mode="fp16", block_size=4,
                  seed_run=REP, prompts=[REP, list(REP) + [9, 9]])
        off_j, off_t, _, te0 = _run(qwen, spec=False, **kw)
        on_j, on_t, je1, te1 = _run(qwen, spec=True, **kw)
        assert on_t == on_j == off_j == off_t
        _assert_same(je1, te1)
        assert te1.prefix_cache_stats()["hit_rate"] > 0

    def test_preemption(self, qwen):
        kw = dict(forced_mode="fp16", block_size=4, n_blocks=14, max_new=10)
        off_j, off_t, je0, te0 = _run(qwen, MIX, spec=False, **kw)
        on_j, on_t, je1, te1 = _run(qwen, MIX, spec=True, **kw)
        assert on_t == on_j == off_j == off_t
        _assert_same(je0, te0)
        _assert_same(je1, te1)
        assert te1.stats["preemptions"] > 0 or te0.stats["preemptions"] > 0

    def test_gemma3_window_reclaim(self, gemma):
        prompts = [[3, 4, 5] * 9, [11, 12] * 12]     # > window 19
        kw = dict(forced_mode="fp16", block_size=4, max_new=10)
        off_j, off_t, je0, te0 = _run(gemma, prompts, spec=False, **kw)
        on_j, on_t, je1, te1 = _run(gemma, prompts, spec=True, **kw)
        assert on_t == on_j == off_j == off_t
        _assert_same(je1, te1)
        assert te1.stats["window_reclaimed_blocks"] > 0
        assert te1.spec_stats()["accepted"] > 0

    def test_fewer_dispatches(self, qwen):
        off_j, off_t, je0, te0 = _run(qwen, [REP], spec=False,
                                      forced_mode="fp16", max_new=12)
        on_j, on_t, je1, te1 = _run(qwen, [REP], spec=True,
                                    forced_mode="fp16", max_new=12)
        assert on_t == on_j == off_j == off_t
        _assert_same(je1, te1)
        ss = te1.spec_stats()
        assert ss["spec_dispatches"] > 0
        assert ss["tokens_accepted_per_dispatch"] > 1.0
        assert te1.stats["decode_dispatches"] < te0.stats["decode_dispatches"]
        assert te1.stats["prefill_dispatches"] == \
            te0.stats["prefill_dispatches"]

    @pytest.mark.parametrize("where", ["mid-run", "first-token"])
    def test_stop_token(self, qwen, where):
        full, _, _, _ = _run(qwen, [REP], spec=False, forced_mode="fp16",
                             max_new=12)
        stop = full[0][3] if where == "mid-run" else full[0][0]
        want = full[0][:full[0].index(stop) + 1]
        for spec in (False, True):
            jo, to, je, te = _run(qwen, [REP], spec=spec, forced_mode="fp16",
                                  max_new=12, stop_tokens=(stop,))
            assert to == jo == [want], (spec, to, want)
            _assert_same(je, te)

    def test_spec_stats_zero_traffic(self, qwen):
        jcfg, tcfg, jsp, tsp = qwen
        je = JEngine(jcfg, jsp, n_slots=2, capacity=64, speculate=True)
        te = TEngine(tcfg, tsp, n_slots=2, capacity=64, speculate=True,
                     device="cpu")
        ss = te.spec_stats()
        assert ss == je.spec_stats()
        assert ss["acceptance_rate"] == 0.0
        assert ss["tokens_accepted_per_dispatch"] == 0.0

    def test_spec_key_replays_as_eager(self, qwen):
        """Each spec key's staged run equals the eager verification step
        on clones of its inputs, the tables and the pool (checked inside
        the step that first runs it)."""
        _, tcfg, _, tsp = qwen
        eng = TEngine(tcfg, tsp, device="cpu", n_slots=4, capacity=96,
                      forced_mode="fp8", kv_planar=True,
                      speculate=TSpec(ngram_min=1))
        for i, p in enumerate(MIX):
            eng.submit(TRequest(f"r{i}", list(p), max_new=8))
        eng.graphs.check_first_runs = True
        eng.run()
        spec = [k for k in eng.graphs.checks if k[0] == "spec"]
        assert spec
        assert all(all(eng.graphs.checks[k].values()) for k in spec), \
            eng.graphs.checks
        x = eng.graphs._steps[spec[0]]
        assert tuple(x.ids.shape) == (4, spec[0][2] + 1)


@pytest.mark.usefixtures("one_torch_thread")
def test_serve_cli_speculate(capsys):
    """`launch/serve.py --speculate` serves on the CPU and reports the
    speculation fields."""
    import json

    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                       "cpu", "--speculate", "--requests", "3",
                       "--max-new", "8"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["finished"] == 3
    assert out["spec_tokens_per_dispatch"] >= 1.0
    assert 0.0 <= out["spec_acceptance_rate"] <= 1.0
