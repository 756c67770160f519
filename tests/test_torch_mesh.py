"""Tensor-parallel paged serving on the port: `Engine(mesh=...)` over
shards that share the CPU (`make_serving_mesh(m, devices=["cpu"] * m)`,
the counterpart of the JAX package's forced host device count), held to
the JAX package's single-device engine (greedy outputs, on the same
weights) and to the port's unsharded engine (the same outputs, and
`stats` equal: a mesh counts logical steps). The JAX package's own
acceptance (tests/test_mesh_serving.py) is its mesh equal to its single
device; the lifecycle is that file's: speculation, one-dispatch prefill,
preemption, COW prefix forks, the incremental table mirror, gemma3's
window reclaim, plus the host tier's spill and restore. Then the bitwise
pieces (row-parallel FP8 codes, sharded exception tensors, the
vocab-sharded argmax), the router over replica meshes, and what a mesh
refuses (encdec, and q heads split over kv heads kept whole). The moe,
ssm and hybrid families on a mesh are tests/test_torch_mesh_families.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           serving_pair, settled_jax_tables)
from repro.core.quant import quantize_act_per_token as j_quant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.core import nestedfp as nf  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.policy import SpeculationConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_replica_meshes,  # noqa: E402
                                     make_serving_mesh)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving import shard as SHARD  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.RandomState(11)
PROMPTS = [[int(t) for t in RNG.randint(1, 200, n)] for n in (13, 29, 7, 21)]
LONG = [[int(t) for t in np.random.RandomState(3).randint(1, 200, n)]
        for n in (24, 18, 30, 11)]
SHARED = list(range(40, 72))                 # two full 16-token blocks


def cpu_mesh(m: int) -> Mesh:
    return make_serving_mesh(m, devices=["cpu"] * m)


@pytest.fixture(scope="module")
def qwen():
    """qwen1.5-0.5b reduced (4 q / 4 kv heads, d_model 256, vocab 512),
    layer 1's wo an exception tensor, on both sides."""
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=True)
    return jcfg, tcfg, jsp, tsp


def _jax(pair, reqs, **kw) -> dict:
    jcfg, _, jsp, _ = pair
    eng = JEngine(jcfg, jsp, **kw)
    for rid, toks, max_new in reqs:
        eng.submit(JRequest(rid, list(toks), max_new))
    return {r.request_id: r.output for r in eng.run()}


def _port(pair, mesh, reqs, **kw):
    _, tcfg, _, tsp = pair
    eng = TEngine(tcfg, tsp, device="cpu", mesh=mesh, **kw)
    for rid, toks, max_new in reqs:
        eng.submit(TRequest(rid, list(toks), max_new))
    return {r.request_id: r.output for r in eng.run()}, eng


def _both(pair, mesh, reqs, **kw):
    """The port's engine unsharded and on `mesh`: equal outputs and
    stats. Returns (outputs, unsharded engine, mesh engine)."""
    ref, eref = _port(pair, None, reqs, **kw)
    got, egot = _port(pair, mesh, reqs, **kw)
    assert got == ref
    assert egot.stats == eref.stats, (eref.stats, egot.stats)
    assert egot.prefix_cache_stats() == eref.prefix_cache_stats()
    return got, eref, egot


def _reqs(prompts, max_new, tag="r"):
    return [(f"{tag}{i}", p, max_new) for i, p in enumerate(prompts)]


LAYOUTS = {2: ("col", "row", "col", True), 3: ("whole",) * 3 + (False,),
           4: ("col", "row", "col", True), 8: ("row", "col", "col", True)}


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("m", sorted(LAYOUTS))
def test_mesh_matches_jax_and_unsharded(qwen, m, mode):
    """Greedy decode over planar KV at 2 and 4 shards (head-parallel), 3
    (the row-parallel branch, whole where 3 divides nothing) and 8 (q, k,
    v row-parallel, wo by columns)."""
    lay = SH.serving_layout(qwen[1], cpu_mesh(m))
    assert (lay.q, lay.wo, lay.mlp, lay.vocab) == LAYOUTS[m]
    kw = dict(n_slots=8, capacity=64, forced_mode=mode, kv_planar=True,
              prefix_cache=False)
    reqs = _reqs(PROMPTS, 6)
    got, _, _ = _both(qwen, cpu_mesh(m), reqs, **kw)
    assert got == _jax(qwen, reqs, **kw)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_speculative_decode_under_mesh(qwen, mode):
    """N-gram speculation on 4 shards emits the plain single-device
    tokens and accepts drafts while doing it."""
    rep = [5, 6, 7, 8] * 6
    reqs = _reqs([rep, list(range(3, 11))], 8, "s")
    kw = dict(n_slots=4, capacity=96, forced_mode=mode, kv_planar=True,
              prefix_cache=False)
    want = _jax(qwen, reqs, **kw)
    got, _, egot = _both(qwen, cpu_mesh(4), reqs,
                         speculate=SpeculationConfig(ngram_min=1), **kw)
    assert got == want
    st = egot.spec_stats()
    assert st["accepted"] > 0 and st["tokens_accepted_per_dispatch"] > 1.0


def test_prefill_stays_one_dispatch_under_mesh(qwen):
    _, tcfg, _, tsp = qwen
    eng = TEngine(tcfg, tsp, n_slots=8, capacity=64, forced_mode="fp16",
                  chunk_tokens=512, prefix_cache=False, device="cpu",
                  mesh=cpu_mesh(4))
    for rid, toks, n in _reqs(PROMPTS, 2):
        eng.submit(TRequest(rid, toks, n))
    eng.step()
    assert eng.stats["chunks"] == len(PROMPTS)
    assert eng.stats["prefill_dispatches"] == 1
    assert eng.stats["decode_dispatches"] == 1


@pytest.mark.parametrize("m", [3, 4])
def test_preempt_and_requeue_under_mesh(qwen, m):
    kw = dict(n_slots=8, capacity=96, forced_mode="fp16", kv_planar=True,
              block_size=16, n_blocks=8, prefix_cache=False)
    reqs = _reqs(LONG, 10, "p")
    got, _, egot = _both(qwen, cpu_mesh(m), reqs, **kw)
    assert egot.stats["preemptions"] > 0
    assert got == _jax(qwen, reqs, **kw)


def test_cow_prefix_fork_under_mesh(qwen):
    """A prefix hit resumed inside the shared tail block forks it: the
    block copy runs on every shard's pool."""
    kw = dict(n_slots=8, capacity=96, forced_mode="fp8", kv_planar=True,
              block_size=16)

    def serve(side, mesh=None):
        first = [("seed", SHARED + [7], 4)]
        forks = [(f"fork{i}", SHARED, 6) for i in range(2)]
        if side == "jax":
            out = _jax(qwen, first, **kw)
            out.update(_jax(qwen, first + forks, **kw))
            return out, None
        _, tcfg, _, tsp = qwen
        eng = TEngine(tcfg, tsp, device="cpu", mesh=mesh, **kw)
        for batch in (first, forks):
            for rid, toks, n in batch:
                eng.submit(TRequest(rid, list(toks), n))
            eng.run()
        return {r.request_id: r.output for r in eng.finished}, eng

    ref, eref = serve("torch")
    got, egot = serve("torch", cpu_mesh(4))
    ps = egot.prefix_cache_stats()
    assert ps["hit_rate"] > 0 and ps["cow_forks"] > 0, ps
    assert got == ref and egot.stats == eref.stats
    assert ps == eref.prefix_cache_stats()
    want, _ = serve("jax")
    assert {k: got[k] for k in want} == want


def test_table_mirror_stays_incremental_under_mesh(qwen):
    """One device table serves the shards on a device, and the flushes
    stay O(dirty) entries: never a re-upload, never one a shard."""
    _, tcfg, _, tsp = qwen
    eng = TEngine(tcfg, tsp, n_slots=4, capacity=64, forced_mode="fp16",
                  prefix_cache=False, device="cpu", mesh=cpu_mesh(4))
    tables = eng.graphs.tables
    assert len(tables) == 4 and all(t is tables[0] for t in tables)
    eng.submit(TRequest("r", list(range(5, 20)), 20))
    eng.step()                          # prefill + first decode
    full = eng.blocks.group_tables().nbytes
    b0, f0 = eng.blocks.table_h2d_bytes, eng.blocks.table_flushes
    eng.step()                          # len 16 -> 17: one new block
    assert 0 < eng.blocks.table_h2d_bytes - b0 < full
    assert eng.blocks.table_flushes == f0 + 1
    b1 = eng.blocks.table_h2d_bytes
    for _ in range(3):                  # decode inside block 2
        eng.step()
    assert eng.blocks.table_h2d_bytes == b1


def test_host_tier_spill_and_restore_under_mesh(qwen):
    """A scarce pool spills evicted prefix blocks to the host tier and
    restores them (hi planes, then the lo planes at the first FP16 step).
    A host entry is the logical block, every shard's planes together:
    the entries are the unsharded engine's keys and shapes, and every
    checksum verifies."""
    kw = dict(n_slots=8, capacity=96, forced_mode="fp16", kv_planar=True,
              block_size=16, n_blocks=8)
    reqs = _reqs(LONG, 10, "t")
    got, eref, egot = _both(qwen, cpu_mesh(4), reqs, **kw)
    st = egot.tiered_stats()
    assert st["spilled_blocks"] > 0 and st["restored_blocks"] > 0, st
    assert st == eref.tiered_stats()
    host, href = egot.blocks.host, eref.blocks.host
    assert set(host.entries) == set(href.entries)
    for key, planes in host.entries.items():
        assert host.verify(key)
        assert {n: a.shape for n, a in planes.items()} == \
            {n: a.shape for n, a in href.entries[key].items()}
    assert got == _jax(qwen, reqs, **kw)


@pytest.mark.usefixtures("settled_jax_tables")         # F-ref-3
def test_gemma3_window_reclaim_under_mesh():
    """gemma3-1b reduced (4 q heads, 1 kv head) on 4 shards: q heads
    split, K/V and the pool whole on every shard (its own copy), K4 per
    shard over it; local-layer blocks slide free as without a mesh."""
    jcfg, tcfg = configs("gemma3-1b")
    pair = (jcfg, tcfg) + serving_pair(jcfg, tcfg.n_layers,
                                       plant_exception=False)
    mesh = cpu_mesh(4)
    lay = SH.serving_layout(tcfg, mesh)
    assert (lay.q, lay.kv, lay.pool) == ("col", "whole", False)
    long = [int(t) for t in np.random.RandomState(7).randint(1, 200, 96)]
    kw = dict(n_slots=4, capacity=128, forced_mode="fp16", kv_planar=True,
              block_size=16)
    reqs = [("w", long, 8)]
    got, _, egot = _both(pair, mesh, reqs, **kw)
    assert egot.stats["window_reclaimed_blocks"] > 0, egot.stats
    assert [p.shape[3] for c in egot.caches
            for p in c["attn"].values()] == [1] * 16
    assert got == _jax(pair, reqs, **kw)


# ---------------------------------------------------------------------------
# bitwise pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_row_parallel_fp8_codes_are_the_unsharded_ones(m):
    """Per-token FP8 of a row cut into column slices: each slice's absmax,
    their max across shards, the scale from it, the slice's codes. Codes
    and scales are bitwise the unsharded quantizer's (the port's and the
    JAX package's) at those columns, with a zero row, a row whose max
    lies in the last slice, and e4m3 midpoints."""
    mesh = cpu_mesh(m)
    g = np.random.default_rng(5)
    x = g.standard_normal((6, 64)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, -1] = 40.0
    x[3, :8] = np.float32(448 / 40.0) * np.array(
        [1.0625, 1.1875, 2.125, 2.375, -1.0625, 0.5, 3.25, 14.5], np.float32)
    x[3, 9] = 40.0
    xt = torch.from_numpy(x)
    want_q, want_s = quant.quantize_act_per_token(xt)
    jq, js = j_quant(x)
    assert torch.equal(want_q.view(torch.uint8),
                       torch.from_numpy(np.array(jq).view(np.uint8)))
    assert torch.equal(want_s, torch.from_numpy(np.array(js)))
    c = 64 // m
    parts = [xt[:, s * c:(s + 1) * c].contiguous() for s in range(m)]
    amax = mesh.all_reduce([ops.act_row_absmax(p) for p in parts], op="max")
    scales = [quant.scale_from_amax(a) for a in amax]
    codes = [ops.quantize_act_scaled(p, sc) for p, sc in zip(parts, scales)]
    assert all(torch.equal(sc, want_s) for sc in scales)
    assert torch.equal(torch.cat(codes, dim=1).view(torch.uint8),
                       want_q.view(torch.uint8))


def test_sharded_exception_tensor_stays_an_exception(qwen):
    """A weight with one |w| > 1.75 is an exception tensor; its slices
    keep its raw f16 and stay exceptions in every shard, including those
    whose slice holds no large value (re-encoding such a slice would nest
    it and send it through K2)."""
    _, tcfg, _, tsp = qwen
    wo = tsp["layers"][1]["attn"]["wo"]
    assert wo.weight.is_exception
    shards = SHARD.shard_serving_params(tsp, tcfg, cpu_mesh(4))
    rows = wo.weight.shape[0] // 4
    for s, sp in enumerate(shards):
        w = sp["layers"][1]["attn"]["wo"].weight
        assert w.is_exception and w.upper is None
        assert torch.equal(w.raw, wo.weight.raw[s * rows:(s + 1) * rows])
    quiet = shards[1]["layers"][1]["attn"]["wo"].weight.raw
    assert not nf.NestedTensor.from_f16(quiet).is_exception
    for sp in shards:                       # nested weights stay nested
        assert not sp["layers"][1]["attn"]["wq"].weight.is_exception


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_sharded_argmax_takes_the_first_maximum(m):
    """Ties within a shard, across shards, across all; a row whose max is
    in the last shard; (B, C, V) verify-chunk logits."""
    mesh = cpu_mesh(m)
    v = 16
    rows = torch.randn(7, v)
    rows[0] = 1.0                                   # all tied: index 0
    rows[1, [3, 11]] = 9.0                          # tie across shards
    rows[2, [9, 10]] = 9.0                          # tie inside a shard
    rows[3, -1] = 9.0                               # last shard
    rows[4] = -5.0
    rows[4, [2, 14]] = 0.0
    rows[5, [v // m, v // m + 1, 1]] = 7.0          # first of a shard
    chunk = torch.randn(2, 3, v).round()            # many ties
    for logits in (rows, chunk):
        c = v // m
        parts = [logits[..., s * c:(s + 1) * c] for s in range(m)]
        got = TM.sharded_argmax(mesh, parts)
        assert torch.equal(got, torch.argmax(logits, dim=-1).to(torch.int32))


def test_mesh_pools_follow_the_cache_spec(qwen):
    _, tcfg, _, _ = qwen
    caches = TM.init_paged_cache(tcfg, 9, 16, planar=True, mesh=cpu_mesh(4))
    assert len(caches) == 4
    for c in caches:
        assert {n: tuple(p.shape) for n, p in c["attn"].items()} == \
            {n: (tcfg.n_layers, 9, 16, 1, tcfg.resolved_head_dim)
             for n in ("k_hi", "k_lo", "v_hi", "v_lo")}
    assert len({c["attn"]["k_hi"].data_ptr() for c in caches}) == 4


# ---------------------------------------------------------------------------
# the router over replica meshes; what a mesh refuses
# ---------------------------------------------------------------------------

def test_replica_mesh_slices_failover(qwen):
    """tests/test_router.py's case on the port: two replicas of 2 shards
    each (four shard slots on the CPU), replica 0 killed at step 3, every
    request served and none lost."""
    _, tcfg, _, tsp = qwen
    meshes = make_replica_meshes(2, 2, devices=["cpu"] * 4)
    assert not set(meshes[0].slots) & set(meshes[1].slots)
    with pytest.raises(RuntimeError):
        make_replica_meshes(3, 2, devices=["cpu"] * 4)
    plan = tfaults.FaultPlan([tfaults.FaultEvent(3, 0, "kill")])
    r = trouter.Router.build(tcfg, tsp, 2, meshes=meshes, plan=plan,
                             affinity_blocks=1,
                             engine_kwargs=dict(n_slots=2, capacity=64,
                                                forced_mode="fp16",
                                                block_size=16, n_blocks=11,
                                                chunk_tokens=32,
                                                device="cpu"))
    assert [rep.engine.mesh for rep in r.replicas] == meshes
    rng = np.random.default_rng(3)
    sysp = rng.integers(1, tcfg.vocab_size, size=32).tolist()
    for i in range(3):
        r.submit(TRequest(f"r{i}", sysp + np.random.default_rng(11 * i + 1)
                          .integers(1, tcfg.vocab_size, size=6).tolist(), 8))
    r.run()
    st = r.stats()
    assert len(r.finished) == 3 and st["lost"] == 0 and st["kills"] == 1
    assert all(len(q.output) == 8 for q in r.finished)


def test_only_encdec_is_refused_a_mesh():
    """Every decoder-only family shards (tests/test_torch_mesh_families.py
    serves the moe, ssm and hybrid ones); encdec is refused by
    `shard_serving_params` and `sharded_paged_step`, as the engine
    refuses it unsharded."""
    mesh = cpu_mesh(2)
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b", "mamba2-2.7b",
                 "zamba2-2.7b"):
        SHARD.check_family(TARCHS[arch].reduced())
    cfg = TARCHS["seamless-m4t-large-v2"].reduced()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        SHARD.shard_serving_params({}, cfg, mesh)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        SHARD.sharded_paged_step(
            mesh, None, [{}, {}], cfg, torch.zeros((1, 1), dtype=torch.int32),
            [{}, {}], torch.zeros((1, 1), dtype=torch.int32), q_offset=None,
            kv_len=None, block_size=16)


def test_q_heads_split_over_whole_kv_heads_is_refused(qwen):
    """8 q heads over 2 kv heads on 4 shards: each shard's q heads would
    not be whole GQA groups of the pool's kv heads, kept whole."""
    import dataclasses
    cfg = dataclasses.replace(qwen[1], n_heads=8, n_kv_heads=2)
    with pytest.raises(NotImplementedError, match="kv heads kept whole"):
        SH.serving_layout(cfg, cpu_mesh(4))


def test_encdec_stays_refused_under_a_mesh():
    cfg = TARCHS["seamless-m4t-large-v2"].reduced()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        TEngine(cfg, {}, n_slots=2, capacity=64, mesh=cpu_mesh(2))


def test_mesh_builders():
    with pytest.raises(RuntimeError):
        make_serving_mesh(4, devices=["cpu"] * 3)
    mesh = make_serving_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.colocated and mesh.slots == (0, 1, 2)
    parts = [torch.full((2,), float(s)) for s in range(3)]
    assert all(torch.equal(t, torch.full((2,), 3.0))
               for t in mesh.all_reduce(parts))
    assert torch.equal(mesh.all_gather(parts)[2],
                       torch.tensor([0.0, 0, 1, 1, 2, 2]))
    x = torch.ones(3)
    assert all(t is x for t in mesh.replicate(x))
