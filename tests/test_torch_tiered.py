"""The tiered KV cache in the PyTorch port against the JAX package, case for
case with tests/test_tiered_kv.py: spill to the host tier, restore under
the SLO guard, lazy lo planes on planar pools, the host pool's cap, and
the prefix store kept across engine restarts. Each engine case runs the
JAX engine and the port's on the same weights and request sets; tokens
and engine counters (`stats`, `tiered_stats()`, `prefix_cache_stats()`)
are compared for equality. Also: a store either package saves loads into
the other's engine, and a flipped byte in a host entry is caught by its
checksum on both sides."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           serving_pair, settled_jax_tables)
from repro.core.policy import RestorePolicy as JRestore  # noqa: E402
from repro.core.policy import SLOConfig as JSLO  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.core.policy import RestorePolicy as TRestore  # noqa: E402
from repro_torch.core.policy import SLOConfig as TSLO  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread", "settled_jax_tables")
FP16_TOL = 3e-3           # tests/test_torch_model.py (F-port-1)


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


def _mk(pair, side, **kw):
    """test_tiered_kv.py's engine: 2 slots, 11 blocks of 16 tokens."""
    jcfg, tcfg, jsp, tsp = pair
    kw = dict(dict(n_slots=2, capacity=128, forced_mode="fp16",
                   block_size=16, n_blocks=11, chunk_tokens=64,
                   debug_invariants=True), **kw)
    if side == "jax":
        if "restore_policy" in kw:
            kw["restore_policy"] = JRestore(**vars(kw["restore_policy"]))
        return JEngine(jcfg, jsp, **kw)
    return TEngine(tcfg, tsp, device="cpu", **kw)


def _sys_prompts(vocab):
    rng = np.random.default_rng(0)
    return (rng.integers(1, vocab, size=96).tolist(),
            rng.integers(1, vocab, size=96).tolist())


def _burst(side, vocab, sysp, tag, n=3, max_new=6):
    R = JRequest if side == "jax" else TRequest
    return [R(f"{tag}{i}", sysp + np.random.default_rng(7 * i + 1)
              .integers(1, vocab, size=8).tolist(), max_new)
            for i in range(n)]


def _serve(e, side, vocab, phases, hook=None):
    """phases: [(tag, sys_prompt, mode or None)]: each burst served to
    the end, forced_mode switched first when given. hook(e, tag, when)
    runs before the burst is submitted (when="before") and after its
    first step (when="step")."""
    for tag, sysp, mode in phases:
        if mode is not None:
            e.forced_mode = mode
        if hook is not None:
            hook(e, tag, "before")
        for r in _burst(side, vocab, sysp, tag):
            e.submit(r)
        if hook is not None:
            e.step()
            hook(e, tag, "step")
        e.run(max_iters=800)
    return {r.request_id: tuple(r.output) for r in e.finished}


def _pair(pair, phases, hook=None, **kw):
    vocab = pair[0].vocab_size
    out = {}
    for side in ("jax", "torch"):
        e = _mk(pair, side, **kw)
        out[side] = (e, _serve(e, side, vocab, phases, hook))
    (je, jo), (te, to) = out["jax"], out["torch"]
    assert to == jo
    shared = set(te.stats) & set(je.stats)
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    assert te.tiered_stats() == je.tiered_stats()
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    assert te.blocks.host.stats == je.blocks.host.stats
    return je, te, to


def _abc(pair):
    s1, s2 = _sys_prompts(pair[0].vocab_size)
    return [("a", s1, None), ("b", s2, None), ("c", s1, None)]


def _port_off(pair, phases):
    e = _mk(pair, "torch", host_offload=False)
    return e, _serve(e, "torch", pair[0].vocab_size, phases)


# ---------------------------------------------------------------------------
# spill / restore through the engines
# ---------------------------------------------------------------------------

def test_fp16_host_on_off(qwen):
    """An 11-block pool spills sys1's blocks when sys2 arrives, and the
    third burst restores them; the tokens equal the host-off engine's,
    which recomputes."""
    je, te, outs = _pair(qwen, _abc(qwen))
    ts = te.tiered_stats()
    assert ts["spilled_blocks"] > 0 and ts["restored_blocks"] > 0, ts
    assert ts["host_hit_blocks"] > 0
    # flat pools restore every plane at once
    assert ts["restored_bytes"] == ts["restored_blocks"] \
        * te._eager_block_bytes[0]
    e_off, outs_off = _port_off(qwen, _abc(qwen))
    assert outs_off == outs
    assert e_off.stats["spilled_blocks"] == 0
    assert e_off.tiered_stats()["enabled"] is False


def test_preempt_spill_restore_matches_ample_pool(qwen):
    """More work than the pool holds keeps preempting the youngest row;
    its released prefix blocks spill and come back on re-admission. The
    ample pool (nothing evicted) is the ground truth."""
    s1, _ = _sys_prompts(qwen[0].vocab_size)
    vocab = qwen[0].vocab_size
    outs, engines = {}, {}
    for side, n_blocks in (("jax", 11), ("torch", 11), ("ample", 64)):
        s = "torch" if side == "ample" else side
        e = _mk(qwen, s, n_blocks=n_blocks, capacity=192)
        for r in _burst(s, vocab, s1, "p", n=5, max_new=24):
            e.submit(r)
        e.run(max_iters=2000)
        outs[side] = {r.request_id: tuple(r.output) for r in e.finished}
        engines[side] = e
    assert outs["torch"] == outs["jax"] == outs["ample"]
    je, te = engines["jax"], engines["torch"]
    assert te.stats["preemptions"] > 0
    assert {k: te.stats[k] for k in je.stats} == je.stats
    assert te.tiered_stats() == je.tiered_stats()


def test_planar_lazy_lo_fp8_to_fp16(qwen):
    """Planar pools: FP8 serving restores the hi planes only, and the
    first FP16 step lands the lo planes of every block restored so."""
    s1, s2 = _sys_prompts(qwen[0].vocab_size)
    phases = [("a", s1, "fp8"), ("b", s2, None), ("c", s1, None),
              ("d", s2, "fp16")]
    je, te, outs = _pair(qwen, phases, kv_planar=True, forced_mode="fp8")
    ts = te.tiered_stats()
    assert ts["restored_blocks"] > 0 and ts["lo_lazy_blocks"] > 0, ts
    per_block_hi = ts["restored_bytes"] // ts["restored_blocks"]
    assert per_block_hi == te._eager_block_bytes[0]
    assert ts["lo_lazy_bytes"] == ts["lo_lazy_blocks"] * per_block_hi
    ample = _mk(qwen, "torch", kv_planar=True, forced_mode="fp8",
                n_blocks=64)
    assert _serve(ample, "torch", qwen[0].vocab_size, phases) == outs


def test_slo_guard_falls_back_to_recompute(qwen):
    """max_queue_bytes=0 turns host matching off: each would-be host hit
    counts as a fallback and recomputes; the tier still fills."""
    je, te, outs = _pair(qwen, _abc(qwen),
                         restore_policy=TRestore(max_queue_bytes=0))
    ts = te.tiered_stats()
    assert ts["restored_blocks"] == 0 and ts["restore_fallbacks"] > 0, ts
    assert ts["spilled_blocks"] > 0
    assert _port_off(qwen, _abc(qwen))[1] == outs


def test_tiny_grant_spreads_restores(qwen):
    """A one-byte grant leaves the one-block floor: restores spread over
    steps, gated rows still progress, and the tokens are unchanged."""
    je, te, outs = _pair(qwen, _abc(qwen), restore_policy=TRestore(
        max_restore_bytes_per_step=1))
    assert te.stats["restored_blocks"] > 0
    assert _port_off(qwen, _abc(qwen))[1] == outs


def test_host_pool_cap_drops_oldest(qwen):
    """A one-block host budget keeps dropping entries (oldest first,
    pinned ones skipped); misses recompute."""
    cap = _mk(qwen, "torch")._eager_block_bytes[0]
    je, te, outs = _pair(qwen, _abc(qwen), host_bytes=cap)
    assert te.blocks.host.bytes <= cap
    assert te.blocks.host.stats["dropped_blocks"] > 0
    assert _port_off(qwen, _abc(qwen))[1] == outs


def test_spill_captures_settle_within_their_step(qwen):
    """A flush right before a step's launch only enqueues its captures;
    they are stored after the launch (overlapping the step on a card),
    and none is left in flight when the step returns."""
    e = _mk(qwen, "torch")
    in_flight, run, step = [], e.graphs.run, e.step

    def recorded_run(key):
        in_flight.append(len(e._captures))
        return run(key)

    def checked_step():
        step()
        assert not e._captures
    e.graphs.run, e.step = recorded_run, checked_step
    out = _serve(e, "torch", qwen[0].vocab_size, _abc(qwen))
    assert max(in_flight) > 0 and e.stats["spilled_blocks"] > 0
    assert out == _port_off(qwen, _abc(qwen))[1]


def test_threaded_checksums_are_the_jax_digests():
    """`HostPool.checksums` (worker threads) gives each entry the JAX
    package's blake2b digest, strided planes included."""
    from repro.serving.kvcache import HostPool as JHost
    from repro_torch.serving.kvcache import HostPool as THost
    rng = np.random.default_rng(3)
    entries = [{"k_hi": rng.integers(0, 256, (2, 16, 4, 64), np.uint8),
                "v": rng.standard_normal((2, 16, 8, 64))
                .astype(np.float16)[:, :, ::2]} for _ in range(5)]
    want = [JHost.checksum(e) for e in entries]
    assert THost.checksums(entries) == want
    assert THost.checksums(entries[:1]) == want[:1]
    assert [THost.checksum(e) for e in entries] == want


def _owners(host):
    """{id: bytes} of the host buffers the tier's entries view."""
    return {id(o): o.nbytes
            for planes in host.entries.values() for a in planes.values()
            for o in [a if a.base is None else a.base]}


def test_dropped_host_entries_free_their_memory(qwen):
    """Each spilled entry owns exactly its bytes: the storages the live
    entries view add up to `host.bytes` (no staging rows or dropped
    neighbours kept alive), and an entry the cap drops leaves nothing
    referenced, so its memory goes with it."""
    import gc
    import weakref
    cap = _mk(qwen, "torch")._eager_block_bytes[0]
    e = _mk(qwen, "torch", host_bytes=2 * cap)
    host, refs = e.blocks.host, []
    put = host.put

    def recorded(key, planes, **kw):
        refs.append([weakref.ref(a.base) for a in planes.values()])
        put(key, planes, **kw)
    host.put = recorded
    _serve(e, "torch", qwen[0].vocab_size, _abc(qwen))
    del host.put
    gc.collect()
    assert host.stats["dropped_blocks"] > 0 and len(host) > 0
    assert sum(_owners(host).values()) == host.bytes
    alive = [rs for rs in refs if any(r() is not None for r in rs)]
    assert len(alive) == len(host)
    assert all(r() is not None for rs in alive for r in rs)


@pytest.mark.parametrize("slo,kw", [
    (dict(tpot_ms=10.0), dict(h2d_gbps=10.0, frac=0.5, queue_steps=4)),
    ({}, {}),
    (dict(tpot_ms=50.0, headroom=0.8), dict(h2d_gbps=25.0)),
])
def test_restore_policy_from_slo_matches_jax(slo, kw):
    t = TRestore.from_slo(TSLO(**slo), **kw)
    j = JRestore.from_slo(JSLO(**slo), **kw)
    assert vars(t) == vars(j)
    assert vars(t.scaled(0.5)) == vars(j.scaled(0.5))
    if slo == dict(tpot_ms=10.0):
        assert t.max_restore_bytes_per_step == int(0.010 * 0.9 * 0.5 * 10e9)
        assert t.max_queue_bytes == t.max_restore_bytes_per_step * 4
    assert t.admit(0) and not t.admit(t.max_queue_bytes)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

def _flip(e, key, plane):
    a = e.blocks.host.entries[key][plane]
    a.reshape(-1).view(np.uint8)[5] ^= 0x10


# (burst, hook stage, entry to corrupt): before the third burst's
# admission matches it; after its first step queued its restore; before
# the FP16 burst lands the deferred lo planes of a planar restore
CORRUPT = {
    "at-match": ("c", "before", lambda bm: next(iter(bm.host.entries))),
    "queued-restore": ("c", "step", lambda bm: bm.restore_jobs[0][::2]),
    "lazy-lo": ("d", "before",
                lambda bm: next((g, h) for (g, _b), h
                                in bm._lo_pending.items())),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_checksum_catches_corruption(qwen, case):
    """One byte of the same host entry flipped in both engines: both count
    the corrupt block, recompute, and emit equal tokens (also equal to
    the host-off engine's in FP16)."""
    tag, stage, pick = CORRUPT[case]
    phases, kw = _abc(qwen), {}
    if case == "lazy-lo":
        _, s2 = _sys_prompts(qwen[0].vocab_size)
        phases = [(t, p, "fp8" if t == "a" else None) for t, p, _ in phases]
        phases.append(("d", s2, "fp16"))
        kw = dict(kv_planar=True, forced_mode="fp8")
    hit = []

    def hook(e, t, when):
        if (t, when) == (tag, stage):
            key = pick(e.blocks)
            planes = e.blocks.host.entries[key]
            name = "k_lo" if case == "lazy-lo" else "k"
            bad = planes[name].copy()       # JAX's entries are read-only
            bad.reshape(-1).view(np.uint8)[5] ^= 0x10
            planes[name] = bad
            hit.append(key)

    je, te, outs = _pair(qwen, phases, hook, **kw)
    assert len(hit) == 2 and hit[0] == hit[1]
    assert te.blocks.host.stats["corrupt_blocks"] == 1
    assert te.stats["corrupt_fallbacks"] == (case != "at-match")
    if case != "lazy-lo":
        assert _port_off(qwen, phases)[1] == outs


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

_PERSIST_SNIPPET = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, "tests")
    from repro_torch.configs import ARCHS
    from repro_torch.models.convert import from_jax_serving
    from repro_torch.serving.engine import Engine, Request

    persist_dir, weights = sys.argv[1], sys.argv[2]
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    with np.load(weights) as f:
        sp = from_jax_serving(dict(f), cfg.n_layers, device="cpu")
    e = Engine(cfg, sp, n_slots=2, capacity=128, forced_mode="fp16",
               block_size=16, n_blocks=24, chunk_tokens=64,
               debug_invariants=True, persist_dir=persist_dir,
               device="cpu")
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, cfg.vocab_size, size=96).tolist()
    for i in range(3):
        tail = np.random.default_rng(7 * i + 1).integers(
            1, cfg.vocab_size, size=8).tolist()
        e.submit(Request(f"r{i}", sysp + tail, 6))
    e.run(max_iters=800)
    print(json.dumps({
        "outputs": {r.request_id: r.output for r in e.finished},
        "host_hit_blocks": e.blocks.prefix_stats["host_hit_blocks"],
        "hit_tokens": e.blocks.prefix_stats["hit_tokens"],
        "restored_blocks": e.stats["restored_blocks"]}))
""")


def _persist_burst(pair, side, path, save):
    e = _mk(pair, side, n_blocks=24, persist_dir=str(path))
    s1, _ = _sys_prompts(pair[0].vocab_size)
    outs = _serve(e, side, pair[0].vocab_size, [("r", s1, None)])
    if save:
        assert e.save_prefix_store() > 0
    return e, {k: list(v) for k, v in outs.items()}


def test_prefix_hits_survive_restart(qwen, tmp_path):
    """The port saves its prefix store; a port engine in another process
    (another hash seed) loads it, restores the system prompt from the
    host tier and emits the same tokens, which are also the JAX
    engine's."""
    from _torch_parity import flatten_serving
    weights = tmp_path / "w.npz"
    np.savez(weights, **flatten_serving(qwen[2]))
    store = tmp_path / "store"
    e1, first = _persist_burst(qwen, "torch", store, save=True)
    assert (store / "prefix_store.npz").exists()
    assert e1.blocks.prefix_stats["host_hit_blocks"] == 0
    env = dict(os.environ, PYTHONHASHSEED="31337",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _PERSIST_SNIPPET, str(store),
                        str(weights)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    second = json.loads(r.stdout.splitlines()[-1])
    assert second["host_hit_blocks"] > 0 and second["restored_blocks"] > 0
    assert second["hit_tokens"] >= e1.blocks.prefix_stats["hit_tokens"]
    assert second["outputs"] == first
    _, jfirst = _persist_burst(qwen, "jax", tmp_path / "jstore", save=False)
    assert jfirst == first


def test_meta_mismatch_ignores_store(qwen, tmp_path):
    """A store saved under one layout never joins another: a changed
    fingerprint loads nothing."""
    e, _ = _persist_burst(qwen, "torch", tmp_path, save=True)
    meta = json.loads((tmp_path / "prefix_store.json").read_text())
    meta["block_size"] = 8
    (tmp_path / "prefix_store.json").write_text(json.dumps(meta))
    e2 = _mk(qwen, "torch", n_blocks=24, persist_dir=str(tmp_path))
    assert len(e2.blocks.host) == 0
    assert e2._load_prefix_store(str(tmp_path)) == 0


@pytest.mark.parametrize("planar", [False, True])
def test_store_crosses_frameworks(qwen, tmp_path, planar):
    """Each package saves the store of one burst: the same json bytes,
    the same npz keys, shapes and dtypes, and bytes that differ only by
    F-port-1 (the second layer's keys and values carry the first layer's
    ~1e-3 difference). Each store then loads into both packages' engines:
    host-tier hits, equal counters, and the first run's tokens."""
    kw = dict(kv_planar=planar)
    saved, first = {}, {}
    for side in ("jax", "torch"):
        path = tmp_path / side
        e = _mk(qwen, side, n_blocks=24, persist_dir=str(path), **kw)
        s1, _ = _sys_prompts(qwen[0].vocab_size)
        first[side] = _serve(e, side, qwen[0].vocab_size, [("r", s1, None)])
        assert e.save_prefix_store() > 0
        saved[side] = path
    assert first["jax"] == first["torch"]
    jm, tm = ((saved[s] / "prefix_store.json").read_bytes()
              for s in ("jax", "torch"))
    assert jm == tm
    with np.load(saved["jax"] / "prefix_store.npz") as jf, \
            np.load(saved["torch"] / "prefix_store.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files) and jf.files
        for k in jf.files:
            a, b = jf[k], tf[k]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype == np.float16:
                np.testing.assert_allclose(b.astype(np.float32),
                                           a.astype(np.float32),
                                           atol=FP16_TOL, rtol=0)
            elif k.endswith("_hi"):
                # FP16 serving rounds to the same e5m2 byte except where
                # F-port-1 moves a value across a step
                assert (a != b).mean() < 0.05, k
    for src in ("jax", "torch"):
        engines, outs = {}, {}
        for side in ("jax", "torch"):
            e = _mk(qwen, side, n_blocks=24, persist_dir=str(saved[src]),
                    **kw)
            s1, _ = _sys_prompts(qwen[0].vocab_size)
            outs[side] = _serve(e, side, qwen[0].vocab_size,
                                [("r", s1, None)])
            engines[side] = e
        je, te = engines["jax"], engines["torch"]
        assert outs["torch"] == outs["jax"] == first["jax"], src
        assert te.blocks.prefix_stats["host_hit_blocks"] > 0
        assert te.tiered_stats() == je.tiered_stats()
        assert te.prefix_cache_stats() == je.prefix_cache_stats()
