"""The port's MoE block and MLA attention against the JAX package's, one
layer at a time, on granite-moe-3b and deepseek-v3 reduced (4 experts,
top-2; granite's banks padded to 6 rows, deepseek's shared expert and
MLA ranks 64 / 96 / 16 / 32 / 32), with the JAX weights carried across.

moe_block: FP16 and FP8 bank reads and an exception bank; a wide,
skewed chunk whose capacity drops choices (the same ones on both
sides); padded bank rows never read; the aux losses; a forced tie in the
router broken toward the lower expert, as `jax.lax.top_k` breaks it.
Outputs are held at the positions whose routing agreed (`routing_flips`:
a flip must sit at a near-tie of the reference's router logits).
mla_attention: the prefill, decode and paged phases, the paged one over
a chunk and a decode step whose rows share a block (COW)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           routing_flips, serving_pair)
from repro.models import mla as JMLA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.core.nestedfp import NestedTensor  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {"fp16": 3e-3, "fp8": 0.25}          # ROADMAP (F-port-1)
ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")


def _plant_bank(params):
    """One element of layer 0's w_up bank set to 2.0: the JAX package
    nests the stacked (L, E, D, F) bank as one tensor, so w_up stays f16
    in every layer (an exception bank, whole-tensor rule) while w_gate
    and w_down are nested."""
    w = params["layers"]["moe"]["w_up"]
    params["layers"]["moe"]["w_up"] = w.at[0, 1, 2, 3].set(2.0)
    return params


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = configs(arch)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, False, plant=_plant_bank)
    return jcfg, tcfg, jsp, tsp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _layer(jsp, tsp, i):
    return jax.tree.map(lambda a: a[i], jsp["layers"]), tsp["layers"][i]


def _rts(mode):
    return (JRuntime(mode=mode, backend="ref", dtype=jnp.float32),
            TRuntime(mode=mode, dtype=torch.float32))


def _jax_keep(logits, cfg, s):
    """The reference's kept choices (G, S, K), recomputed from its router
    logits with its own top_k and cumsum."""
    m = cfg.moe
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    g = idx.shape[0]
    cap = max(int(m.top_k * s * m.capacity_factor / m.n_experts), m.top_k)
    flat = idx.reshape(g, -1)
    onehot = jax.nn.one_hot(flat, m.n_experts, dtype=jnp.int32)
    slot = jnp.max(jnp.cumsum(onehot, axis=1) * onehot - 1, axis=-1)
    return np.asarray(slot < cap).reshape(idx.shape), np.asarray(idx)


def _run(pair, layer, mode, x):
    jcfg, tcfg, jsp, tsp = pair
    jp, tp = _layer(jsp, tsp, layer)
    jrt, trt = _rts(mode)
    want, jaux = JMOE.moe_block(jrt, jp["moe"], jcfg, jnp.asarray(x))
    got, taux = TMOE.moe_block(trt, tp["moe"], tcfg, torch.from_numpy(x),
                               with_aux=True)
    jlog = np.asarray(JMOE.apply_linear(jrt, jp["moe"]["router"],
                                        jnp.asarray(x)), np.float32)
    return np.asarray(want), jaux, got.numpy(), taux, jlog


def _check(pair, got, want, taux, jlog, mode):
    k = pair[1].moe.top_k
    r = routing_flips([taux["router_logits"].numpy()], [jlog], k)
    assert r["near_tie"], r
    err = np.abs(got - want)[r["agree"]]
    assert err.max() <= TOL[mode], err.max()
    return r


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("layer", [0, 1])
def test_moe_block_matches_jax(pair, mode, layer):
    """w_up is an exception bank (f16 in both modes), w_gate and w_down
    nested (FP8 mode reads their upper bytes dequantized)."""
    _, tcfg, _, tsp = pair
    moe = tsp["layers"][layer]["moe"]
    assert moe["w_up"].is_exception
    assert not moe["w_gate"].is_exception and not moe["w_down"].is_exception
    x = np.random.default_rng(layer).standard_normal(
        (3, 12, tcfg.d_model)).astype(np.float32)
    want, jaux, got, taux, jlog = _run(pair, layer, mode, x)
    r = _check(pair, got, want, taux, jlog, mode)
    assert r["flips"] == 0
    np.testing.assert_array_equal(taux["expert_idx"].numpy(),
                                  _jax_keep(jlog, tcfg, 12)[1])
    for key in ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-5, atol=1e-7)


def test_capacity_drops_the_same_choices(pair):
    """64 near-identical tokens in one row all pick the same experts: cap
    = int(2 * 64 * 1.25 / 4) = 40 slots an expert, so choices drop; the
    port keeps exactly the reference's choices, and rows stay groups (the
    second row, routed on its own, drops nothing)."""
    jcfg, tcfg, _, _ = pair
    rng = np.random.default_rng(5)
    base = rng.standard_normal(tcfg.d_model).astype(np.float32)
    skew = base + 0.01 * rng.standard_normal((64, tcfg.d_model))
    spread = rng.standard_normal((64, tcfg.d_model))
    x = np.stack([skew, spread]).astype(np.float32)
    want, jaux, got, taux, jlog = _run(pair, 1, "fp16", x)
    _check(pair, got, want, taux, jlog, "fp16")
    keep, _ = _jax_keep(jlog, tcfg, 64)
    np.testing.assert_array_equal(taux["keep"].numpy(), keep)
    assert not keep[0].all() and keep[1].all()
    assert float(taux["moe_drop_fraction"]) > 0
    np.testing.assert_allclose(float(taux["moe_drop_fraction"]),
                               float(jaux["moe_drop_fraction"]), rtol=1e-6)
    # a dropped choice adds nothing: a token whose every choice dropped
    # gets only the shared expert (deepseek) or exactly zero (granite)
    alone = TMOE.moe_block(_rts("fp16")[1], pair[3]["layers"][1]["moe"],
                           tcfg, torch.from_numpy(x[1:]))
    np.testing.assert_array_equal(alone.numpy(), got[1:])


@pytest.mark.parametrize("pair", ["granite-moe-3b-a800m"], indirect=True)
def test_padded_bank_rows_are_never_read(pair):
    """Granite's banks hold 6 rows for 4 experts: garbage in rows 4-5
    changes nothing, bitwise."""
    _, tcfg, _, tsp = pair
    m = tcfg.moe
    moe = tsp["layers"][1]["moe"]
    assert moe["w_gate"].shape[0] == m.n_experts_padded == 6
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    rt = TRuntime(mode="fp16", dtype=torch.float32)
    before = TMOE.moe_block(rt, moe, tcfg, x)
    junk = dict(moe)
    for name in ("w_gate", "w_up", "w_down"):
        b = moe[name]
        if b.is_exception:
            raw = b.raw.clone()
            raw[m.n_experts:] = float("nan")
            junk[name] = NestedTensor(None, None, raw)
            continue
        up, lo = b.upper.clone(), b.lower.clone()
        up[m.n_experts:] = 0x7F          # NaN pattern in the padded rows
        lo[m.n_experts:] = 0xFF
        junk[name] = NestedTensor(up, lo, None)
    after = TMOE.moe_block(rt, junk, tcfg, x)
    assert torch.equal(before, after)


def test_router_ties_go_to_the_lower_expert(pair):
    """Experts 1, 2 and 3 get identical router columns and expert 0 the
    negated one, so every token ties three ways: top-2 must take the
    lower indices, as jax.lax.top_k does."""
    jcfg, tcfg, jsp, tsp = pair
    jp, tp = _layer(jsp, tsp, 1)
    w = np.asarray(jp["moe"]["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    w[:, 3] = w[:, 1]
    w[:, 0] = -w[:, 1]
    jp["moe"]["router"] = {"w": jnp.asarray(w)}
    tmoe = dict(tp["moe"], router={"w": torch.from_numpy(w)})
    x = np.random.default_rng(4).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32)
    jrt, trt = _rts("fp16")
    want, _ = JMOE.moe_block(jrt, jp["moe"], jcfg, jnp.asarray(x))
    got, aux = TMOE.moe_block(trt, tmoe, tcfg, torch.from_numpy(x),
                              with_aux=True)
    lg = aux["router_logits"].numpy()
    assert (lg[..., 1] == lg[..., 2]).all() and (lg[..., 2] == lg[..., 3]).all()
    idx = aux["expert_idx"].numpy()
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(lg), -1), 2)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    pos = lg[..., 1] > lg[..., 0]
    assert (idx[pos] == [1, 2]).all() and (idx[~pos] == [0, 1]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["fp16"])


# ---------------------------------------------------------------------------
# MLA attention, deepseek-v3 reduced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    jcfg, tcfg, jsp, tsp = _pair("deepseek-v3-671b")
    jp, tp = _layer(jsp, tsp, 1)
    return jcfg, tcfg, jp["attn"], tp["attn"]


def _close(got, want, tol):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_mla_prefill_and_decode_phases(ds, mode):
    jcfg, tcfg, jp, tp = ds
    jrt, trt = _rts(mode)
    b, s, cap = 2, 9, 12
    x = np.random.default_rng(1).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    pos = np.arange(s)[None, :]
    want, jlat = JMLA.mla_attention(jrt, jp, jcfg, jnp.asarray(x),
                                    phase="prefill",
                                    positions=jnp.asarray(pos))
    got, tlat = TMLA.mla_attention(trt, tp, tcfg, torch.from_numpy(x),
                                   phase="prefill",
                                   positions=torch.from_numpy(pos))
    _close(got, want, TOL[mode])
    for name in ("c_kv", "k_rope"):
        _close(tlat[name], jlat[name], 1e-5)
    # decode: the latents (as f16) in caches of capacity 12, two steps
    jc = {n: jnp.zeros((b, cap) + jlat[n].shape[2:], jnp.float16)
          .at[:, :s].set(jlat[n].astype(jnp.float16)) for n in jlat}
    tc = {n: torch.from_numpy(np.array(jc[n])) for n in jc}
    for i in range(2):
        xd = np.random.default_rng(10 + i).standard_normal(
            (b, 1, tcfg.d_model)).astype(np.float32)
        lens = np.full((b,), s + 1 + i, np.int32)
        want, jc = JMLA.mla_attention(
            jrt, jp, jcfg, jnp.asarray(xd), phase="decode",
            positions=jnp.asarray(lens - 1)[:, None], cache=jc,
            kv_len=jnp.asarray(lens))
        got, _ = TMLA.mla_attention(
            trt, tp, tcfg, torch.from_numpy(xd), phase="decode",
            positions=torch.from_numpy(lens - 1)[:, None].long(), cache=tc,
            kv_len=torch.from_numpy(lens))
        _close(got, want, TOL[mode])
        for n in jc:
            _close(tc[n], jc[n], 2e-3)


def _paged_indices(tables, q_offset, kv_len, c, bs):
    """phys_write (B, C), phys_read (B, MB*BS) as `paged_step` builds them."""
    tables = np.asarray(tables)
    b, mb = tables.shape
    pos = q_offset[:, None] + np.arange(c)[None, :]
    real = pos < kv_len[:, None]
    blk = np.take_along_axis(tables, np.clip(pos // bs, 0, mb - 1), axis=1)
    write = np.where(real, blk * bs + pos % bs, np.arange(c)[None, :] % bs)
    read = (tables[..., None] * bs + np.arange(bs)).reshape(b, mb * bs)
    return write.astype(np.int32), read.astype(np.int32)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_mla_paged_chunk_then_decode_over_shared_blocks(ds, mode):
    """Row 0 prefills 8 tokens into blocks [1, 2]; row 1 shares block 1
    (its first 4 tokens, COW) and prefills tokens 4-6 into block 3 as a
    chunk; then both rows decode one token. Outputs and the latent pool
    against the reference's."""
    jcfg, tcfg, jp, tp = ds
    jrt, trt = _rts(mode)
    m = tcfg.mla
    bs, nb = 4, 6
    pool = {"c_kv": (nb, bs, m.kv_lora_rank), "k_rope": (nb, bs, m.qk_rope_dim)}
    jpool = {n: jnp.zeros(shp, jnp.float16) for n, shp in pool.items()}
    tpool = {n: torch.zeros(shp, dtype=torch.float16) for n, shp in pool.items()}
    rng = np.random.default_rng(3)
    steps = [  # (tables, q_offset, kv_len, chunk width)
        (np.array([[1, 2], [0, 0]]), np.array([0, 0]), np.array([8, 0]), 8),
        (np.array([[1, 2], [1, 3]]), np.array([8, 4]), np.array([8, 7]), 3),
        (np.array([[1, 2], [1, 3]]), np.array([8, 7]), np.array([9, 8]), 1),
    ]
    for tables, qoff, klen, c in steps:
        x = rng.standard_normal((2, c, tcfg.d_model)).astype(np.float32)
        write, read = _paged_indices(tables, qoff, klen, c, bs)
        pos = qoff[:, None] + np.arange(c)[None, :]
        want, jpool = JMLA.mla_attention(
            jrt, jp, jcfg, jnp.asarray(x), phase="paged",
            positions=jnp.asarray(pos), cache=jpool,
            kv_len=jnp.asarray(klen, jnp.int32),
            paged=(jnp.asarray(write), jnp.asarray(read),
                   jnp.asarray(qoff, jnp.int32)))
        got, _ = TMLA.mla_attention(
            trt, tp, tcfg, torch.from_numpy(x), phase="paged",
            positions=torch.from_numpy(pos), cache=tpool,
            kv_len=torch.from_numpy(klen.astype(np.int32)),
            paged=(torch.from_numpy(write).long(),
                   torch.from_numpy(read).long(),
                   torch.from_numpy(qoff), torch.from_numpy(tables)))
        live = klen > 0
        _close(got.numpy()[live], np.asarray(want)[live], TOL[mode])
        for n in pool:       # blocks 1-3 hold the rows' latents
            _close(tpool[n][1:4], np.asarray(jpool[n])[1:4], 2e-3)
