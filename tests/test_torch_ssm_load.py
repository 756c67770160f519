"""Loading and the dense-slot steps of the recurrent families in the port:
mamba2-2.7b (ssm) and zamba2-2.7b (hybrid) against the JAX package.

The configs equal the JAX package's field for field (SSMConfig included,
`reduced()` too); the streamed serving build is bitwise
`to_serving(init_params(...))`, the Mamba2 linears nested and the conv
weights, `dt_bias`, `A_log`, `D` and the norm left f32, with zamba2's
`shared_attn` block last; `from_jax_serving` carries both trees bitwise;
checkpoints in the JAX package's format cross both ways; the structural
reckoning of the full configs equals the JAX package's; the serve CLI
takes both archs and refuses --speculate for them. The dense-slot steps
(`launch/steps.py`, serve_rt: bf16) serve mamba2 and give the JAX
steps' logits within BF16_TOL, their decode step costs the same state
at any cache length, and they serve zamba2 too (its shared attention's
head dim 80 has K5 / K6 instances; tests/test_torch_hybrid_dense.py
holds it to the JAX package); prefill + decode equals a longer prefill,
the counterpart of test_arch_smoke.py's consistency test."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import flatten_serving, one_torch_thread  # noqa: E402,F401
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.convert import to_serving as j_to_serving  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.core.linear import NestedLinearParams  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (from_jax_serving,  # noqa: E402
                                        serving_memory_bytes, to_serving)
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from test_torch_moe_load import _assert_trees_equal, _fields, _flat  # noqa: E402
from test_torch_ssm import ARCHS, ssm_pair  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_TOL = {"fp16": 0.1, "fp8": 0.5}              # tests/test_torch_steps.py
_F32_LEAVES = ("conv_wx", "conv_bx", "conv_wbc", "conv_bbc", "dt_bias",
               "A_log", "D", "norm")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(arch, reduced):
    t, j = TARCHS[arch], JARCHS[arch]
    if reduced:
        t, j = t.reduced(), j.reduced()
    tf, jf = _fields(t), _fields(j)
    assert tf == {k: jf[k] for k in tf}        # the port's fields only
    assert t.cache_kind == j.cache_kind == t.family
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.is_sub_quadratic and j.is_sub_quadratic


def test_registry_serves_the_recurrent_families():
    assert TARCHS["mamba2-2.7b"].family == "ssm"
    assert TARCHS["zamba2-2.7b"].family == "hybrid"
    assert TARCHS["zamba2-2.7b"].resolved_head_dim == 80
    assert TARCHS["mamba2-2.7b"].resolved_head_dim == 0
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-large-v2"):
        cfg = TARCHS[arch].reduced()           # built, no family refused
        assert TM.init_params(cfg, device="meta")["frontend_proj"]


def _plant(i, path, w):
    if (i, path) in ((1, "mamba/out_proj/w"), ("shared_attn", "attn/wo/w")):
        w[0, 0] = 2.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plant", [False, True])
def test_streamed_build_is_bitwise_to_serving_of_init_params(arch, plant):
    """The five Mamba2 linears nested as drawn (plant: layer 1's out_proj
    and the shared block's wo exception tensors), everything else of the
    block f32, zamba2's shared block after the layers."""
    cfg = dataclasses.replace(TARCHS[arch].reduced(), n_layers=4)
    params = TM.init_params(cfg, seed=4, device="cpu")
    if plant:
        _plant(1, "mamba/out_proj/w",
               params["layers"][1]["mamba"]["out_proj"]["w"])
        if "shared_attn" in params:
            _plant("shared_attn", "attn/wo/w",
                   params["shared_attn"]["attn"]["wo"]["w"])
    want = to_serving(params)
    got = TM.init_serving_params(cfg, seed=4, device="cpu",
                                 plant=_plant if plant else None)
    _assert_trees_equal(got, want)
    m = got["layers"][1]["mamba"]
    for name in ("in_z", "in_x", "in_bc", "in_dt", "out_proj"):
        assert isinstance(m[name], NestedLinearParams), name
    assert m["out_proj"].weight.is_exception == plant
    assert not m["in_x"].weight.is_exception
    for name in _F32_LEAVES:
        assert m[name].dtype == torch.float32, name
    assert ("shared_attn" in got) == (cfg.family == "hybrid")
    if cfg.family == "hybrid":
        assert got["shared_attn"]["attn"]["wo"].weight.is_exception == plant


@pytest.mark.parametrize("arch", ARCHS)
def test_structural_reckoning_equals_jax(arch):
    """Nested bytes of the full config on meta tensors, against the JAX
    package's structural tree (mamba2: 2.57 G nested weights; zamba2:
    2.15 G Mamba weights and the 0.105 G shared block)."""
    cfg = TARCHS[arch]
    meta = to_serving(TM.init_params(cfg, device="meta"), structural=True)
    mem = serving_memory_bytes(meta)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   JARCHS[arch]))
    jtree = j_to_serving(shapes, structural=True)
    jnested = sum(int(np.prod(x.shape)) for x in
                  jax.tree_util.tree_leaves(jtree) if x.dtype == jnp.uint8)
    assert mem["nested_bytes"] == jnested
    per_layer = sum(_flat(meta["layers"][0])[f"mamba/{n}/weight/upper"]
                    .numel() for n in ("in_z", "in_x", "in_bc", "in_dt",
                                       "out_proj"))
    shared = sum(t.numel() for k, t in _flat(meta.get("shared_attn", {}))
                 .items() if k.endswith("/upper"))
    assert mem["nested_bytes"] == 2 * (cfg.n_layers * per_layer + shared)
    if arch == "mamba2-2.7b":
        assert cfg.n_layers * per_layer == 2_571_632_640
    else:
        assert shared == 104_857_600


def test_from_jax_serving_carries_both_trees():
    """Every Mamba2 leaf of every layer (4 nested linears' 2 planes, the
    exception out_proj's f16 tensor, 8 f32 leaves), and zamba2's shared
    block, bitwise the JAX serving tree's."""
    for arch in ARCHS:
        jcfg, tcfg, jsp, tsp = ssm_pair(arch)
        flat = flatten_serving(jsp)
        for i, layer in enumerate(tsp["layers"]):
            got = _flat(layer["mamba"], "layers/mamba")
            want = {k: v for k, v in flat.items()
                    if k.startswith("layers/mamba/")}
            assert set(got) == set(want) and len(want) == 17
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k][i])
        if tcfg.family == "hybrid":
            got = _flat(tsp["shared_attn"], "shared_attn")
            want = {k: v for k, v in flat.items()
                    if k.startswith("shared_attn/")}
            assert set(got) == set(want) and len(want) > 10
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """A JAX checkpoint restores into the port nested as read, equal to
    the JAX serving tree's planes (and its f32 leaves); a port
    checkpoint restores under the JAX package."""
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jio.save(str(tmp_path / "j"), {"params": params}, step=5)
    got, step = tio.restore(str(tmp_path / "j"), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu",
        serving=True)
    assert step == 5
    want = from_jax_serving(flatten_serving(j_to_serving(params)),
                            tcfg.n_layers, device="cpu")
    _assert_trees_equal(got["params"], want, ordered=False)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    tio.save(str(tmp_path / "t"), {"params": tp})
    back, _ = jio.restore(str(tmp_path / "t"), {"params": params})
    b = back["params"]
    for i, layer in enumerate(tp["layers"]):
        for name in ("A_log", "conv_wx"):
            np.testing.assert_array_equal(
                np.asarray(b["layers"]["mamba"][name][i]),
                layer["mamba"][name].numpy())
        np.testing.assert_array_equal(
            np.asarray(b["layers"]["mamba"]["in_bc"]["w"][i]),
            layer["mamba"]["in_bc"]["w"].numpy())
    if tcfg.family == "hybrid":
        np.testing.assert_array_equal(
            np.asarray(b["shared_attn"]["mlp"]["down"]["w"]),
            tp["shared_attn"]["mlp"]["down"]["w"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_recurrent_archs(arch, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--system-prompt-len", "8", "--policy", "fp16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"finished": 3' in out and '"prefix_hit_rate": 0.0' in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--speculate"])
    assert "roll back" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the dense-slot steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_dense_slot_steps_match_jax(mode):
    """mamba2: make_prefill_step (S = 20; the capacity is moot for a
    state), then 4 staged decode steps, against the JAX steps; the state
    after the last step within the tolerance too."""
    jcfg, tcfg, jsp, tsp = ssm_pair("mamba2-2.7b")
    s = 20
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab_size, (3, s)).astype(np.int32)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=28)(
        jsp, {"tokens": jnp.asarray(toks)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=28)(
        tsp, {"tokens": torch.from_numpy(toks)})
    assert set(tc) == {"ssm"} and TM.planarize_cache(tc)["ssm"] is tc["ssm"]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_TOL[mode])
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    for i in range(4):
        want, jc = jd(jsp, jc, jnp.asarray(nxt), s + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), s + i)
        np.testing.assert_allclose(np.array(got, np.float32),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=BF16_TOL[mode])
        nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    for n, plane in tc["ssm"].items():
        np.testing.assert_allclose(plane.float().numpy(),
                                   np.asarray(jc["ssm"][n], np.float32),
                                   rtol=0, atol=BF16_TOL[mode])
    assert len(td.keys()) == 1


def test_staged_decode_is_o1_in_the_cache_length():
    """The staged step is bitwise `decode_step` on cloned state, its
    replay check compares the three state planes, and one key serves any
    cache length: the logits at cache_len 1056 and 32768 are bitwise the
    same (the state does not see the length)."""
    _, tcfg, _, tsp = ssm_pair("mamba2-2.7b")
    toks = torch.randint(1, tcfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    logits, caches = TS.make_prefill_step(tcfg, "fp16")(tsp, {"tokens": toks})
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    step = TS.make_decode_step(tcfg, "fp16")
    outs = []
    for cache_len in (1056, 32768):
        c = {"ssm": {n: p.clone() for n, p in caches["ssm"].items()}}
        clone = {"ssm": {n: p.clone() for n, p in caches["ssm"].items()}}
        want, _ = TM.decode_step(TS.serve_rt("fp16"), tsp, tcfg, nxt, clone,
                                 cache_len)
        got, _ = step(tsp, c, nxt, cache_len)
        assert torch.equal(got, want)
        outs.append(got.clone())
        same = step.check_replay(tsp, c, nxt, cache_len)
        assert same == {"logits": True, "conv_x": True, "conv_bc": True,
                        "ssm": True}
    assert torch.equal(outs[0], outs[1])
    assert len(step.keys()) == 2          # one per cache buffer set
    assert {k[1] for k in step.keys()} == {None}
    with pytest.raises(ValueError, match="cache_len -1"):
        step(tsp, caches, nxt, -1)


def test_dense_slot_refuses_zamba2():
    """The dense-slot steps serve zamba2 now (K5 and K6 have D = 80
    instances): at its head dim of 80 the reduced stack prefills its
    shared caches at capacity and decodes over them; what the steps
    still refuse is a head dim without an instance, on the card (the
    shape rule, before any launch)."""
    from repro_torch.kernels.flash_prefill_attention import check_shape
    small = dataclasses.replace(TARCHS["zamba2-2.7b"].reduced(), head_dim=80)
    sp = TM.init_serving_params(small, device="cpu")
    logits, caches = TS.make_prefill_step(small, "fp16", capacity=12)(
        sp, {"tokens": torch.ones((1, 4), dtype=torch.int32)})
    assert tuple(caches["shared"]["k"].shape) == (1, 1, 12, 4, 80)
    got, _ = TS.make_decode_step(small, "fp16")(
        sp, TM.planarize_cache(caches), logits.argmax(-1)[:, None], 4)
    assert torch.isfinite(got).all()
    check_shape(32, 32, 80)
    with pytest.raises(ValueError, match="need D in"):
        check_shape(32, 32, 72)


def test_decode_consistency_vs_long_prefill():
    """test_arch_smoke.py's check on mamba2, on the port: prefill(S) +
    decode(t) gives prefill(S + 1)'s last logits (f32 activations, FP16
    nested weights)."""
    _, tcfg, _, tsp = ssm_pair("mamba2-2.7b")
    rt = TRuntime(mode="fp16", dtype=torch.float32)
    toks = torch.randint(0, tcfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    lg_a, caches, length = TM.prefill(rt, tsp, tcfg, {"tokens": toks[:, :16]},
                                      capacity=20)
    lg_b, _ = TM.decode_step(rt, tsp, tcfg, toks[:, 16:17], caches, length)
    lg_full, _, _ = TM.prefill(rt, tsp, tcfg, {"tokens": toks}, capacity=20)
    np.testing.assert_allclose(lg_b.numpy(), lg_full.numpy(), rtol=2e-2,
                               atol=2e-2)
