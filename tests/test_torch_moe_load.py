"""Loading and the dense-slot steps of the MoE family in the port:
granite-moe-3b and deepseek-v3 against the JAX package.

The configs equal the JAX package's field for field (MoEConfig and
MLAConfig included, `reduced()` too); the streamed serving build is
bitwise `to_serving(init_params(...))` with 3-D expert banks nested as
bare NestedTensors and deepseek-v3's `mtp` subtree; `from_jax_serving`
carries the JAX serving tree's banks and `mtp` bitwise; checkpoints in
the JAX package's format cross both ways with banks; the structural
reckoning of the full configs equals the JAX package's; the serve CLI
takes the new --arch values. The dense-slot steps (`launch/steps.py`,
serve_rt: bf16) give the JAX steps' logits within BF16_TOL at every
(step, row) whose own token routed alike in every layer (at least 3/4
must), and every routing flip sits at a near-tie of the reference's
router logits (`_torch_parity.routing_flips`)."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (configs, flatten_serving,  # noqa: E402,F401
                           jax_router_logits, one_torch_thread,
                           routing_flips, serving_pair)
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.convert import to_serving as j_to_serving  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.core.linear import NestedLinearParams  # noqa: E402
from repro_torch.core.nestedfp import NestedTensor  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (from_jax_serving,  # noqa: E402
                                        serving_memory_bytes, to_serving)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")
BF16_TOL = {"fp16": 0.1, "fp8": 0.5}              # tests/test_torch_steps.py


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = configs(request.param)
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=True)
    return jcfg, tcfg, jsp, tsp


def _flat(tree, path: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a port tree by its path (plane names for nested
    weights, bare expert banks included)."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, NestedLinearParams):
        out.update(_flat(tree.weight, path + "/weight"))
        if tree.bias is not None:
            out[f"{path}/bias"] = tree.bias
    elif isinstance(tree, NestedTensor):
        for name in ("upper", "lower", "raw"):
            if getattr(tree, name) is not None:
                out[f"{path}/{name}"] = getattr(tree, name)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[path] = tree
    return out


def _assert_trees_equal(got, want, ordered=True):
    g, w = _flat(got), _flat(want)
    assert (list(g) == list(w)) if ordered else (set(g) == set(w))
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def _fields(c):
    return {f.name: (_fields(getattr(c, f.name))
                     if dataclasses.is_dataclass(getattr(c, f.name))
                     else getattr(c, f.name)) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(arch, reduced):
    t, j = TARCHS[arch], JARCHS[arch]
    if reduced:
        t, j = t.reduced(), j.reduced()
    tf, jf = _fields(t), _fields(j)
    assert tf == {k: jf[k] for k in tf}        # the port's fields only
    assert t.cache_kind == j.cache_kind
    assert t.moe.n_experts_padded == j.moe.n_experts_padded


def test_only_unported_families_are_refused():
    """No family is refused any more: a vlm config builds (its stub
    frontend's projection too); MLA latents refuse byte planes."""
    cfg = TARCHS["phi-3-vision-4.2b"].reduced()
    p = TM.init_params(cfg, device="meta")
    assert tuple(p["frontend_proj"]["w"].shape) == (128, 256)
    ds = TARCHS["deepseek-v3-671b"].reduced()
    with pytest.raises(ValueError, match="MLA latents"):
        TM.init_paged_cache(ds, 4, 16, planar=True, device="cpu")
    c = TM.init_cache(ds, 2, 8, planar=True, device="cpu")
    assert {n: (t.shape, t.dtype) for n, t in c["attn"].items()} == {
        "c_kv": ((2, 2, 8, 64), torch.float16),
        "k_rope": ((2, 2, 8, 16), torch.float16)}


def _plant_bank(i, path, w):
    if (i, path) == (1, "moe/w_down"):
        w[0, 0, 0] = 2.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plant", [False, True])
def test_streamed_build_is_bitwise_to_serving_of_init_params(arch, plant):
    """Banks nested as bare NestedTensors as each is drawn (plant: layer
    1's w_down an exception bank), the router left f32, deepseek-v3's
    mtp subtree last."""
    cfg = dataclasses.replace(TARCHS[arch].reduced(), n_layers=3)
    params = TM.init_params(cfg, seed=4, device="cpu")
    if plant:
        _plant_bank(1, "moe/w_down", params["layers"][1]["moe"]["w_down"])
    want = to_serving(params)
    got = TM.init_serving_params(cfg, seed=4, device="cpu",
                                 plant=_plant_bank if plant else None)
    _assert_trees_equal(got, want)
    moe = got["layers"][1]["moe"]
    assert isinstance(moe["w_down"], NestedTensor)
    assert moe["w_down"].is_exception == plant
    assert isinstance(moe["router"]["w"], torch.Tensor)
    assert ("mtp" in got) == bool(cfg.mtp_heads)


@pytest.mark.parametrize("arch", ARCHS)
def test_structural_reckoning_equals_jax(arch):
    """Nested bytes of the full config on meta tensors, against the JAX
    package's structural tree (deepseek-v3: 61 layers with 3 banks of
    256 x 7168 x 2048, and mtp)."""
    cfg = TARCHS[arch]
    meta = to_serving(TM.init_params(cfg, device="meta"), structural=True)
    mem = serving_memory_bytes(meta)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   JARCHS[arch]))
    jtree = j_to_serving(shapes, structural=True)
    jnested = sum(int(np.prod(x.shape)) for x in
                  jax.tree_util.tree_leaves(jtree) if x.dtype == jnp.uint8)
    assert mem["nested_bytes"] == jnested
    m = cfg.moe
    bank = m.n_experts_padded * cfg.d_model * m.d_ff_expert
    assert _flat(meta)["layers[0]/moe/w_gate/upper"].numel() == bank


def test_from_jax_serving_carries_banks_and_mtp(pair):
    jcfg, tcfg, jsp, tsp = pair
    flat = flatten_serving(jsp)
    assert "layers/moe/w_gate/upper" in flat
    for i, layer in enumerate(tsp["layers"]):
        for name in ("w_gate", "w_up", "w_down"):
            for plane in ("upper", "lower"):
                np.testing.assert_array_equal(
                    getattr(layer["moe"][name], plane).numpy(),
                    flat[f"layers/moe/{name}/{plane}"][i])
    if jcfg.mtp_heads:
        got = _flat(tsp["mtp"], "mtp")
        want = {k: v for k, v in flat.items() if k.startswith("mtp/")}
        assert set(got) == set(want) and len(want) > 10
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways_with_banks(arch, tmp_path):
    """A JAX checkpoint restores into the port nested as read (each
    layer's bank slice on its own), equal to the JAX serving tree's
    planes; a port checkpoint restores under the JAX package."""
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jio.save(str(tmp_path / "j"), {"params": params}, step=3)
    got, step = tio.restore(str(tmp_path / "j"), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu",
        serving=True)
    assert step == 3
    want = from_jax_serving(flatten_serving(j_to_serving(params)),
                            tcfg.n_layers, device="cpu")
    _assert_trees_equal(got["params"], want, ordered=False)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    tio.save(str(tmp_path / "t"), {"params": tp})
    back, _ = jio.restore(str(tmp_path / "t"), {"params": params})
    b = back["params"]
    for i, layer in enumerate(tp["layers"]):
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                np.asarray(b["layers"]["moe"][name][i]),
                layer["moe"][name].numpy())
    if jcfg.mtp_heads:
        np.testing.assert_array_equal(
            np.asarray(b["mtp"]["proj"]["w"]), tp["mtp"]["proj"]["w"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_moe_archs(arch, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--kv-planar", "--requests", "3", "--max-new", "4",
                     "--system-prompt-len", "16", "--slots", "1",
                     "--policy", "fp16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"finished": 3' in out and '"prefix_hit_rate": 0.0' not in out


# ---------------------------------------------------------------------------
# the dense-slot steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair,mode", [("granite-moe-3b-a800m", "fp16"),
                                       ("deepseek-v3-671b", "fp8")],
                         indirect=["pair"])
def test_dense_slot_steps_match_jax(pair, mode):
    """make_prefill_step (S = 20, capacity 28), then 4 staged decode
    steps, against the JAX steps; routing compared on a prefill of the
    whole sequence on each side. One mode a model (bf16 router logits
    flip most under deepseek-v3's FP8 path)."""
    jcfg, tcfg, jsp, tsp = pair
    s, cap, steps = 20, 28, 4
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab_size, (3, s)).astype(np.int32)
    want, jc = JS.make_prefill_step(jcfg, mode, capacity=cap)(
        jsp, {"tokens": jnp.asarray(toks)})
    got, tc = TS.make_prefill_step(tcfg, mode, capacity=cap)(
        tsp, {"tokens": torch.from_numpy(toks)})
    logits = [(np.asarray(got, np.float32), np.asarray(want, np.float32))]
    jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
    jd, td = JS.make_decode_step(jcfg, mode), TS.make_decode_step(tcfg, mode)
    seq = [toks]
    nxt = np.asarray(want, np.float32).argmax(-1).astype(np.int32)[:, None]
    for i in range(steps):
        seq.append(nxt)
        want, jc = jd(jsp, jc, jnp.asarray(nxt), s + i)
        got, tc = td(tsp, tc, torch.from_numpy(nxt), s + i)
        # the staged step returns its static logits buffer: copy it
        logits.append((np.array(got, np.float32),
                       np.asarray(want, np.float32)))
        nxt = logits[-1][1].argmax(-1).astype(np.int32)[:, None]
    full = np.concatenate(seq, axis=1)
    aux = []
    TM.prefill(TS.serve_rt(mode), tsp, tcfg,
               {"tokens": torch.from_numpy(full)}, aux=aux)
    r = routing_flips([a["router_logits"].numpy() for a in aux],
                      jax_router_logits(JS.serve_rt(mode), jsp, jcfg, full),
                      tcfg.moe.top_k)
    assert r["near_tie"], r
    # (step, row) qualifies when its own token (the prompt's last, or the
    # decoded one) routed alike in every layer
    own = [r["agree"][:, s - 1 + i] for i in range(steps + 1)]
    held = 0
    for (g, w), ok in zip(logits, own):
        err = np.abs(g - w)[ok]
        assert err.size == 0 or err.max() <= BF16_TOL[mode], err.max()
        held += int(ok.sum())
    assert held >= 0.75 * len(own) * toks.shape[0], (held, r["flips"])
    assert len(td.keys()) == 1
