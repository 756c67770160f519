"""Loading the dense family in the port: the configs against the JAX
package's, the layer-streamed build of serving params against
`to_serving(init_params(...))`, the structural (meta) serving tree,
`nest_weight_tree`, and checkpoints in the JAX package's format read and
written both ways, down to `launch/serve.py --ckpt`."""

import dataclasses
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import flatten_serving, one_torch_thread  # noqa: E402,F401
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import linear as jlinear  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.convert import to_serving as j_to_serving  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.core import linear as tlinear  # noqa: E402
from repro_torch.core.linear import NestedLinearParams  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (from_jax_serving,  # noqa: E402
                                        serving_memory_bytes, to_serving)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEW_ARCHS = ("qwen3-8b", "deepseek-coder-33b")


def _flat(tree, path: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a port serving tree by its path (plane names for
    a nested weight)."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, NestedLinearParams):
        for name in ("upper", "lower", "raw"):
            t = getattr(tree.weight, name)
            if t is not None:
                out[f"{path}/{name}"] = t
        if tree.bias is not None:
            out[f"{path}/b"] = tree.bias
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[path] = tree
    return out


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].device == w[k].device, k
        assert torch.equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(arch, reduced):
    t, j = TARCHS[arch], JARCHS[arch]
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.resolved_head_dim == j.resolved_head_dim


def test_registry_serves_every_dense_config():
    assert set(TARCHS) == {"qwen1.5-0.5b", "llama3.1-8b", "gemma3-1b",
                           "qwen3-8b", "deepseek-coder-33b",
                           "granite-moe-3b-a800m", "deepseek-v3-671b",
                           "mamba2-2.7b", "zamba2-2.7b", "phi-3-vision-4.2b",
                           "seamless-m4t-large-v2"}
    assert set(TARCHS) == set(JARCHS)          # every config of the JAX package
    assert {a for a, c in TARCHS.items() if c.family == "dense"} == {
        "qwen1.5-0.5b", "llama3.1-8b", "gemma3-1b", "qwen3-8b",
        "deepseek-coder-33b"}
    ds = TARCHS["deepseek-coder-33b"]
    assert ds.n_heads // ds.n_kv_heads == 7 and not ds.tie_embeddings
    assert TARCHS["qwen3-8b"].qk_norm


# ---------------------------------------------------------------------------
# the layer-streamed build
# ---------------------------------------------------------------------------

def _plant(i, path, w):
    if (i, path) == (1, "attn/wo/w"):
        w[0, 0] = 2.0


@pytest.mark.parametrize("arch", NEW_ARCHS + ("qwen1.5-0.5b", "gemma3-1b"))
@pytest.mark.parametrize("plant", [False, True])
def test_streamed_build_is_bitwise_to_serving_of_init_params(arch, plant):
    """Every byte plane, raw tensor, bias and norm, in the same order."""
    cfg = dataclasses.replace(TARCHS[arch].reduced(), n_layers=3)
    params = TM.init_params(cfg, seed=4, device="cpu")
    if plant:
        _plant(1, "attn/wo/w", params["layers"][1]["attn"]["wo"]["w"])
    want = to_serving(params)
    got = TM.init_serving_params(cfg, seed=4, device="cpu",
                                 plant=_plant if plant else None)
    _assert_trees_equal(got, want)
    assert got["layers"][1]["attn"]["wo"].weight.is_exception == plant


def test_streamed_build_holds_one_layer_of_f32_weights():
    """While a weight is drawn, no f32 weight drawn before it is alive:
    each is nested as it is drawn (counted through weak references to
    every weight that `plant` sees, which is each linear weight of every
    layer; the untied LM head stays f32 in the served tree, as the
    embedding does, and is not among them)."""
    cfg = dataclasses.replace(TARCHS["deepseek-coder-33b"].reduced(),
                              n_layers=4)
    made: list = []
    alive: list[int] = []

    def count(i, path, w):
        alive.append(sum(r() is not None for r in made))
        made.append(weakref.ref(w))
    TM.init_serving_params(cfg, seed=0, device="cpu", plant=count)
    assert alive == [0] * (7 * cfg.n_layers)     # 7 linears a layer
    kept = TM.init_params(cfg, seed=0, device="cpu")["layers"]
    made[:] = [weakref.ref(p["w"]) for layer in kept
               for blk in (layer["attn"], layer["mlp"]) for p in blk.values()
               if isinstance(p, dict)]
    assert sum(r() is not None for r in made) == 7 * cfg.n_layers


# ---------------------------------------------------------------------------
# the structural tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS + ("llama3.1-8b",))
def test_structural_bytes_equal_the_real_tree(arch):
    cfg = TARCHS[arch].reduced()
    real = serving_memory_bytes(TM.init_serving_params(cfg, device="cpu"))
    meta = to_serving(TM.init_params(cfg, device="meta"), structural=True)
    assert all(t.device.type == "meta" for t in _flat(meta).values())
    assert serving_memory_bytes(meta) == real


def test_structural_reckoning_of_deepseek_coder_33b():
    """62 layers x 530,317,312 nested weights x 2 bytes, and the f32
    embedding and LM head (32256 x 7168 each) beside them: reckoned on
    meta tensors, nothing allocated."""
    cfg = TARCHS["deepseek-coder-33b"]
    tree = to_serving(TM.init_params(cfg, device="meta"), structural=True)
    mem = serving_memory_bytes(tree)
    assert mem["nested_bytes"] == 65_759_346_688 == 2 * 62 * 530_317_312
    assert mem["other_bytes"] == 4 * (2 * 32256 * 7168 + 7168 * (2 * 62 + 1))
    shapes = jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), JARCHS["deepseek-coder-33b"]))
    jtree = j_to_serving(shapes, structural=True)
    jnested = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        jtree) if x.dtype == jnp.uint8)
    assert jnested == mem["nested_bytes"]


def test_nest_weight_tree_equals_jax():
    """The same weights, the JAX tree stacked and the port's per layer:
    equal planes under a filter that leaves the embedding out; an
    exception tensor stays f16 on both sides."""
    jcfg = JARCHS["qwen3-8b"].reduced()
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    wo = params["layers"]["attn"]["wo"]["w"]
    params["layers"]["attn"]["wo"]["w"] = wo.at[0, 0, 0].set(3.0)
    keep = (lambda p: "embed" not in p)
    jn = jlinear.nest_weight_tree(params, keep)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)), params)
    stacked = tparams.pop("layers")
    tparams["layers"] = [jax.tree_util.tree_map(lambda a: a[i], stacked)
                         for i in range(jcfg.n_layers)]
    paths: list[str] = []
    tn = tlinear.nest_weight_tree(
        tparams, lambda p: paths.append(p) or keep(p))
    assert "['layers'][1]['attn']['wq']['w']" in paths
    assert torch.is_tensor(tn["embed"]["tok"])
    jwq, twq = jn["layers"]["attn"]["wq"]["w"], [
        layer["attn"]["wq"]["w"] for layer in tn["layers"]]
    for i, t in enumerate(twq):
        assert torch.equal(t.upper, torch.from_numpy(np.array(jwq.upper[i])))
        assert torch.equal(t.lower, torch.from_numpy(np.array(jwq.lower[i])))
    assert jn["layers"]["attn"]["wo"]["w"].is_exception
    assert tn["layers"][0]["attn"]["wo"]["w"].is_exception
    assert not tn["layers"][1]["attn"]["wo"]["w"].is_exception
    lm = tn["lm_head"]["w"]
    np.testing.assert_array_equal(lm.upper.numpy(),
                                  np.asarray(jn["lm_head"]["w"].upper))


# ---------------------------------------------------------------------------
# checkpoints in the JAX package's format
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_into_served_planes(tmp_path):
    """The JAX package's save of reduced qwen3-8b params, restored by the
    port with nesting on the fly: the planes of `from_jax_serving` of the
    JAX `to_serving`, tensor for tensor."""
    jcfg, tcfg = JARCHS["qwen3-8b"].reduced(), TARCHS["qwen3-8b"].reduced()
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jio.save(str(tmp_path), {"params": params}, step=11)
    got, step = tio.restore(str(tmp_path), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu",
        serving=True)
    assert step == 11
    want = from_jax_serving(flatten_serving(j_to_serving(params)),
                            tcfg.n_layers, device="cpu")
    g, w = _flat(got["params"]), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    # training form: each layer's slice, f32, as the JAX arrays hold it
    raw, _ = tio.restore(str(tmp_path), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu")
    np.testing.assert_array_equal(
        raw["params"]["layers"][1]["mlp"]["down"]["w"].numpy(),
        np.asarray(params["layers"]["mlp"]["down"]["w"][1]))


def test_port_checkpoint_restores_under_jax(tmp_path):
    tcfg, jcfg = TARCHS["qwen3-8b"].reduced(), JARCHS["qwen3-8b"].reduced()
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    tio.save(str(tmp_path), {"params": tp}, step=5)
    template = {"params": JM.init_params(jax.random.PRNGKey(0), jcfg)}
    got, step = jio.restore(str(tmp_path), template)
    assert step == 5
    g = got["params"]
    np.testing.assert_array_equal(np.asarray(g["embed"]["tok"]),
                                  tp["embed"]["tok"].numpy())
    for i, layer in enumerate(tp["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                np.asarray(g["layers"]["attn"][name]["w"][i]),
                layer["attn"][name]["w"].numpy())
        np.testing.assert_array_equal(
            np.asarray(g["layers"]["attn"]["q_norm"][i]),
            layer["attn"]["q_norm"].numpy())
    # and back into the port: every tensor as saved
    back, _ = tio.restore(str(tmp_path), {
        "params": TM.init_params(tcfg, device="meta")}, device="cpu")
    _assert_trees_equal(back["params"], tp)


def test_restore_checks_keys_and_shapes(tmp_path):
    cfg = TARCHS["qwen3-8b"].reduced()
    tp = TM.init_params(cfg, seed=0, device="cpu")
    del tp["layers"][0]["attn"]["k_norm"], tp["layers"][1]["attn"]["k_norm"]
    tio.save(str(tmp_path / "a"), {"params": tp})
    template = {"params": TM.init_params(cfg, device="meta")}
    with pytest.raises(KeyError, match="checkpoint missing"):
        tio.restore(str(tmp_path / "a"), template, device="cpu")
    wide = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    tio.save(str(tmp_path / "b"), {"params": TM.init_params(
        wide, device="cpu")})
    with pytest.raises(ValueError, match="shape mismatch"):
        tio.restore(str(tmp_path / "b"), template, device="cpu")


def test_checkpoint_shards_cap_their_bytes(tmp_path, monkeypatch):
    """Shards hold at most the cap, a larger key sits alone, and a
    restore streams layer slices across shards."""
    monkeypatch.setattr(tio, "_SHARD_BYTES", 300_000)
    cfg = TARCHS["deepseek-coder-33b"].reduced()
    tp = TM.init_params(cfg, seed=6, device="cpu")
    tio.save(str(tmp_path), {"params": tp})
    files = sorted(tmp_path.glob("shard_*.npz"))
    assert len(files) > 3
    back, _ = tio.restore(str(tmp_path), {
        "params": TM.init_params(cfg, device="meta")}, device="cpu",
        serving=True)
    _assert_trees_equal(back["params"], to_serving(tp))


def test_serve_ckpt_finishes_every_request(tmp_path, capsys):
    jcfg = JARCHS["qwen3-8b"].reduced()
    jio.save(str(tmp_path), {"params": JM.init_params(
        jax.random.PRNGKey(0), jcfg)})
    rc = serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                     "--kv-planar", "--ckpt", str(tmp_path), "--requests",
                     "3", "--max-new", "4", "--policy", "fp8"])
    assert rc == 0
    assert '"finished": 3' in capsys.readouterr().out
