"""The port's serving-mesh spec tables against the JAX package's
resolvers: `launch/sharding.py::param_spec` for every leaf of every
config's parameters and `paged_cache_spec` for every plane of its paged
caches, at 2, 4 and 8 shards. Shapes come from `jax.eval_shape` (nothing
is allocated, no device count is forced); the JAX resolvers get a
duck-typed mesh, as tests/test_sharding.py gives them. The JAX package
stacks layers into a leading (L, ...) dim that the port's per-layer
leaves do not have: there the JAX spec is the port's behind one None."""

import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch.mesh import Mesh, model_axis_size  # noqa: E402

SIZES = (2, 4, 8)
_STACKED = ("layers", "enc_layers")


class FakeMesh:
    """A ("model",) mesh of m devices, for the JAX resolvers."""

    def __init__(self, m: int):
        self.shape = {"model": m}
        self.axis_names = ("model",)


def _keys(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path
            if hasattr(k, "key") or hasattr(k, "name")]


def _port_path(keys: list[str]) -> tuple:
    """The port's path of a JAX leaf: a layer index after "layers"."""
    for i, k in enumerate(keys):
        if k in _STACKED:
            return tuple(keys[:i + 1]) + (0,) + tuple(keys[i + 1:])
    return tuple(keys)


def _spec(p, rank: int) -> tuple:
    dims = tuple(p)
    return dims + (None,) * (rank - len(dims))


@pytest.fixture(scope="module")
def param_shapes():
    return {a: jax.eval_shape(
        lambda c=cfg: JM.init_params(jax.random.PRNGKey(0), c))
        for a, cfg in JARCHS.items()}


def test_every_config_has_its_port():
    assert set(JARCHS) == set(TARCHS)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_spec_matches_jax(param_shapes, arch, m):
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    leaves = jax.tree_util.tree_flatten_with_path(param_shapes[arch])[0]
    assert leaves
    sharded = 0
    for path, leaf in leaves:
        keys = _keys(path)
        want = _spec(JSH.param_spec(path, leaf, jcfg, FakeMesh(m)),
                     len(leaf.shape))
        stacked = any(k in _STACKED for k in keys) and len(leaf.shape) >= 1
        got = TSH.param_spec(_port_path(keys),
                             leaf.shape[1:] if stacked else leaf.shape,
                             tcfg, Mesh(["cpu"] * m))
        assert (want[1:] if stacked else want) == got, (keys, leaf.shape)
        if stacked:
            assert want[0] is None
        sharded += "model" in got
    assert sharded > 0, f"{arch}: nothing split at {m} shards"


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_paged_cache_spec_matches_jax(arch):
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    if jcfg.family == "encdec":
        with pytest.raises(NotImplementedError):
            JM.cache_descriptor(jcfg)
        return
    planars = (False, True) if jcfg.cache_kind == "gqa" else (False,)
    for planar in planars:
        shapes = jax.eval_shape(lambda: JM.init_paged_cache(
            jcfg, 5, 16, n_slots=3, planar=planar))
        for m in SIZES:
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
                want = _spec(JSH.paged_cache_spec(path, leaf, jcfg,
                                                  FakeMesh(m)),
                             len(leaf.shape))
                got = TSH.paged_cache_spec(tuple(_keys(path)), leaf.shape,
                                           tcfg, Mesh(["cpu"] * m))
                assert want == got, (arch, planar, m, _keys(path))


def test_mesh_shape_reads_as_jax():
    mesh = Mesh(["cpu"] * 4)
    assert mesh.shape == {"model": 4} and mesh.axis_names == ("model",)
    assert model_axis_size(mesh) == 4 == model_axis_size(FakeMesh(4))


def _jax_leaf(param_shapes, arch: str, keys: tuple):
    """The JAX leaf at `keys` of a config's parameter shapes, and its path
    as the resolvers read it."""
    node = param_shapes[arch]
    for k in keys:
        node = node[k]
    return tuple(jax.tree_util.DictKey(k) for k in keys), node


@pytest.mark.parametrize("m", (2, 3, 4))
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "mamba2-2.7b", "zamba2-2.7b"])
def test_serving_layout_reads_the_jax_specs(param_shapes, arch, m):
    """The port's `serving_layout` of the moe, MLA, ssm and hybrid families
    chooses what the JAX resolvers' specs say of the same leaves:
    expert-parallel where the banks' expert axis is split, per-expert
    tensor parallel where their F axis is, wq_a by columns, Mamba2 by
    heads where in_x's columns and the state's head axis are split, the
    hybrid's shared block as a dense layer."""
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    fm = FakeMesh(m)

    def jspec(*keys):
        path, leaf = _jax_leaf(param_shapes, arch, keys)
        return _spec(JSH.param_spec(path, leaf, jcfg, fm), len(leaf.shape))
    try:
        lay = TSH.serving_layout(tcfg, Mesh(["cpu"] * m))
    except NotImplementedError:
        # refused: MLA whose heads the JAX spec does not split (the port
        # serves MLA head-parallel only), or GQA q heads split over kv
        # heads kept whole
        if jcfg.mla is not None:
            assert jspec("layers", "attn", "wq_b", "w")[-1] is None
        return
    if jcfg.moe is not None:
        gate, down = jspec("layers", "moe", "w_gate"), \
            jspec("layers", "moe", "w_down")
        want = "ep" if gate[1] == "model" else \
            "tp" if (gate[3], down[2]) == ("model", "model") else "whole"
        assert lay.experts == want
        if jcfg.moe.n_shared_experts:
            assert lay.shared == ("col" if jspec(
                "layers", "moe", "shared", "gate", "w")[-1] == "model"
                else "whole")
    if jcfg.mla is not None:
        assert lay.q == lay.kv == "col" and lay.wo == "row"
        assert jspec("layers", "attn", "wq_b", "w")[-1] == "model"
        assert lay.q_a == ("col" if jspec("layers", "attn", "wq_a",
                                          "w")[-1] == "model" else "whole")
    if jcfg.ssm is not None:
        cols = jspec("layers", "mamba", "in_x", "w")[-1] == "model"
        shapes = jax.eval_shape(lambda: JM.init_paged_cache(
            jcfg, 5, 16, n_slots=3))
        st = shapes["ssm"]["ssm"]
        heads = JSH.paged_cache_spec(
            (jax.tree_util.DictKey("ssm"), jax.tree_util.DictKey("ssm")), st,
            jcfg, fm)
        assert lay.ssm == ("col" if cols else "whole")
        assert (tuple(heads) + (None,) * 5)[2] == ("model" if cols else None)
        assert lay.ssm_heads * (m if cols else 1) == st.shape[2]
    if jcfg.family == "hybrid":
        assert lay.q == ("col" if jspec("shared_attn", "attn", "wq",
                                        "w")[-1] == "model" else "whole")
        assert lay.mlp == ("col" if jspec("shared_attn", "mlp", "gate",
                                          "w")[-1] == "model" else "whole")
