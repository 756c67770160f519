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
