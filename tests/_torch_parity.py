"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
the same seeded weights on both sides, carried across as numpy arrays."""

import dataclasses

import jax
import numpy as np

from repro.configs import ARCHS as JARCHS
from repro.core.linear import NestedLinearParams
from repro.models import model as JM
from repro.models.convert import to_serving as j_to_serving
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models.convert import from_jax_serving


def flatten_serving(tree, path: str = "") -> dict[str, np.ndarray]:
    """JAX serving tree -> {"a/b/c": array} in the layout that
    `repro_torch.models.convert.from_jax_serving` reads."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, NestedLinearParams):
        for name in ("upper", "lower", "raw"):
            a = getattr(tree.weight, name)
            if a is not None:
                out[f"{path}/weight/{name}"] = np.asarray(a)
        if tree.bias is not None:
            out[f"{path}/bias"] = np.asarray(tree.bias)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_serving(v, f"{path}/{k}" if path else k))
    else:
        out[path] = np.asarray(tree)
    return out


def configs(arch: str, **overrides):
    """The same reduced config on both sides (JAX, port)."""
    j = dataclasses.replace(JARCHS[arch].reduced(), **overrides)
    t = dataclasses.replace(TARCHS[arch].reduced(), **overrides)
    return j, t


def serving_pair(jcfg, n_layers: int, plant_exception: bool, seed: int = 0):
    """JAX serving params from `M.init_params` + `to_serving`, and the
    port's copy of them. plant_exception sets one element of layer 1's
    `wo` to 2.0 first, so that tensor stays f16 (an exception tensor)."""
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    if plant_exception:
        wo = params["layers"]["attn"]["wo"]["w"]
        params["layers"]["attn"]["wo"]["w"] = wo.at[1, 0, 0].set(2.0)
    sp = j_to_serving(params)
    return sp, from_jax_serving(flatten_serving(sp), n_layers,
                                device="cpu")
