"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
the same seeded weights on both sides, carried across as numpy arrays."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.linear import NestedLinearParams
from repro.models import model as JM
from repro.models.convert import to_serving as j_to_serving
from repro.serving.kvcache import BlockManager as JBlockManager
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


@pytest.fixture
def one_torch_thread():
    """Torch on one intra-op thread for a test of many small CPU ops
    (import it, then `pytest.mark.usefixtures("one_torch_thread")`). In a
    run of several workers on one machine, torch's intra-op threads
    contend with the other workers' (a test of 0.5 s alone took 200 s);
    one thread keeps each test's time its own. The count comes back
    after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settled_set_table(orig):
    """JAX's BlockManager edits its host tables while the step it just
    dispatched may still be reading them: under CPU load the JAX engine
    then gives both one-token requests of test_torch_window.py's set the
    token 113, where a dense recompute on either side gives 205 and 495
    with top-2 margins of 0.057 and 0.064 (2 of 18 runs, six processes at
    once; 0 of 18 with this wrapper; ROADMAP F-ref-3). The wrapper lets
    the dispatched work finish before each table edit, so the reference
    runs its steps in the order its engine states."""
    def set_table(self, *args):
        jax.block_until_ready(jax.live_arrays())
        return orig(self, *args)
    return set_table


@pytest.fixture
def settled_jax_tables(monkeypatch):
    """The JAX engine with `_settled_set_table` (F-ref-3) for one test."""
    monkeypatch.setattr(JBlockManager, "_set_table",
                        _settled_set_table(JBlockManager._set_table))
