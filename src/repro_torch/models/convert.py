"""Convert params into NestedFP serving params, and carry JAX weights over.

NestedFP applies to linear layers only (paper §2.2/Table 1 note):
embeddings, the LM head, norms and biases stay in their original
precision. `from_jax_serving` builds the port's serving params from the
JAX package's serving tree, flattened to numpy arrays by the caller
(the port imports nothing of JAX), keeping every byte plane exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linear import NestedLinearParams
from repro_torch.core.nestedfp import NestedTensor
from repro_torch.device import resolve_device

# path substrings excluded from nesting (as in the JAX package)
_EXCLUDE = ("embed", "lm_head", "router", "frontend_proj")


def _is_linear_dict(node) -> bool:
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor) and node["w"].dim() >= 2)


def to_serving(tree, *, path: str = ""):
    """Recursively nest every eligible linear weight (cast to f16 first;
    a tensor with any |w| > 1.75 stays f16 as an exception tensor)."""
    excluded = any(e in path for e in _EXCLUDE)
    if isinstance(tree, dict):
        if _is_linear_dict(tree) and not excluded:
            return NestedLinearParams(
                weight=NestedTensor.from_f16(tree["w"]), bias=tree.get("b"))
        return {k: to_serving(v, path=f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_serving(v, path=f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, NestedLinearParams):
        return tree.tensors()
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def params_to(tree, device):
    """The same tree with every tensor moved to `device`."""
    if isinstance(tree, NestedLinearParams):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def serving_memory_bytes(tree) -> dict[str, int]:
    """Audit: bytes of nested (uint8) vs other leaves."""
    nested = raw = 0
    for t in leaves(tree):
        nb = t.numel() * t.element_size()
        if t.dtype == torch.uint8:
            nested += nb
        else:
            raw += nb
    return {"nested_bytes": nested, "other_bytes": raw,
            "total_bytes": nested + raw}


def from_jax_serving(flat: dict[str, np.ndarray], n_layers: int,
                     device=None) -> dict:
    """Port serving params from the JAX serving tree, flattened by path.

    Keys are "/"-joined dict paths of the JAX tree (`M.init_params` +
    `to_serving`); a NestedLinearParams at path P contributes
    "P/weight/upper", "P/weight/lower", "P/weight/raw" (whichever exist)
    and "P/bias". Leaves under "layers/" are stacked (L, ...) and are
    split into one dict per layer. Bytes are kept exactly. device=None
    means the card."""
    device = resolve_device(device)
    nested: dict = {}
    for key, arr in flat.items():
        node = nested
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = arr

    def build(node, layer: int | None):
        if isinstance(node, dict) and "weight" in node:
            w = node["weight"]
            t = {n: build(w[n], layer) if n in w else None
                 for n in ("upper", "lower", "raw")}
            return NestedLinearParams(
                NestedTensor(t["upper"], t["lower"], t["raw"]),
                build(node["bias"], layer) if "bias" in node else None)
        if isinstance(node, dict):
            return {k: build(v, layer) for k, v in node.items()}
        arr = np.asarray(node) if layer is None else np.asarray(node)[layer]
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    stacked = nested.pop("layers")
    out = build(nested, None)
    out["layers"] = [build(stacked, i) for i in range(n_layers)]
    return out
