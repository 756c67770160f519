"""Convert params into NestedFP serving params, and carry JAX weights over.

NestedFP applies to linear layers only (paper §2.2/Table 1 note), MoE
expert banks included: embeddings, the LM head, the MoE router, norms and
biases stay in their original precision. A 3-D expert bank (E, D, F)
is nested as one bare `NestedTensor` (whole-tensor exception rule), not
as a NestedLinearParams. `structural=True` builds the same tree on the meta device (no
data, applicability assumed), PyTorch's form of the JAX package's
ShapeDtypeStruct tree: `serving_memory_bytes` of it reckons a model's
serving bytes without allocating them. `from_jax_serving` builds the
port's serving params from the JAX package's serving tree, flattened to
numpy arrays by the caller (the port imports nothing of JAX), keeping
every byte plane exactly; it carries a training-form tree across as
well, and `from_jax_opt_state` an AdamW state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linear import NestedLinearParams
from repro_torch.core.nestedfp import NestedTensor
from repro_torch.device import resolve_device

# path substrings excluded from nesting (as in the JAX package)
_EXCLUDE = ("embed", "lm_head", "router", "frontend_proj")
# 3-D expert-bank leaves nested as whole tensors
_BANK_KEYS = ("w_gate", "w_up", "w_down")


def _is_linear_dict(node) -> bool:
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor) and node["w"].dim() >= 2)


def _nest_tensor(w: torch.Tensor, structural: bool) -> NestedTensor:
    if structural:
        return NestedTensor(
            upper=torch.empty(w.shape, dtype=torch.uint8, device="meta"),
            lower=torch.empty(w.shape, dtype=torch.uint8, device="meta"),
            raw=None)
    return NestedTensor.from_f16(w)


def to_serving(tree, *, structural: bool = False, path: str = ""):
    """Recursively nest every eligible linear weight (cast to f16 first;
    a tensor with any |w| > 1.75 stays f16 as an exception tensor). With
    `structural`, each nested weight is a pair of meta uint8 planes of its
    shape and nothing is read or encoded."""
    excluded = any(e in path for e in _EXCLUDE)
    if isinstance(tree, dict):
        if _is_linear_dict(tree) and not excluded:
            return NestedLinearParams(
                weight=_nest_tensor(tree["w"], structural),
                bias=tree.get("b"))
        return {k: _nest_tensor(v, structural)
                if (k in _BANK_KEYS and not excluded
                    and isinstance(v, torch.Tensor))
                else to_serving(v, structural=structural, path=f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_serving(v, structural=structural,
                                     path=f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def wrap_nested_linears(tree):
    """Linear dicts whose "w" is nested ({"w": NestedTensor[, "b"]})
    become NestedLinearParams, as `to_serving` makes them; bare nested
    leaves (expert banks) stay as they are."""
    if isinstance(tree, dict):
        if isinstance(tree.get("w"), NestedTensor):
            return NestedLinearParams(tree["w"], tree.get("b"))
        return {k: wrap_nested_linears(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(wrap_nested_linears(v) for v in tree)
    return tree


def leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, (NestedLinearParams, NestedTensor)):
        return tree.tensors()
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def params_to(tree, device):
    """The same tree with every tensor moved to `device`."""
    if isinstance(tree, (NestedLinearParams, NestedTensor)):
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


_PLANES = {"upper", "lower", "raw"}


def numpy_to_torch(a: np.ndarray, copy: bool = True) -> torch.Tensor:
    """A CPU tensor of a numpy array's values (sharing a writable array's
    memory with copy=False). A 2-byte void array (how numpy holds and
    stores a bf16 array of the JAX package, ml_dtypes' bfloat16, whose
    descr is "|V2") is read as the bf16 bits it holds, so no ml_dtypes is
    needed."""
    if copy:
        a = np.array(a, copy=True)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host; a bf16 tensor as
    the 2-byte void array of its bits ("|V2"), the bytes the JAX package
    stores for a bf16 leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_jax_serving(flat: dict[str, np.ndarray], n_layers: int,
                     device=None) -> dict:
    """Port serving params from the JAX serving tree, flattened by path
    (or training-form params from the JAX `M.init_params` tree: its
    linear dicts {"w"[, "b"]} stay dicts).

    Keys are "/"-joined dict paths of the JAX tree (`M.init_params` +
    `to_serving`); a NestedLinearParams at path P contributes
    "P/weight/upper", "P/weight/lower", "P/weight/raw" (whichever exist)
    and "P/bias", a bare NestedTensor (an expert bank) "P/upper",
    "P/lower" or "P/raw". Leaves under "layers/" are stacked (L, ...) and
    are split into one dict per layer, as are an encdec's "enc_layers/"
    (as many as their leading axis holds); every other subtree (the
    embedding, the head, `frontend_proj`, `enc_norm`, a hybrid's
    `shared_attn`, deepseek-v3's `mtp`) is taken whole. Bytes are kept
    exactly. device=None means the card."""
    device = resolve_device(device)
    nested: dict = {}
    for key, arr in flat.items():
        node = nested
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = arr

    def nested_tensor(node, layer):
        return NestedTensor(*(build(node[n], layer) if n in node else None
                              for n in ("upper", "lower", "raw")))

    def build(node, layer: int | None):
        if isinstance(node, dict) and node and set(node) <= _PLANES:
            return nested_tensor(node, layer)
        if isinstance(node, dict) and "weight" in node:
            return NestedLinearParams(
                nested_tensor(node["weight"], layer),
                build(node["bias"], layer) if "bias" in node else None)
        if isinstance(node, dict):
            return {k: build(v, layer) for k, v in node.items()}
        arr = np.asarray(node) if layer is None else np.asarray(node)[layer]
        return numpy_to_torch(arr).to(device)

    stacked = nested.pop("layers")
    enc = nested.pop("enc_layers", None)
    out = build(nested, None)
    if enc is not None:
        n_enc = len(next(v for k, v in flat.items()
                         if k.startswith("enc_layers/")))
        out["enc_layers"] = [build(enc, i) for i in range(n_enc)]
    out["layers"] = [build(stacked, i) for i in range(n_layers)]
    return out


def from_jax_opt_state(flat: dict[str, np.ndarray], n_layers: int,
                       device=None) -> dict:
    """An AdamW state {"step", "m", "v"} from the JAX package's, flattened
    by path ("step", "m/...", "v/..."): the moments split per layer as
    `from_jax_serving` splits params (bf16 moments kept bitwise)."""
    device = resolve_device(device)
    out = {"step": numpy_to_torch(np.asarray(flat["step"])).to(device)}
    for name in ("m", "v"):
        sub = {k[len(name) + 1:]: v for k, v in flat.items()
               if k.startswith(name + "/")}
        out[name] = from_jax_serving(sub, n_layers, device)
    return out
