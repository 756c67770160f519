"""Checkpoints in the JAX package's format, read and written with numpy.

The format (the JAX package's `checkpoint/io.py`): a tree flattened to
arrays keyed by their `jax.tree_util.keystr` path, such as
"['params']['layers']['attn']['wq']['w']", in npz shards of at most
1 GiB each (a larger array sits alone in its shard), plus `index.json`
({"step", "n_shards", "keys": {key: shard}}).

The JAX package stacks a decoder's layers as (L, ...) arrays; the port
keeps a list of per-layer dicts. So a list in a port tree is one stacked
node of the JAX tree: `save` stacks it, `restore` slices it again. A
train state {"params": ..., "opt": {"step", "m", "v"}} is such a tree
too. A bf16 leaf (AdamW's low_mem moments) is stored as the JAX package
stores it, a 2-byte void array ("|V2") of its bits, and read back the
same way, without ml_dtypes.

`restore` streams: it reads one key at a time, and a stacked key one
layer's slice at a time straight from its npz member, so the host never
holds more than one slice (deepseek-coder-33b's stacked MLP keys are
34 GB each in f32). With `serving=True` each linear weight's slice is
nested on the device (K8 on the card) as soon as it is read, so the
device holds one f32 slice beside the served tree, as
`model.init_serving_params` does for random weights.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.core.linear import NestedLinearParams, keystr
from repro_torch.core.nestedfp import NestedTensor
from repro_torch.device import resolve_device
from repro_torch.models.convert import (_BANK_KEYS, _EXCLUDE, numpy_to_torch,
                                        torch_to_numpy, wrap_nested_linears)

_SHARD_BYTES = 1 << 30     # 1 GiB per shard, as the JAX package's


def _leaves(tree, path: tuple = ()):
    """(path, tensor) of every tensor leaf; a list contributes its
    elements' leaves under one stacked path, in element order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for elem in tree:
            yield from _leaves(elem, path)
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _stacked_len(tree) -> dict[tuple, int]:
    """{path of a list node: its length}."""
    out: dict[tuple, int] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            out[path] = len(node)
            if node:
                walk(node[0], path)
    walk(tree, ())
    return out


def flatten(tree) -> dict[str, np.ndarray]:
    """{keystr path: array}, lists stacked along a new first axis."""
    groups: dict[str, list[np.ndarray]] = {}
    stacked: set[str] = set()
    lists = _stacked_len(tree)
    for path, t in _leaves(tree):
        key = keystr(path)
        groups.setdefault(key, []).append(torch_to_numpy(t))
        if any(path[:len(p)] == p for p in lists):
            stacked.add(key)
    return {k: np.stack(v) if k in stacked else v[0]
            for k, v in groups.items()}


def save(path: str, tree, *, step: int | None = None) -> None:
    """Write `tree` (a dict of dicts, lists and tensors, e.g.
    {"params": model.init_params(...)}) in the JAX package's format."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(tree)
    shards: list[dict[str, np.ndarray]] = [{}]
    size = 0
    for k in sorted(flat):
        a = flat[k]
        if size + a.nbytes > _SHARD_BYTES and shards[-1]:
            shards.append({})
            size = 0
        shards[-1][k] = a
        size += a.nbytes
    index = {"step": step, "n_shards": len(shards),
             "keys": {k: i for i, sh in enumerate(shards) for k in sh}}
    for i, sh in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i}.npz"), **sh)
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump(index, f)


def _read_slices(zf: zipfile.ZipFile, key: str, n: int | None):
    """Yield the array stored under `key`, whole (n None) or as n slices
    along its first axis, each read from the member stream on its own."""
    fmt = np.lib.format
    with zf.open(key + ".npy") as f:
        version = fmt.read_magic(f)
        read_header = (fmt.read_array_header_1_0 if version == (1, 0)
                       else fmt.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if fortran:
            raise ValueError(f"{key}: Fortran-ordered arrays are not read")

        def read(shp):
            buf = bytearray(int(np.prod(shp)) * dtype.itemsize)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{key}: the member ends early")
            return np.frombuffer(buf, dtype).reshape(shp)
        if n is None:
            yield shape, read(shape)
            return
        if not shape or shape[0] != n:
            raise ValueError(f"shape mismatch at {key}: {shape} has no "
                             f"leading axis of {n} layers")
        for _ in range(n):
            yield shape, read(shape[1:])


def _set(tree, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _skeleton(tree):
    """The template's dicts and lists with every leaf still unread."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def restore(path: str, template, *, device=None, serving: bool = False):
    """Restore into `template`'s structure -> (tree, step).

    `template` is a port tree (e.g. {"params": model.init_params(cfg,
    device="meta")}): its leaves give each key's shape and dtype, checked
    as the JAX package checks them (a missing key raises KeyError, a
    shape mismatch ValueError); arrays are cast to the template's dtype.
    Leaves land on `device` (None = the card). With `serving`, every
    linear weight outside the embedding and LM head is nested as it is
    read (expert banks as bare nested tensors, a layer's bank at a time):
    the result is `convert.to_serving` of the restored tree."""
    device = resolve_device(device)
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    lists = _stacked_len(template)
    wanted: dict[str, tuple[tuple, torch.Tensor, int | None, tuple]] = {}
    for p, leaf in _leaves(template):
        key = keystr(p)
        if key in wanted:
            continue
        lp = next((q for q in lists if p[:len(q)] == q), None)
        wanted[key] = (p, leaf, None if lp is None else lists[lp], lp)
    missing = [k for k in wanted if k not in index["keys"]]
    if missing:
        raise KeyError(f"checkpoint missing {missing[0]}")
    out = _skeleton(template)
    by_shard: dict[int, list[str]] = {}
    for key in wanted:
        by_shard.setdefault(index["keys"][key], []).append(key)
    for shard in sorted(by_shard):
        with zipfile.ZipFile(os.path.join(path, f"shard_{shard}.npz")) as zf:
            for key in by_shard[shard]:
                p, leaf, n, lp = wanted[key]
                nest = (serving and p[-1] in ("w",) + _BANK_KEYS
                        and leaf.dim() >= 2
                        and not any(e in q for q in p if isinstance(q, str)
                                    for e in _EXCLUDE))
                for i, (shape, arr) in enumerate(_read_slices(zf, key, n)):
                    if tuple(arr.shape) != tuple(leaf.shape):
                        raise ValueError(f"shape mismatch at {key}: "
                                         f"{shape} vs {tuple(leaf.shape)}"
                                         + ("" if n is None else
                                            f" in each of {n} layers"))
                    t = numpy_to_torch(arr, copy=False).to(
                        device=device, dtype=leaf.dtype)
                    if nest:
                        t = NestedTensor.from_f16(t)
                    dest = p if n is None else lp + (i,) + p[len(lp):]
                    _set(out, dest, t)
                    del t, arr
    return (wrap_nested_linears(out) if serving else out), index.get("step")
