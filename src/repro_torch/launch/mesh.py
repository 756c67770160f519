"""Serving meshes, and the layouts of the training meshes.

The port of the JAX package's `launch/mesh.py`. Its serving half
(`make_serving_mesh`, `make_replica_meshes`, `model_axis_size`) builds a
`Mesh`, a 1-D ("model",) axis of tensor-parallel shards. A JAX
mesh lays its axis over devices and GSPMD runs one program on each; here
one process drives every shard of a `Mesh` in turn and the mesh does the
one collective the layers need, `all_reduce` (and `all_gather` for a
column-parallel output that must be whole again).

A mesh is an explicit list of `torch.device`s, one a shard, and a device
may repeat: `["cpu"] * 4` is the CPU tests' 4-shard mesh (the JAX
package forces four host devices for the same purpose), `[cuda:0] * 4`
puts four shards on one card. Shards that share a device share nothing
else: each holds its own slices of the weights and its own pool. The
reduction moves every partial to the first shard's device (a no-op for
shards on that device), sums in shard order and hands the sum back, so a
step's bits do not depend on where the shards sit, and the code that runs
with every shard on one card is the code a mesh across cards runs.
NCCL is not used: it refuses two ranks on one GPU.

Its training half (`make_production_mesh`, `make_debug_mesh`,
`data_axes`, `data_axis_size`) returns a `Layout`: axis names and sizes
and no devices, which is all the dry run (`launch/dryrun.py`) and the
spec resolvers (`launch/sharding.py`) read. The production layouts are
the JAX package's: (data 16, model 16), 256 devices, and (pod 2, data
16, model 16), 512; on H100s a 16-way model axis spans two 8-GPU boards
(`roofline/analysis.py` prices its collectives accordingly). A serving
`Mesh` has no data axis: `data_axes` gives () and `data_axis_size` 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


def _indexed(d) -> torch.device:
    """A device with its index: "cuda" is the current card, so that shards
    given as "cuda" and "cuda:0" are seen to share it."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D ("model",) axis over `devices`, one entry a shard.

    `slots` names each shard's place in a larger pool of shard slots
    (`make_replica_meshes` cuts disjoint ones); a plain mesh's slots are
    0..n-1. `shape` and `axis_names` read as a JAX mesh's do."""

    axis_names = ("model",)

    def __init__(self, devices: Sequence, slots: Sequence[int] | None = None):
        self.devices = tuple(map(_indexed, devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.slots = tuple(range(len(self.devices)) if slots is None
                           else slots)
        if len(self.slots) != len(self.devices):
            raise ValueError(f"{len(self.slots)} slots for "
                             f"{len(self.devices)} shards")
        self.shape = {"model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def colocated(self) -> bool:
        """Every shard on one device."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return (f"Mesh(model={self.size}, devices="
                f"{[str(d) for d in self.devices]}, slots={list(self.slots)})")

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """`x` on every shard's device: the same tensor for every shard on
        its device, one copy for each other device."""
        on: dict[torch.device, torch.Tensor] = {x.device: x}
        for d in self.devices:
            if d not in on:
                on[d] = x.to(d)
        return [on[d] for d in self.devices]

    def all_reduce(self, parts: Sequence[torch.Tensor],
                   op: str = "sum") -> list[torch.Tensor]:
        """Combine one partial a shard: each is moved to the first shard's
        device and folded in shard order 0, 1, ... ("sum": +, "max":
        elementwise maximum), and the result is handed back to every
        shard's device (`replicate`)."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} partials for {self.size} shards")
        root = self.devices[0]
        acc = parts[0].to(root)
        for p in parts[1:]:
            p = p.to(root)
            if op == "sum":
                acc = acc + p
            elif op == "max":
                acc = torch.maximum(acc, p)
            else:
                raise ValueError(f"unknown reduction {op!r}")
        return self.replicate(acc)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int = -1) -> list[torch.Tensor]:
        """Concatenate one slice a shard along `dim`, in shard order, on the
        first shard's device, and hand the whole back to every shard."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} slices for {self.size} shards")
        root = self.devices[0]
        return self.replicate(torch.cat([p.to(root) for p in parts], dim=dim))


def _cards() -> list[torch.device]:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the mesh's devices "
                           "(e.g. devices=['cpu'] * 4)")
    return [torch.device("cuda", i) for i in range(n)]


def make_serving_mesh(model: int | None = None, devices=None) -> Mesh:
    """The engine's tensor-parallel mesh (`Engine(mesh=...)`): the first
    `model` of `devices` (default: every card), all of them when `model`
    is None. Raises when there are fewer. `devices` may repeat a device:
    shards then share it."""
    devs = list(_cards() if devices is None else devices)
    n = len(devs) if model is None else model
    if n < 1 or len(devs) < n:
        raise RuntimeError(f"serving mesh needs {n} devices, have "
                           f"{len(devs)}")
    return Mesh(devs[:n])


def make_replica_meshes(n_replicas: int, model: int,
                        devices=None) -> list[Mesh]:
    """Disjoint ("model",) meshes for data-parallel engine replicas
    behind `serving.router.Router`: replica i owns shard slots
    [i * model, (i + 1) * model) of `devices` (default: every card).
    Replicas share no shard, even where their slots sit on one device.
    Raises when there are fewer slots than n_replicas * model."""
    devs = list(_cards() if devices is None else devices)
    need = n_replicas * model
    if len(devs) < need:
        raise RuntimeError(f"{n_replicas} replica meshes of {model} shards "
                           f"need {need} devices, have {len(devs)}")
    return [Mesh(devs[i * model:(i + 1) * model],
                 slots=range(i * model, (i + 1) * model))
            for i in range(n_replicas)]


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh's axes and sizes, without devices: `shape` and `axis_names`
    read as a JAX mesh's do."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """(data 16, model 16), or with multi_pod (pod 2, data 16, model 16):
    `pod` is an outer data-parallel axis."""
    if multi_pod:
        return Layout(("pod", "data", "model"), (2, 16, 16))
    return Layout(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 2, model: int = 2) -> Layout:
    """A small (data, model) layout (`make_debug_mesh(1, 1)`: one card)."""
    return Layout(("data", "model"), (data, model))


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes of a mesh (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def data_axis_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))
