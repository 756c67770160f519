"""FLOPs of a step, counted on meta tensors, and its live bytes.

The port's counterpart of the JAX package's `roofline/flops.py`, which
walks the jaxpr of a step (`count_step_flops`). Here `count` runs the
port's own step (`launch/steps.py`: `make_train_step`,
`make_prefill_step`, `make_decode_step`) once on meta tensors under a
`TorchDispatchMode` that sees every aten op it dispatches, autograd's
backward included. Nothing is allocated or computed, and no card is
needed. As in the JAX module:

- a matrix product (mm, bmm, addmm, baddbmm, ...) is charged 2·b·m·n·k;
- an op that only moves data or casts (the JAX package's `_FREE`: views,
  copies, gathers and scatters, concatenation, fills) is free;
- every other op (elementwise, reductions) one FLOP an output element.

Each FLOP lands in the class of its dtype (`CLASSES`: f16 for f16 and
bf16, e4m3, f32, other): a product's inputs', another op's output's.

A kernel wrapper's call (`kernels/ops.py`: K1–K8 and the quantizer) is
charged once, with its kernel's FLOPs and class (K1 / K3 / K4 / K5 / K6
f16 tensor-core work, K2 / K7 e4m3), through
`kernels._common.KERNEL_SCOPE`; on meta tensors a wrapper runs none of
its plain version (whose GEMMs sum in f64, F-port-5, which is not what
the card runs): it returns its kernel's outputs as meta tensors. Where the JAX step computes attention as masked
full-score einsums, the kernels are charged the same masked positions,
so the dot totals agree with the jaxpr's.

The JAX module's `scan_trip_info` has nothing to count here: the port
has no scans. Its layers and microbatches are Python loops, which the
dispatch mode sees one iteration at a time.

The same run gives `peak_temp_bytes`: the most bytes that storages
created by the step's ops (not its arguments) held at once, each freed
when its last tensor dies.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _common
from repro_torch.kernels.ops import dtype_class
from repro_torch.launch.sharding import tree_leaves

CLASSES = ("f16", "e4m3", "f32", "other")

_aten = torch.ops.aten

_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "select", "slice", "narrow",
    "as_strided", "alias", "detach", "lift_fresh", "clone", "contiguous",
    "copy", "copy_", "_to_copy", "to", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full",
    "fill", "fill_", "zero_", "scalar_tensor", "arange", "cat", "stack",
    "split", "split_with_sizes", "unbind", "chunk", "index", "index_select",
    "gather", "scatter", "index_put", "index_put_", "index_copy",
    "index_copy_", "embedding", "embedding_dense_backward", "repeat",
    "repeat_interleave", "flip", "roll", "pad", "constant_pad_nd",
    "slice_scatter", "select_scatter", "diagonal", "unfold", "view_as_real",
    "_local_scalar_dense", "where", "masked_fill", "masked_fill_", "lift",
    "_has_compatible_shallow_copy_type", "set_", "resize_", "one_hot",
    "tril", "triu", "col2im", "im2col", "expand_copy", "permute_copy",
    "clamp_min_", "new_tensor", "_unsafe_index", "_unsafe_index_put",
    "index_fill", "index_fill_", "masked_scatter", "view_as",
}


def _name(func) -> str:
    return func.overloadpacket.__name__


def _product(func, args) -> tuple[int, torch.dtype] | None:
    """(FLOPs, input dtype) of a matrix product, None for another op."""
    name = _name(func)
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1], a.dtype
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], a.dtype
    if name == "mv":
        return 2 * args[0].numel(), args[0].dtype
    if name == "dot":
        return 2 * args[0].numel(), args[0].dtype
    return None


class FlopCounter(TorchDispatchMode):
    """FLOPs by class (`by_class`, and the dots alone, `dot_by_class`),
    kernel calls by wrapper (`kernel_calls`) and the peak of live bytes
    (`peak_temp_bytes`) of what runs under it. `exclude` holds tensors
    (the step's arguments) whose storages are not temporaries."""

    def __init__(self, exclude=()):
        super().__init__()
        self.by_class = dict.fromkeys(CLASSES, 0)
        self.dot_by_class = dict.fromkeys(CLASSES, 0)
        self.kernel_calls: collections.Counter = collections.Counter()
        self._depth = 0
        self._args = {t.untyped_storage()._cdata for t in exclude}
        self._live: dict[int, list] = {}
        self.temp_bytes = 0
        self.peak_temp_bytes = 0

    def _add(self, flops: int, cls: str, dot: bool) -> None:
        self.by_class[cls] += flops
        if dot:
            self.dot_by_class[cls] += flops

    def kernel(self, name: str, charge: tuple, run):
        """One kernel wrapper's call: charged once unless inside another;
        what runs inside is neither counted nor held as temporaries, its
        result is."""
        if self._depth == 0:
            self._add(*charge)
            self.kernel_calls[name] += 1
        self._depth += 1
        try:
            out = run()
        finally:
            self._depth -= 1
        if self._depth == 0:
            self._hold(out)
        return out

    def _hold(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args:
                continue
            if key not in self._live:
                self._live[key] = [st.nbytes(), 0]
                self.temp_bytes += st.nbytes()
                self.peak_temp_bytes = max(self.peak_temp_bytes,
                                           self.temp_bytes)
            self._live[key][1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.temp_bytes -= entry[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._depth:
            return out
        name = _name(func)
        prod = _product(func, args)
        if prod is not None:
            self._add(prod[0], dtype_class(prod[1]), True)
            if name in ("addmm", "baddbmm"):
                self._add(out.numel(), dtype_class(out.dtype), False)
        elif name not in _FREE:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            if outs:
                self._add(sum(t.numel() for t in outs),
                          dtype_class(outs[0].dtype), False)
        self._hold(out)
        return out

    def __enter__(self):
        self._token = _common.KERNEL_SCOPE.set(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _common.KERNEL_SCOPE.reset(self._token)
        return super().__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.by_class.values())

    @property
    def dots(self) -> int:
        return sum(self.dot_by_class.values())


def count(fn, *args) -> FlopCounter:
    """Run fn(*args) (on meta tensors) under a `FlopCounter`, its output
    kept as `.result`; the tensors of args are not temporaries."""
    counter = FlopCounter(exclude=[t for _, t, _ in tree_leaves(list(args))])
    with counter:
        counter.result = fn(*args)
    return counter
