"""`repro-lint` for the PyTorch port: AST-based static analysis of its
hot-path, CUDA-graph and kernel-launch discipline.

The port is fast by convention: one host sync a serving step, one CUDA
graph a bucketed step key, static graph outputs copied out before the
key runs again, ctypes launches that check what they hand a kernel.
This package turns those conventions into machine-checked rules over
the port's ASTs — no imports, no tracing, stdlib-only (`ast`). It is
the JAX package's `repro.analysis` restated for PyTorch; the directive
grammar, the rule ids, the baseline and report formats are the same.

Rules (see README.md for the catalog and each JAX counterpart):

* NFP001  host sync reachable from a hot root outside the declared
          sync point
* NFP002  read of a graph runner's static output after the runner's
          next call
* NFP003  graph cache keyed on a raw integer not derived from a
          pow2/bucket helper
* NFP004  ctypes kernel-launch hygiene (checked pointers, checked return
          code, the current stream, the tensor's device)
* NFP005  Python control flow on a tensor's value inside a captured body

Inline directives (comments):

* ``# nfp: ignore[NFP001] <reason>``  suppress a finding on this line
  (or the next line when the directive stands alone); the reason is
  mandatory
* ``# nfp: hot-path``    on/above a ``def``: treat it as an NFP001 root
* ``# nfp: sync-point``  on/above a ``def``: the function IS the
  declared host sync; NFP001 skips its body
"""

from repro_torch.analysis.astutil import Directive, Module, load_module
from repro_torch.analysis.callgraph import CallGraph, FuncInfo
from repro_torch.analysis.rules import Finding

__all__ = ["Directive", "Module", "load_module", "CallGraph", "FuncInfo",
           "Finding", "run_analysis", "main"]


def __getattr__(name):
    # lazy: importing .cli here would pre-load it into sys.modules and
    # make `python -m repro_torch.analysis.cli` warn under runpy
    if name in ("main", "run_analysis"):
        from repro_torch.analysis import cli
        return getattr(cli, name)
    raise AttributeError(name)
