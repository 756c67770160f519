"""NFP004 (kernel-launch hygiene) and NFP005 (data-dependent control
flow in a captured body).

Both guard failure modes that only surface on the card: a ctypes launch
hands raw pointers to a CUDA kernel that trusts every byte of them, and
a CUDA-graph capture records the stream's work, not the Python around
it, so a host read of a tensor in a captured body either syncs
mid-capture (the capture fails) or freezes the branch taken at capture.
Neither shows on the CPU, where the wrappers take their plain versions
and the steps run eagerly.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import Module, resolve_call_target, unparse_short
from repro_torch.analysis.callgraph import CallGraph, FuncDef, FuncInfo
from repro_torch.analysis.rules import (Finding, _body_nodes, _call_name,
                                        is_tensor_call, tensor_names)

_ALLOC = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like",
          "ones_like", "full_like", "empty_strided", "arange", "randn",
          "rand", "randint"}


def _target(call: ast.Call, mod: Module) -> str:
    return resolve_call_target(call, mod) or ""


def _last_argtype(expr: ast.AST | None, env: dict[str, ast.AST],
                  depth: int = 4) -> str | None:
    """The last element of a ctypes argtypes expression such as
    `[c_void_p] * 3 + [c_int] * 3 + [c_void_p]`, unparsed; None when it
    cannot be read."""
    while depth and isinstance(expr, ast.Name) and expr.id in env:
        expr, depth = env[expr.id], depth - 1
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _last_argtype(expr.right, env, depth)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        return _last_argtype(expr.left, env, depth)
    if isinstance(expr, (ast.List, ast.Tuple)) and expr.elts:
        return ast.unparse(expr.elts[-1])
    return None


def _module_env(mod: Module) -> dict[str, ast.AST]:
    return {n.targets[0].id: n.value for n in mod.tree.body
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)}


class KernelLaunchRule:
    """NFP004: every launch of a kernel entry obtained from
    `kernels/_build.py::function` must

    (a) pass `.data_ptr()` only of tensors checked earlier in the
        function by `_common.expect` (directly, or through a helper of
        the module that calls it) or allocated there: the kernel reads
        dtype, shape and contiguity from its integer arguments alone;
    (b) hand its return code (the launch's cudaError_t) to `_build.check`;
    (c) take its stream from `_common.stream_handle`: a literal is the
        legacy default stream, which a graph capture forbids;
    (d) sit inside `with torch.cuda.device(...)`, so a tensor on another
        card launches there.

    An entry is a launch when its declared argtypes end with the stream
    (`c_void_p`); an entry whose argtypes end otherwise (the `_smem` and
    `_splits` queries) returns a number and launches nothing."""
    rule = "NFP004"

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self._envs: dict[int, dict[str, ast.AST]] = {}
        self._checkers: dict[int, set[str]] = {}
        self._allocators: dict[int, set[str]] = {}

    def run(self) -> list[Finding]:
        out: list[Finding] = []
        for qual in sorted(self.graph.funcs):
            out.extend(self._scan(self.graph.funcs[qual]))
        return out

    def _helpers(self, mod: Module) -> tuple[set[str], set[str]]:
        """Module functions that check their arguments with
        `_common.expect`, and those that return a fresh allocation (or
        None)."""
        if id(mod) not in self._checkers:
            checkers, allocators = set(), set()
            for node in mod.tree.body:
                if not isinstance(node, FuncDef):
                    continue
                calls = [n for n in _body_nodes(node)
                         if isinstance(n, ast.Call)]
                if any(_target(c, mod).endswith("_common.expect")
                       for c in calls):
                    checkers.add(node.name)
                rets = [n.value for n in _body_nodes(node)
                        if isinstance(n, ast.Return)]
                if rets and all(
                        r is None
                        or (isinstance(r, ast.Constant) and r.value is None)
                        or (isinstance(r, ast.Call) and self._is_alloc(r, mod))
                        for r in rets) and any(r is not None for r in rets):
                    allocators.add(node.name)
            self._checkers[id(mod)] = checkers
            self._allocators[id(mod)] = allocators
        return self._checkers[id(mod)], self._allocators[id(mod)]

    @staticmethod
    def _is_alloc(call: ast.Call, mod: Module) -> bool:
        tgt = _target(call, mod)
        return tgt.startswith("torch.") and tgt.split(".")[-1] in _ALLOC

    def _entries(self, fi: FuncInfo) -> dict[str, bool]:
        """Local names bound to `_build.function(...)` entries -> whether
        the entry is a launch."""
        mod = fi.module
        env = self._envs.setdefault(id(mod), _module_env(mod))
        out: dict[str, bool] = {}
        for node in _body_nodes(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and _target(node.value, mod).endswith("_build.function"):
                call = node.value
                types = call.args[2] if len(call.args) > 2 else next(
                    (k.value for k in call.keywords if k.arg == "argtypes"),
                    None)
                last = _last_argtype(types, env)
                out[node.targets[0].id] = last is None \
                    or last.endswith("c_void_p")
        return out

    def _scan(self, fi: FuncInfo) -> list[Finding]:
        entries = {n for n, launch in self._entries(fi).items() if launch}
        if not entries:
            return []
        mod = fi.module
        checkers, allocators = self._helpers(mod)
        out: list[Finding] = []

        def flag(node: ast.AST, msg: str) -> None:
            out.append(Finding(self.rule, mod.rel, node.lineno,
                               node.col_offset, msg, fi.qualname))

        checked: dict[str, int] = {}      # name -> first line it is ok

        def first(name: str, line: int) -> None:
            checked[name] = min(line, checked.get(name, line))

        returns: dict[str, int] = {}      # name -> line it was checked
        for node in _body_nodes(fi.node):
            if isinstance(node, ast.Call):
                tgt = _target(node, mod)
                if tgt.endswith("_common.expect") or _call_name(node) in checkers:
                    for a in node.args:
                        for n in ast.walk(a):
                            if isinstance(n, ast.Name):
                                first(n.id, node.lineno)
                if tgt.endswith("_build.check") and node.args \
                        and isinstance(node.args[0], ast.Name):
                    returns[node.args[0].id] = node.lineno
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and (self._is_alloc(node.value, mod)
                         or _call_name(node.value) in allocators):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        first(t.id, node.lineno)

        streams = {t.id for n in _body_nodes(fi.node)
                   if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                   and _target(n.value, mod).endswith("_common.stream_handle")
                   for t in n.targets if isinstance(t, ast.Name)}
        in_device = self._device_scoped(fi)

        for node in _body_nodes(fi.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in entries):
                continue
            name = node.func.id
            # (a) pointers of checked or allocated tensors only
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "data_ptr":
                    owner = sub.func.value
                    ok = isinstance(owner, ast.Name) \
                        and checked.get(owner.id, node.lineno + 1) < node.lineno
                    if not ok:
                        flag(sub, f"launch `{name}` passes "
                                  f"`{unparse_short(sub)}` of a tensor no "
                                  f"`_common.expect` checked and this function "
                                  f"did not allocate")
            # (b) return code checked
            err = self._result_name(fi, node)
            if err is None or err not in returns:
                flag(node, f"launch `{name}`'s return code never reaches "
                           f"`_build.check`: a failed launch goes unseen")
            # (c) stream from _common.stream_handle
            stream = node.args[-1] if node.args else None
            if not (isinstance(stream, ast.Call)
                    and _target(stream, mod).endswith("_common.stream_handle")
                    or isinstance(stream, ast.Name) and stream.id in streams):
                flag(stream or node,
                     f"launch `{name}`'s stream is "
                     f"`{unparse_short(stream) if stream else 'missing'}`, "
                     f"not `_common.stream_handle(...)`: the legacy stream "
                     f"breaks a graph capture")
            # (d) inside `with torch.cuda.device(...)`
            if id(node) not in in_device:
                flag(node, f"launch `{name}` outside `with "
                           f"torch.cuda.device(...)`: a tensor on another "
                           f"card would launch on the current one")
        return out

    @staticmethod
    def _result_name(fi: FuncInfo, call: ast.Call) -> str | None:
        for node in _body_nodes(fi.node):
            if isinstance(node, ast.Assign) and node.value is call \
                    and isinstance(node.targets[0], ast.Name):
                return node.targets[0].id
        return None

    @staticmethod
    def _device_scoped(fi: FuncInfo) -> set[int]:
        """ids of the nodes inside a `with torch.cuda.device(...)`."""
        out: set[int] = set()
        for node in _body_nodes(fi.node):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(i.context_expr, ast.Call)
                    and _target(i.context_expr, fi.module)
                    == "torch.cuda.device" for i in node.items):
                for st in node.body:
                    out.update(id(n) for n in ast.walk(st))
        return out


DEFAULT_CAPTURED_ROOTS = [
    # the engine's step-key body and the dense-slot decode step's; the
    # step functions they call through an attribute (`self.step_fn`,
    # `StepGraphs(step=...)`) are roots too
    "repro_torch.serving.graphs.StepGraphs._step",
    "repro_torch.launch.steps.DecodeStep._body",
    "repro_torch.models.model.paged_step",
    "repro_torch.serving.shard.sharded_paged_step"]


class CapturedControlFlowRule:
    """NFP005: inside a function a CUDA graph captures (one passed to
    `serving/graphs.py::capture`, directly or through a lambda, or one
    reachable from `DEFAULT_CAPTURED_ROOTS`), Python `if` / `while` /
    `assert` / `int()` / `float()` / `bool()` on a tensor's value reads
    it on the host: on the card that syncs mid-capture (the capture
    fails) or freezes the branch taken at capture into every replay.
    Metadata stays legal and unflagged: `.shape`, `.ndim`, `.dim()`,
    `.dtype`, `.device`, `.numel()`, `.is_cuda` (and the other reads
    in `_STATIC_ATTRS` / `_STATIC_METHODS`), `is (not) None`, `in`."""
    rule = "NFP005"

    _STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                     "is_meta", "layout", "requires_grad"}
    _STATIC_METHODS = {"dim", "numel", "size", "stride", "element_size",
                       "is_contiguous", "data_ptr", "nelement",
                       "is_floating_point", "get_device"}
    _STATIC_CMP = (ast.Is, ast.IsNot, ast.In, ast.NotIn)

    def __init__(self, graph: CallGraph, extra_roots: list[str] | None = None):
        self.graph = graph
        seeds = graph.match_roots(DEFAULT_CAPTURED_ROOTS
                                  + list(extra_roots or []))
        seeds |= self._capture_seeds()
        self.captured = graph.reachable(seeds)

    def _capture_seeds(self) -> set[str]:
        """Functions handed to a `capture(...)` call: by name, or called
        inside a lambda given as its first argument."""
        seeds: set[str] = set()
        for fi in self.graph.funcs.values():
            for node in _body_nodes(fi.node):
                if not (isinstance(node, ast.Call)
                        and _call_name(node) == "capture" and node.args):
                    continue
                fn = node.args[0]
                if isinstance(fn, ast.Lambda):
                    for sub in ast.walk(fn.body):
                        if isinstance(sub, ast.Call):
                            seeds |= self.graph._resolve(sub, fi)
                elif isinstance(fn, ast.Name):
                    seeds.update(c.qualname for c in
                                 self.graph.by_name.get(fn.id, ())
                                 if c.module is fi.module)
        return seeds

    def run(self) -> list[Finding]:
        out: list[Finding] = []
        for qual in sorted(self.captured):
            out.extend(self._scan(self.graph.funcs[qual]))
        return out

    def _scan(self, fi: FuncInfo) -> list[Finding]:
        mod = fi.module
        tensors = tensor_names(fi.node, mod)
        out: list[Finding] = []
        for node in _body_nodes(fi.node):
            if isinstance(node, (ast.If, ast.While)):
                test, kind = node.test, type(node).__name__.lower()
            elif isinstance(node, ast.Assert):
                test, kind = node.test, "assert"
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in ("int", "float", "bool") and node.args:
                test, kind = node.args[0], f"{node.func.id}()"
            else:
                continue
            why = self._value_read(test, mod, tensors)
            if why:
                out.append(Finding(
                    self.rule, mod.rel, node.lineno, node.col_offset,
                    f"`{kind}` on a tensor's value inside a captured body "
                    f"({why}) — use torch.where / masks or hoist the check "
                    f"out of the captured step", fi.qualname))
        return out

    def _value_read(self, test: ast.AST, mod: Module,
                    tensors: set[str]) -> str | None:
        """A test reads a tensor's value when it reads a torch result or
        a name bound from one, other than through metadata."""

        def scan(node: ast.AST, exempt: bool) -> str | None:
            if isinstance(node, ast.Attribute) \
                    and node.attr in self._STATIC_ATTRS:
                return scan(node.value, True)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self._STATIC_METHODS:
                return scan(node.func.value, True)
            if isinstance(node, ast.Compare) \
                    and all(isinstance(op, self._STATIC_CMP)
                            for op in node.ops):
                exempt = True
            if isinstance(node, ast.Call) and not exempt \
                    and is_tensor_call(node, mod):
                return f"`{unparse_short(node)}` is a tensor"
            if isinstance(node, ast.Name) and not exempt \
                    and node.id in tensors:
                return f"`{node.id}` was produced by a torch op"
            for child in ast.iter_child_nodes(node):
                why = scan(child, exempt)
                if why:
                    return why
            return None

        return scan(test, False)
