"""NFP001–NFP003: hot-path host syncs, use after replay, graph keys.

All three rules are syntactic over-approximations tuned to the port's
discipline (`serving/engine.py`'s docstring: one host sync a step, one
CUDA graph a step key): they cannot prove a value lives on the card, so
they flag the patterns that are only correct when it doesn't, and the
`# nfp: ignore[...]` / baseline mechanisms record the audited
exceptions.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib

from repro_torch.analysis.astutil import (Module, dotted_path,
                                          resolve_call_target, unparse_short)
from repro_torch.analysis.callgraph import CallGraph, FuncDef, FuncInfo


@dataclasses.dataclass
class Finding:
    rule: str
    path: str                  # repo-relative
    line: int
    col: int
    message: str
    symbol: str                # enclosing function qualname (or "<module>")
    suppressed: bool = False
    suppress_reason: str = ""
    baselined: bool = False

    @property
    def active(self) -> bool:
        return not (self.suppressed or self.baselined)

    def key(self) -> str:
        """Line-independent identity for the baseline file: a finding
        keeps its key when unrelated edits shift it up or down."""
        raw = f"{self.rule}|{self.path}|{self.symbol}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message, "key": self.key(),
                "suppressed": self.suppressed,
                "suppress_reason": self.suppress_reason,
                "baselined": self.baselined}


def _body_nodes(fn: FuncDef):
    """Walk a function body without descending into nested defs (they
    are separate call-graph nodes) — lambdas ARE descended (they belong
    to the enclosing function)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, FuncDef) or isinstance(node, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _call_name(call: ast.Call) -> str:
    """The called name: `f(...)` -> "f", `a.b.f(...)` -> "f"."""
    f = call.func
    return f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else ""


# torch functions whose result is a host value (a bool, a dtype, a
# device, a shape), not a tensor
_HOST_VALUED = ("torch.is_", "torch.cuda.", "torch.backends.",
                "torch.finfo", "torch.iinfo", "torch.device", "torch.Size",
                "torch.dtype", "torch.promote_types", "torch.result_type",
                "torch.can_cast", "torch.get_", "torch.compiler.")


def is_tensor_call(call: ast.Call, mod: Module) -> bool:
    """A `torch.*` call that returns a tensor (not a host value)."""
    tgt = resolve_call_target(call, mod) or ""
    return tgt.startswith("torch.") and not tgt.startswith(_HOST_VALUED)


def tensor_names(fn: FuncDef, mod: Module) -> set[str]:
    """Local names assigned from a `torch.*` tensor call in this
    function — proxies for 'this value is a tensor, maybe on the card'."""
    out: set[str] = set()
    for node in _body_nodes(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and is_tensor_call(node.value, mod):
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
    return out


# =============================================================================
# NFP001: host sync reachable from a hot root
# =============================================================================

_SYNC_ATTRS = {"item", "tolist", "cpu", "synchronize"}
_HOST_SAFE = (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.ListComp,
              ast.GeneratorExp, ast.DictComp, ast.SetComp)

DEFAULT_HOT_ROOTS = ["repro_torch.serving.engine.Engine.step",
                     "repro_torch.models.model.paged_step",
                     # mesh-mode dispatch and the device-table mirror:
                     # both sit on every sharded step
                     "repro_torch.serving.shard.sharded_paged_step",
                     "repro_torch.serving.kvcache.BlockManager.device_tables",
                     # the draft proposer and the adaptive-K policy run
                     # every speculative step: pure bookkeeping
                     "repro_torch.serving.speculate.NgramProposer.propose",
                     "repro_torch.core.policy.AdaptiveKController.decide",
                     # tiered-KV scheduling inside every step: the spill
                     # capture's wait is the one sanctioned aux sync
                     # (inline ignore), the restore drain is upload +
                     # scatter + bookkeeping
                     "repro_torch.serving.engine.Engine._flush_spills",
                     "repro_torch.serving.engine.Engine._drain_restores",
                     # the router steps every replica from one host loop,
                     # and a failover drain runs while survivors serve
                     "repro_torch.serving.router.Router.step",
                     "repro_torch.serving.engine.Engine.drain_requests"]


def _host_safe_arg(arg: ast.AST, mod: Module) -> bool:
    """np.asarray on literals/comprehensions or numpy-produced values is
    host-side staging, not a device sync."""
    if isinstance(arg, _HOST_SAFE):
        return True
    if isinstance(arg, ast.Call):
        tgt = resolve_call_target(arg, mod) or ""
        return tgt.startswith("numpy.")
    return False


def _to_cpu(call: ast.Call) -> bool:
    """`.to("cpu")` / `.to(device="cpu")`."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu" for v in vals)


class HostSyncRule:
    """NFP001: the engine syncs device results exactly once per step, in
    the declared `# nfp: sync-point` function. Any other device->host
    pull reachable from a hot root stalls the host until the card has
    drained its queue. `.numpy()` is not flagged: on a CUDA tensor it
    raises, so it cannot sync unseen."""
    rule = "NFP001"

    def __init__(self, graph: CallGraph, extra_roots: list[str] | None = None):
        self.graph = graph
        roots = list(DEFAULT_HOT_ROOTS) + list(extra_roots or [])
        for fi in graph.funcs.values():
            if fi.module.marker_for_def(fi.node, "hot-path"):
                roots.append(fi.qualname)
        self.sync_points = {fi.qualname for fi in graph.funcs.values()
                            if fi.module.marker_for_def(fi.node, "sync-point")}
        self.roots = graph.match_roots(roots)
        self.hot = graph.reachable(self.roots, stop=self.sync_points)

    def run(self) -> list[Finding]:
        findings: list[Finding] = []
        for qual in sorted(self.hot):
            findings.extend(self._scan(self.graph.funcs[qual]))
        return findings

    def _project_call_in(self, node: ast.AST, fi: FuncInfo) -> bool:
        """Does the subtree call into project code (which, on a hot
        path, returns device values)?"""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and self.graph._resolve(sub, fi):
                return True
        return False

    def _scan(self, fi: FuncInfo) -> list[Finding]:
        mod = fi.module
        tensors = tensor_names(fi.node, mod)
        out: list[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            out.append(Finding(self.rule, mod.rel, node.lineno,
                               node.col_offset,
                               f"host sync in hot path: {what}",
                               fi.qualname))

        for node in _body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            tgt = resolve_call_target(node, mod) or ""
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_ATTRS:
                what = "waits for the card" \
                    if node.func.attr == "synchronize" \
                    else "forces a device->host transfer"
                flag(node, f"`.{node.func.attr}()` {what} "
                           f"({unparse_short(node)})")
            elif _to_cpu(node):
                flag(node, f"`{unparse_short(node)}` forces a device->host "
                           f"transfer")
            elif tgt in ("numpy.asarray", "numpy.array"):
                if node.args and not _host_safe_arg(node.args[0], mod):
                    flag(node, f"`{unparse_short(node)}` pulls a (possibly "
                               f"device) value to host")
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in ("int", "float", "bool") and node.args:
                names = {n.id for n in ast.walk(node.args[0])
                         if isinstance(n, ast.Name)}
                if names & tensors:
                    flag(node, f"`{unparse_short(node)}` scalarizes a "
                               f"tensor")
                elif self._project_call_in(node.args[0], fi):
                    flag(node, f"`{unparse_short(node)}` scalarizes a "
                               f"project-call result (device value on "
                               f"this path)")
        return out


# =============================================================================
# NFP002: use after replay
# =============================================================================

# tensor methods whose result shares the receiver's storage
_VIEW_METHODS = {"view", "reshape", "transpose", "t", "narrow", "squeeze",
                 "unsqueeze", "flatten", "expand", "permute", "as_strided",
                 "detach", "select", "diagonal", "view_as", "numpy",
                 "unflatten", "movedim", "swapaxes", "split", "chunk",
                 "unbind"}
_CONTAINER_ADDS = {"append", "extend", "insert", "add"}


class _Runners:
    """Where the graph runners live, project-wide.

    A runner is a function that replays a captured graph (it calls a
    function or method named `replay`) and returns the graph's static
    output; the port's are `StepGraphs.run` and `DecodeStep.__call__`.
    `static` maps a runner to the positions of its returned tuple that
    are static buffers (None: the whole value): an element that is a
    bare parameter is the caller's own object handed back (the caches of
    `DecodeStep`), not a buffer. A class whose `__call__` is a runner
    makes its instances runners; a factory returns such an instance."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.static: dict[str, tuple[int, ...] | None] = {}
        for qual, fi in graph.funcs.items():
            pos = self._runner_positions(fi)
            if pos is not False:
                self.static[qual] = pos
        self.classes = {fi.cls for q, fi in graph.funcs.items()
                        if q in self.static and fi.name == "__call__"}
        self.factories = {fi.name for fi in graph.funcs.values()
                          if self._returns_runner_instance(fi)}

    @staticmethod
    def _runner_positions(fi: FuncInfo):
        replays = any(isinstance(n, ast.Call) and _call_name(n) == "replay"
                      for n in _body_nodes(fi.node))
        rets = [n.value for n in _body_nodes(fi.node)
                if isinstance(n, ast.Return) and n.value is not None]
        if not (replays and rets):
            return False
        params = {a.arg for a in fi.node.args.args}
        if all(isinstance(r, ast.Tuple) for r in rets):
            return tuple(sorted({i for r in rets for i, e in enumerate(r.elts)
                                 if not (isinstance(e, ast.Name)
                                         and e.id in params)}))
        return None

    def _returns_runner_instance(self, fi: FuncInfo) -> bool:
        return any(isinstance(n, ast.Return) and isinstance(n.value, ast.Call)
                   and _call_name(n.value) in self.classes
                   for n in _body_nodes(fi.node))

    def is_constructor(self, call: ast.Call) -> bool:
        name = _call_name(call)
        return name in self.classes or name in self.factories

    def bindings(self, mod: Module) -> set[str]:
        """Dotted paths this module binds to runner instances
        (`step = make_decode_step(cfg)`, `self.step = DecodeStep(...)`)."""
        out: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and self.is_constructor(node.value):
                for t in node.targets:
                    p = dotted_path(t)
                    if p:
                        out.add(p)
        return out


class ReplayRule:
    """NFP002: a graph runner returns its graph's static output buffer,
    which the same runner's next call overwrites in place. A read of that
    tensor (or of a view of it, or of a container it was put in) after a
    later call of the same runner reads the later step's values. Copy it
    out first (`.clone()`, `copy_` into a buffer of your own).

    Intraprocedural dataflow, as the JAX package's donation rule: `if`
    branches merge, loop bodies run twice (the second pass catches an
    output of iteration N-1 read after the call of iteration N)."""
    rule = "NFP002"

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.runners = _Runners(graph)
        self._bindings: dict[int, set[str]] = {}

    def run(self) -> list[Finding]:
        findings: list[Finding] = []
        for qual in sorted(self.graph.funcs):
            findings.extend(self._scan(self.graph.funcs[qual]))
        return findings

    def _runner_id(self, call: ast.Call, fi: FuncInfo) -> str | None:
        """Identity of the runner object a call runs, or None."""
        f = call.func
        mod = fi.module
        binds = self._bindings.get(id(mod))
        if binds is None:
            binds = self._bindings[id(mod)] = self.runners.bindings(mod)
        path = dotted_path(f)
        if path in binds:
            return path
        if isinstance(f, ast.Name) and f.id == "self" \
                and fi.cls in self.runners.classes:
            return "self"
        if isinstance(f, ast.Attribute):
            targets = self.graph._resolve(call, fi)
            if any(t in self.runners.static
                   and self.graph.funcs[t].name != "__call__"
                   for t in targets):
                return path or unparse_short(f)
        return None

    def _static_positions(self, call: ast.Call, fi: FuncInfo):
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr != "__call__":
            pos = [self.runners.static[t]
                   for t in self.graph._resolve(call, fi)
                   if t in self.runners.static]
        else:
            pos = [p for q, p in self.runners.static.items()
                   if self.graph.funcs[q].name == "__call__"]
        return pos[0] if len(pos) == 1 else None

    def _scan(self, fi: FuncInfo) -> list[Finding]:
        found: dict[tuple[int, str], Finding] = {}
        # path -> runner id (live outputs); path -> (runner id, line of
        # the later call) (stale outputs)
        State = tuple[dict[str, str], dict[str, tuple[str, int]]]

        def report(node: ast.AST, path: str, runner: str, line: int) -> None:
            k = (node.lineno, path)
            if k not in found:
                found[k] = Finding(
                    self.rule, fi.module.rel, node.lineno, node.col_offset,
                    f"`{path}` holds the static output of `{runner}`, "
                    f"overwritten by its call on line {line}; clone it "
                    f"before that call", fi.qualname)

        def check_uses(expr: ast.AST, st: State) -> None:
            live, stale = st
            for node in ast.walk(expr):
                if isinstance(node, (ast.Name, ast.Attribute)) \
                        and isinstance(getattr(node, "ctx", None), ast.Load):
                    p = dotted_path(node)
                    if p in stale:
                        report(node, p, *stale[p])

        def apply_runs(expr: ast.AST, st: State) -> None:
            live, stale = st
            for node in ast.walk(expr):
                if not isinstance(node, ast.Call):
                    continue
                rid = self._runner_id(node, fi)
                if rid is None:
                    continue
                for p, r in list(live.items()):
                    if r == rid:
                        stale[p] = (rid, node.lineno)
                        del live[p]

        def source(expr: ast.AST, st: State) -> str | None:
            """The runner whose static output `expr` evaluates to (a
            runner call, or an alias or view of a live output)."""
            live, stale = st
            if isinstance(expr, ast.Call):
                rid = self._runner_id(expr, fi)
                if rid is not None:
                    return rid
                f = expr.func
                if isinstance(f, ast.Attribute) and f.attr in _VIEW_METHODS:
                    return source(f.value, st)
                return None
            if isinstance(expr, (ast.Subscript, ast.Starred)):
                return source(expr.value, st)
            p = dotted_path(expr)
            if p in live:
                return live[p]
            if p in stale:
                return stale[p][0]
            return None

        def clear_target(tgt: ast.AST, st: State) -> None:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            for e in elts:
                if isinstance(e, ast.Starred):
                    e = e.value
                p = dotted_path(e)
                if p:
                    st[0].pop(p, None)
                    st[1].pop(p, None)

        def bind(tgt: ast.AST, value: ast.AST, st: State) -> None:
            live = st[0]
            if isinstance(value, ast.Call) \
                    and self._runner_id(value, fi) is not None:
                rid = self._runner_id(value, fi)
                pos = self._static_positions(value, fi)
                if isinstance(tgt, (ast.Tuple, ast.List)) and pos is not None:
                    elts = [e for i, e in enumerate(tgt.elts) if i in pos]
                else:
                    elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                        else [tgt]
                for e in elts:
                    p = dotted_path(e)
                    if p:
                        live[p] = rid
                return
            rid = source(value, st)
            if rid is not None and not isinstance(tgt, (ast.Tuple, ast.List)):
                p = dotted_path(tgt)
                if p:
                    live[p] = rid

        def store_in_container(expr: ast.AST, st: State) -> None:
            """`c.append(out)` / `c[i] = out`: the container now holds a
            static output; a container once stale stays stale until it
            is rebound."""
            if not (isinstance(expr, ast.Call)
                    and isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in _CONTAINER_ADDS and expr.args):
                return
            rid = source(expr.args[0], st)
            c = dotted_path(expr.func.value)
            if rid is not None and c and c not in st[1]:
                st[0][c] = rid

        def exec_expr(expr: ast.AST | None, st: State) -> None:
            if expr is None:
                return
            check_uses(expr, st)
            apply_runs(expr, st)

        def exec_block(stmts, st: State) -> None:
            for s in stmts:
                exec_stmt(s, st)

        def copy(st: State) -> State:
            return dict(st[0]), dict(st[1])

        def merge_into(st: State, a: State, b: State) -> None:
            stale = {**a[1], **b[1]}
            live = {p: r for p, r in {**a[0], **b[0]}.items()
                    if p not in stale}
            st[0].clear()
            st[0].update(live)
            st[1].clear()
            st[1].update(stale)

        def exec_stmt(s: ast.stmt, st: State) -> None:
            if isinstance(s, (FuncDef, ast.ClassDef)):
                return
            if isinstance(s, (ast.Assign, ast.AnnAssign)):
                exec_expr(s.value, st)
                tgts = s.targets if isinstance(s, ast.Assign) else [s.target]
                for t in tgts:
                    if isinstance(t, ast.Subscript):
                        check_uses(t.value, st)
                        c = dotted_path(t.value)
                        if c and s.value is not None \
                                and source(s.value, st) and c not in st[1]:
                            st[0][c] = source(s.value, st)
                        continue
                    clear_target(t, st)
                    if s.value is not None:
                        bind(t, s.value, st)
            elif isinstance(s, ast.AugAssign):
                exec_expr(s.value, st)
                check_uses(s.target, st)
            elif isinstance(s, ast.Expr):
                exec_expr(s.value, st)
                store_in_container(s.value, st)
            elif isinstance(s, ast.If):
                exec_expr(s.test, st)
                b1, b2 = copy(st), copy(st)
                exec_block(s.body, b1)
                exec_block(s.orelse, b2)
                merge_into(st, b1, b2)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                exec_expr(s.iter, st)
                clear_target(s.target, st)
                exec_block(s.body, st)
                clear_target(s.target, st)
                exec_block(s.body, st)
                exec_block(s.orelse, st)
            elif isinstance(s, ast.While):
                exec_expr(s.test, st)
                exec_block(s.body, st)
                exec_expr(s.test, st)
                exec_block(s.body, st)
                exec_block(s.orelse, st)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    exec_expr(item.context_expr, st)
                    if item.optional_vars is not None:
                        clear_target(item.optional_vars, st)
                exec_block(s.body, st)
            elif isinstance(s, ast.Try):
                exec_block(s.body, st)
                for h in s.handlers:
                    exec_block(h.body, st)
                exec_block(s.orelse, st)
                exec_block(s.finalbody, st)
            elif isinstance(s, ast.Delete):
                for t in s.targets:
                    clear_target(t, st)
            else:
                for val in ast.iter_child_nodes(s):
                    if isinstance(val, ast.expr):
                        exec_expr(val, st)

        exec_block(fi.node.body, ({}, {}))
        return [found[k] for k in sorted(found)]


# =============================================================================
# NFP003: unbounded graph key
# =============================================================================

_BUCKET_HELPERS = ("bucket", "pow2", "cdiv")


def _is_bucket_call(call: ast.Call) -> bool:
    return any(h in _call_name(call).lower() for h in _BUCKET_HELPERS)


def _graph_entry_classes(graph: CallGraph) -> set[str]:
    """Classes with a field annotated as a `torch.cuda.CUDAGraph`: the
    per-key entries a graph cache stores (`_Step`, `_Key`)."""
    out: set[str] = set()
    for mod in graph.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and any(
                    isinstance(s, ast.AnnAssign)
                    and "CUDAGraph" in ast.unparse(s.annotation)
                    for s in node.body):
                out.add(node.name)
    return out


def _params(fi: FuncInfo) -> list[str]:
    return [a.arg for a in fi.node.args.args if a.arg != "self"]


class GraphKeyRule:
    """NFP003: a graph cache stores, under a key built from its
    parameters, an entry that gets a captured `torch.cuda.CUDAGraph`; it
    must be fed keys of bounded cardinality. A raw length or count in
    the key captures one graph (and keeps one set of static buffers and
    its share of the graph pool) per distinct value. Keys must come from
    a pow2/bucket helper or be constants.

    The caches are found structurally (`container[key] = Entry(...)`
    where `Entry` has a CUDAGraph field, or `= torch.cuda.CUDAGraph()`);
    a function that indexes a cache's container with its own parameter,
    or passes that parameter on as another cache function's key, is
    reached the same way (`StepGraphs.inputs`, `upload`, `run`, `capture`
    reach `StepGraphs._entry`)."""
    rule = "NFP003"

    def __init__(self, graph: CallGraph):
        self.graph = graph
        entries = _graph_entry_classes(graph)
        # qualname -> (key parameter, the cache function it reaches)
        self.caches: dict[str, tuple[str, str]] = {}
        containers: dict[tuple[int, str | None, str], str] = {}
        for qual, fi in graph.funcs.items():
            hit = self._stores_entry(fi, entries)
            if hit:
                param, container = hit
                self.caches[qual] = (param, qual)
                containers[(id(fi.module), fi.cls, container)] = qual
        changed = True
        while changed:
            changed = False
            for qual, fi in graph.funcs.items():
                if qual in self.caches:
                    continue
                hit = self._reaches(fi, containers)
                if hit:
                    self.caches[qual] = hit
                    changed = True

    def _stores_entry(self, fi: FuncInfo, entries: set[str]):
        pnames = _params(fi)
        if not pnames:
            return None
        env: dict[str, list[ast.AST]] = {}
        for node in _body_nodes(fi.node):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.targets[0], ast.Name):
                env.setdefault(node.targets[0].id, []).append(node.value)
        for node in _body_nodes(fi.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.targets[0], ast.Subscript)):
                continue
            vals = [node.value]
            if isinstance(node.value, ast.Name):
                vals = env.get(node.value.id, [])
            if not any(isinstance(v, ast.Call)
                       and (_call_name(v) in entries
                            or (resolve_call_target(v, fi.module) or "")
                            == "torch.cuda.CUDAGraph") for v in vals):
                continue
            key = node.targets[0].slice
            keys = [key]
            if isinstance(key, ast.Name) and key.id in env:
                keys += env[key.id]
            for k in keys:
                elts = k.elts if isinstance(k, ast.Tuple) else [k]
                used = [e.id for e in elts
                        if isinstance(e, ast.Name) and e.id in pnames]
                if used:
                    return used[0], dotted_path(node.targets[0].value)
        return None

    def _reaches(self, fi: FuncInfo, containers):
        """(key parameter, cache) when `fi` indexes a cache's container
        with its own parameter or passes one to a cache function."""
        pnames = _params(fi)
        for node in _body_nodes(fi.node):
            idx = None
            if isinstance(node, ast.Subscript):
                idx, cont = node.slice, dotted_path(node.value)
            elif isinstance(node, ast.Call) and _call_name(node) == "get" \
                    and isinstance(node.func, ast.Attribute) and node.args:
                idx, cont = node.args[0], dotted_path(node.func.value)
            if isinstance(idx, ast.Name) and idx.id in pnames:
                cache = containers.get((id(fi.module), fi.cls, cont))
                if cache:
                    return idx.id, cache
            if isinstance(node, ast.Call):
                hit = self._cache_call(node, fi)
                if hit:
                    arg, _pname, cache = hit
                    if isinstance(arg, ast.Name) and arg.id in pnames:
                        return arg.id, cache
        return None

    def _cache_call(self, call: ast.Call, caller: FuncInfo):
        """(key argument, key parameter, cache) of a call into a graph
        cache, or None."""
        for target in self.graph._resolve(call, caller):
            if target not in self.caches:
                continue
            pname, cache = self.caches[target]
            pos = _params(self.graph.funcs[target]).index(pname)
            arg = call.args[pos] if pos < len(call.args) else next(
                (k.value for k in call.keywords if k.arg == pname), None)
            if arg is not None:
                return arg, pname, cache
        return None

    def run(self) -> list[Finding]:
        findings: list[Finding] = []
        for qual in sorted(self.graph.funcs):
            caller = self.graph.funcs[qual]
            seen: set[tuple[int, int]] = set()
            for node in sorted((n for n in _body_nodes(caller.node)
                                if isinstance(n, ast.Call)),
                               key=lambda n: (n.lineno, n.col_offset)):
                findings.extend(self._check_call(node, caller, seen))
        return findings

    def _check_call(self, call: ast.Call, caller: FuncInfo,
                    seen: set) -> list[Finding]:
        hit = self._cache_call(call, caller)
        if hit is None:
            return []
        arg, pname, cache = hit
        assigns: dict[str, list[ast.AST]] = {}
        for node in _body_nodes(caller.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigns.setdefault(t.id, []).append(node.value)
        out = []
        for elt in self._key_elements(arg, assigns):
            if (elt.lineno, elt.col_offset) in seen:
                continue
            if self._classify(elt, caller, assigns, depth=0) == "raw":
                seen.add((elt.lineno, elt.col_offset))
                name = ".".join(cache.split(".")[-2:]) \
                    if self.graph.funcs[cache].cls else cache.split(".")[-1]
                out.append(Finding(
                    self.rule, caller.module.rel, elt.lineno, elt.col_offset,
                    f"graph cache `{name}` keyed on raw value "
                    f"`{unparse_short(elt)}` (param `{pname}`) — derive it "
                    f"from a pow2/bucket helper or the cache grows per "
                    f"distinct value", caller.qualname))
        return out

    @staticmethod
    def _key_elements(arg: ast.AST, assigns) -> list[ast.AST]:
        """The elements of the key tuple(s) an argument may hold."""
        work, out, depth = [arg], [], 0
        while work and depth < 16:
            depth += 1
            e = work.pop()
            if isinstance(e, ast.Name) and e.id in assigns:
                work.extend(assigns[e.id])
            elif isinstance(e, ast.IfExp):
                work += [e.body, e.orelse]
            elif isinstance(e, ast.Tuple):
                out.extend(e.elts)
            else:
                out.append(e)
        return out

    def _classify(self, expr: ast.AST, caller: FuncInfo,
                  assigns: dict[str, list[ast.AST]], depth: int) -> str:
        """'ok' (bounded), 'raw' (provably unbounded), 'unknown'."""
        if depth > 4:
            return "unknown"
        if isinstance(expr, ast.Constant):
            return "ok"
        if isinstance(expr, ast.Call):
            if _is_bucket_call(expr):
                return "ok"
            name = expr.func.id if isinstance(expr.func, ast.Name) else ""
            if name in ("len", "max", "min", "sum"):
                return "raw"
            return "unknown"
        if isinstance(expr, ast.BinOp):
            return "raw"
        if isinstance(expr, ast.IfExp):
            kinds = {self._classify(e, caller, assigns, depth + 1)
                     for e in (expr.body, expr.orelse)}
            return "raw" if "raw" in kinds else \
                "ok" if kinds == {"ok"} else "unknown"
        if isinstance(expr, ast.Name):
            for a in caller.node.args.args:
                if a.arg == expr.id:
                    ann = a.annotation
                    if isinstance(ann, ast.Name) and ann.id == "int":
                        return "raw"
                    return "unknown"
            kinds = {self._classify(v, caller, assigns, depth + 1)
                     for v in assigns.get(expr.id, ())}
            if "raw" in kinds:
                return "raw"
            if kinds == {"ok"}:
                return "ok"
            return "unknown"
        return "unknown"
