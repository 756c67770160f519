"""Lightweight project-wide call graph.

Resolution is best-effort and deliberately over-approximate — for a
hot-path reachability analysis a spurious edge only widens the audit
surface (and the suppression/baseline mechanisms absorb noise), while a
missing edge silently exempts code from the rules:

* ``name(...)``            same-module function, else a from-import
* ``self.m(...)``          methods named ``m`` in the same class first,
                           else any project function named ``m``
* ``alias.f(...)``         resolved through the import alias map
                           (``M.paged_step`` with ``import ... as M``)
* ``anything.m(...)``      any project function/method named ``m``
                           (duck-typed attribute calls: ``self.blocks
                           .ensure`` reaches ``BlockManager.ensure``)

Calls inside ``lambda`` bodies are attributed to the enclosing
function; nested ``def``s are their own nodes with an implicit edge
from the encloser (defining a closure that escapes into a CUDA-graph
capture makes it part of the encloser's behavior).
"""

from __future__ import annotations

import ast
import collections
import dataclasses

from repro_torch.analysis.astutil import Module, dotted_path

FuncDef = ast.FunctionDef | ast.AsyncFunctionDef


@dataclasses.dataclass
class FuncInfo:
    qualname: str              # "repro_torch.serving.engine.Engine.step"
    name: str
    module: Module
    node: FuncDef
    cls: str | None            # enclosing class name, if a method


class CallGraph:
    def __init__(self, modules: list[Module]):
        self.modules = modules
        self.funcs: dict[str, FuncInfo] = {}
        self.by_name: dict[str, list[FuncInfo]] = collections.defaultdict(list)
        for mod in modules:
            self._collect(mod)
        self.edges: dict[str, set[str]] = {q: self._edges_of(fi)
                                           for q, fi in self.funcs.items()}

    # -- collection -----------------------------------------------------------
    def _collect(self, mod: Module) -> None:
        def visit(node: ast.AST, prefix: str, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, FuncDef):
                    qual = f"{prefix}.{child.name}"
                    fi = FuncInfo(qual, child.name, mod, child, cls)
                    self.funcs[qual] = fi
                    self.by_name[child.name].append(fi)
                    visit(child, qual, cls)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}.{child.name}", child.name)
                else:
                    visit(child, prefix, cls)
        visit(mod.tree, mod.name, None)

    # -- edges ----------------------------------------------------------------
    def _resolve(self, call: ast.Call, fi: FuncInfo) -> set[str]:
        mod = fi.module
        f = call.func
        out: set[str] = set()
        if isinstance(f, ast.Name):
            local = f"{mod.name}.{f.id}"
            if local in self.funcs:
                return {local}
            imported = mod.from_imports.get(f.id)
            if imported and imported in self.funcs:
                return {imported}
            return out
        if isinstance(f, ast.Attribute):
            # alias.method via the import map
            path = dotted_path(f)
            if path:
                head, _, rest = path.partition(".")
                if rest and head in mod.mod_aliases:
                    cand = f"{mod.mod_aliases[head]}.{rest}"
                    if cand in self.funcs:
                        return {cand}
                    if cand.startswith(("numpy.", "torch.", "time.")):
                        return out       # known-external: don't duck-type
            # self.m -> same-class methods first
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and fi.cls:
                same = [c for c in self.by_name.get(f.attr, ())
                        if c.cls == fi.cls and c.module is mod]
                if same:
                    return {c.qualname for c in same}
            # duck-typed: every project METHOD with this attribute name.
            # Module-level functions are excluded — they are called by
            # name or module alias (both handled above), and matching
            # them here would glue every `eng.run()` to every
            # benchmark's top-level `run()`.
            out.update(c.qualname for c in self.by_name.get(f.attr, ())
                       if c.cls is not None)
        return out

    def _edges_of(self, fi: FuncInfo) -> set[str]:
        targets: set[str] = set()

        def scan(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, FuncDef):
                    # nested def: its own node, implicit edge
                    targets.add(f"{fi.qualname}.{child.name}")
                    continue
                if isinstance(child, ast.Call):
                    targets.update(self._resolve(child, fi))
                scan(child)
        scan(fi.node)
        return targets

    # -- queries --------------------------------------------------------------
    def reachable(self, roots: set[str],
                  stop: set[str] = frozenset()) -> set[str]:
        """Qualnames reachable from `roots` (roots included), never
        entering — or traversing through — `stop` nodes."""
        seen: set[str] = set()
        work = [r for r in roots if r in self.funcs and r not in stop]
        while work:
            q = work.pop()
            if q in seen:
                continue
            seen.add(q)
            work.extend(t for t in self.edges.get(q, ())
                        if t not in seen and t not in stop)
        return seen

    def match_roots(self, patterns: list[str]) -> set[str]:
        """Resolve root specs: exact qualname, or suffix match (so
        "Engine.step" works without the full module path)."""
        out: set[str] = set()
        for pat in patterns:
            if pat in self.funcs:
                out.add(pat)
                continue
            out.update(q for q in self.funcs
                       if q.endswith("." + pat) or q == pat)
        return out
