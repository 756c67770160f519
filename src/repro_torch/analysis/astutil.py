"""Parsing layer: modules, import aliases, and `# nfp:` directives.

Everything downstream works on `Module` objects — a parsed tree plus
the module's dotted name (so hot roots like
``repro_torch.serving.engine.Engine.step`` resolve), its import alias
maps (so ``np.asarray`` is recognized whatever numpy was imported as),
and its directive comments. The directive grammar and the rule ids are
the JAX package's linter's, so one comment reads the same to both.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

RULE_IDS = ("NFP001", "NFP002", "NFP003", "NFP004", "NFP005")

# `# nfp: ignore[NFP001,NFP002] reason` | `# nfp: hot-path` | `# nfp: sync-point`
_DIRECTIVE_RE = re.compile(
    r"#\s*nfp:\s*(?:ignore\[(?P<rules>[^\]]*)\](?P<reason>.*)"
    r"|(?P<marker>hot-path|sync-point)\b.*)")


@dataclasses.dataclass
class Directive:
    line: int                  # 1-based line the comment sits on
    kind: str                  # "ignore" | "hot-path" | "sync-point"
    rules: tuple[str, ...]     # for "ignore": rule ids it suppresses
    reason: str
    standalone: bool           # comment-only line: applies to the NEXT line
    valid: bool = True
    error: str = ""


def parse_directives(lines: list[str]) -> list[Directive]:
    out = []
    for i, raw in enumerate(lines, start=1):
        m = _DIRECTIVE_RE.search(raw)
        if not m:
            if re.search(r"#\s*nfp:", raw):
                out.append(Directive(i, "ignore", (), "", False, valid=False,
                                     error="unrecognized `# nfp:` directive"))
            continue
        standalone = raw.lstrip().startswith("#")
        if m.group("marker"):
            out.append(Directive(i, m.group("marker"), (), "", standalone))
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        reason = (m.group("reason") or "").strip()
        bad = [r for r in rules if r not in RULE_IDS]
        if bad:
            out.append(Directive(i, "ignore", rules, reason, standalone,
                                 valid=False,
                                 error=f"unknown rule id(s): {', '.join(bad)}"))
        elif not rules:
            out.append(Directive(i, "ignore", rules, reason, standalone,
                                 valid=False,
                                 error="ignore directive lists no rule ids"))
        elif not reason:
            out.append(Directive(i, "ignore", rules, reason, standalone,
                                 valid=False,
                                 error="ignore directive requires a reason"))
        else:
            out.append(Directive(i, "ignore", rules, reason, standalone))
    return out


@dataclasses.dataclass
class Module:
    path: Path
    rel: str                       # repo-relative posix path (reports)
    name: str                      # dotted module name, best effort
    tree: ast.Module
    lines: list[str]
    directives: list[Directive]
    mod_aliases: dict[str, str]    # "np" -> "numpy", "M" -> "repro_torch.models.model"
    from_imports: dict[str, str]   # "_build" -> "repro_torch.kernels._build"

    def ignore_at(self, line: int) -> list[Directive]:
        """Ignore directives governing `line`: same-line trailing comment
        or a standalone directive on the line directly above."""
        hits = []
        for d in self.directives:
            if d.kind != "ignore" or not d.valid:
                continue
            if d.line == line or (d.standalone and d.line == line - 1):
                hits.append(d)
        return hits

    def marker_for_def(self, node: ast.AST, kind: str) -> bool:
        """Is a `hot-path`/`sync-point` marker attached to this def (on
        the def line, or standalone directly above the def/decorators)?"""
        first = min([node.lineno]
                    + [d.lineno for d in getattr(node, "decorator_list", [])])
        for d in self.directives:
            if d.kind != kind:
                continue
            if d.line == node.lineno or (d.standalone and d.line == first - 1):
                return True
        return False


def module_name_for(path: Path, repo_root: Path) -> str:
    try:
        rel = path.resolve().relative_to(repo_root.resolve())
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_imports(tree: ast.Module) -> tuple[dict[str, str], dict[str, str]]:
    mod_aliases: dict[str, str] = {}
    from_imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                # `import torch.utils.checkpoint` binds `torch` to the
                # package itself; only `import a.b as x` binds `a.b`
                if a.asname:
                    mod_aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    mod_aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                full = f"{node.module}.{a.name}"
                local = a.asname or a.name
                from_imports[local] = full
                # `from repro_torch.kernels import _build`: _build.* calls
                # resolve like a module alias
                mod_aliases.setdefault(local, full)
    return mod_aliases, from_imports


def load_module(path: Path, repo_root: Path) -> Module:
    src = path.read_text()
    tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()
    mod_aliases, from_imports = _collect_imports(tree)
    try:
        rel = path.resolve().relative_to(repo_root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return Module(path=path, rel=rel,
                  name=module_name_for(path, repo_root), tree=tree,
                  lines=lines, directives=parse_directives(lines),
                  mod_aliases=mod_aliases, from_imports=from_imports)


# -- small AST helpers shared by the rules -----------------------------------

def dotted_path(node: ast.AST) -> str | None:
    """`self.caches` -> "self.caches", `a.b.c` -> "a.b.c", Name -> id;
    anything else (calls, subscripts) -> None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call_target(node: ast.Call, mod: Module) -> str | None:
    """Best-effort fully-qualified name of a call's target: resolves
    module aliases (`np.asarray` -> "numpy.asarray", `M.paged_step` ->
    "repro_torch.models.model.paged_step") and from-imports."""
    f = node.func
    if isinstance(f, ast.Name):
        return mod.from_imports.get(f.id, f.id)
    path = dotted_path(f)
    if path is None:
        return None
    head, _, rest = path.partition(".")
    if head in mod.mod_aliases and rest:
        return f"{mod.mod_aliases[head]}.{rest}"
    return path


def unparse_short(node: ast.AST, limit: int = 48) -> str:
    try:
        s = ast.unparse(node)
    except Exception:
        s = f"<{type(node).__name__}>"
    s = " ".join(s.split())
    return s if len(s) <= limit else s[: limit - 1] + "…"

