"""`repro-lint` for the PyTorch port.

    python -m repro_torch.analysis.cli [paths...] [--baseline FILE]
        [--update-baseline] [--json FILE] [--root QUALNAME]... [--verbose]

Stdlib-only (`ast`): it never imports the code it scans, so it runs
without torch. Exit status 1 iff any finding is active (neither
suppressed inline nor recorded in the baseline), or a directive comment
is malformed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import baseline as baseline_mod, report
from repro_torch.analysis.astutil import Module, load_module
from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.cuda_rules import (CapturedControlFlowRule,
                                             KernelLaunchRule)
from repro_torch.analysis.rules import (Finding, GraphKeyRule, HostSyncRule,
                                        ReplayRule)

DEFAULT_SCAN = ("src/repro_torch", "examples_torch")
DEFAULT_BASELINE = "nfp-torch-baseline.json"
# the analyzer audits the port, not itself (its own strings would
# otherwise trip the pattern matchers)
_SELF = "src/repro_torch/analysis"


def _iter_files(paths: list[Path], repo_root: Path) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    out = []
    for f in files:
        try:
            rel = f.resolve().relative_to(repo_root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        if not rel.startswith(_SELF):
            out.append(f)
    return out


def _apply_suppressions(findings: list[Finding],
                        modules: dict[str, Module]) -> None:
    for f in findings:
        mod = modules.get(f.path)
        if mod is None:
            continue
        for d in mod.ignore_at(f.line):
            if f.rule in d.rules:
                f.suppressed = True
                f.suppress_reason = d.reason
                break


def _directive_findings(modules: dict[str, Module]) -> list[Finding]:
    out = []
    for mod in modules.values():
        for d in mod.directives:
            if not d.valid:
                out.append(Finding("NFP000", mod.rel, d.line, 0,
                                   f"malformed directive: {d.error}",
                                   "<module>"))
    return out


def run_analysis(paths: list[Path], repo_root: Path,
                 extra_roots: list[str] | None = None,
                 ) -> tuple[list[Finding], dict[str, Module]]:
    """Parse, build the call graph, run every rule, apply suppressions.
    Returns (findings, modules-by-relpath); baselining is the caller's
    second pass (the baseline file is optional)."""
    modules: dict[str, Module] = {}
    for f in _iter_files(paths, repo_root):
        try:
            mod = load_module(f, repo_root)
        except SyntaxError as e:
            raise SystemExit(f"repro-lint: cannot parse {f}: {e}")
        modules[mod.rel] = mod
    graph = CallGraph(list(modules.values()))
    findings: list[Finding] = []
    findings.extend(HostSyncRule(graph, extra_roots).run())
    findings.extend(ReplayRule(graph).run())
    findings.extend(GraphKeyRule(graph).run())
    findings.extend(KernelLaunchRule(graph).run())
    findings.extend(CapturedControlFlowRule(graph).run())
    findings.extend(_directive_findings(modules))
    _apply_suppressions(findings, modules)
    return findings, modules


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="AST lint for the PyTorch port's hot-path, CUDA-graph "
                    "and kernel-launch discipline (NFP001-NFP005)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to scan (default: {', '.join(DEFAULT_SCAN)})")
    ap.add_argument("--repo-root", type=Path, default=Path.cwd())
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline JSON; recorded findings do not fail the run")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline file with the current "
                         "active findings and exit 0")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--root", action="append", default=[],
                    help="extra NFP001 hot root (qualname or suffix)")
    ap.add_argument("--verbose", action="store_true",
                    help="also print suppressed findings")
    args = ap.parse_args(argv)

    root = args.repo_root
    paths = [Path(p) for p in args.paths] \
        or [root / p for p in DEFAULT_SCAN if (root / p).exists()]
    findings, _modules = run_analysis(paths, root, extra_roots=args.root)

    stale = 0
    if args.update_baseline:
        target = args.baseline or root / DEFAULT_BASELINE
        baseline_mod.save(target, findings)
        print(f"repro-lint: baseline written to {target} "
              f"({sum(1 for f in findings if f.active)} finding(s))")
        return 0
    if args.baseline and args.baseline.exists():
        _matched, stale = baseline_mod.apply(args.baseline, findings)

    print(report.to_text(findings, verbose=args.verbose))
    if stale:
        print(f"repro-lint: warning: {stale} stale baseline entr"
              f"{'y' if stale == 1 else 'ies'} (fixed findings — prune "
              f"with --update-baseline)")
    if args.json:
        args.json.write_text(report.to_json(findings))
    return 1 if any(f.active for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
