"""Human text + machine JSON rendering of a lint run."""

from __future__ import annotations

import collections
import json

from repro_torch.analysis.rules import Finding


def summarize(findings: list[Finding]) -> dict:
    by_rule: dict[str, int] = collections.Counter()
    for f in findings:
        if f.active:
            by_rule[f.rule] += 1
    return {"total": len(findings),
            "active": sum(1 for f in findings if f.active),
            "suppressed": sum(1 for f in findings if f.suppressed),
            "baselined": sum(1 for f in findings if f.baselined),
            "active_by_rule": dict(sorted(by_rule.items()))}


def to_text(findings: list[Finding], *, verbose: bool = False) -> str:
    lines = []
    order = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    for f in order:
        if f.suppressed:
            if verbose:
                lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} "
                             f"[suppressed: {f.suppress_reason}] {f.message}")
            continue
        tag = " [baselined]" if f.baselined else ""
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule}{tag} {f.message}")
    s = summarize(findings)
    lines.append(f"repro-lint: {s['active']} active finding(s) "
                 f"({s['suppressed']} suppressed, {s['baselined']} "
                 f"baselined, {s['total']} total)")
    if s["active_by_rule"]:
        lines.append("  active by rule: " + ", ".join(
            f"{r}={n}" for r, n in s["active_by_rule"].items()))
    return "\n".join(lines)


def to_json(findings: list[Finding]) -> str:
    return json.dumps({"summary": summarize(findings),
                       "findings": [f.to_dict() for f in sorted(
                           findings,
                           key=lambda f: (f.path, f.line, f.rule))]},
                      indent=2) + "\n"
