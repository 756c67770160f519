"""Committed-baseline support: intentional findings live in a JSON file
(`nfp-torch-baseline.json` at the repo root) keyed line-independently,
so the lint lane fails only on NEW findings while the recorded ones stay
visible in every report. The schema is the JAX package's linter's; an
entry may also carry a "reason", which a rewrite keeps for every key it
writes again."""

from __future__ import annotations

import collections
import json
from pathlib import Path

from repro_torch.analysis.rules import Finding

BASELINE_VERSION = 1


def save(path: Path, findings: list[Finding]) -> None:
    """Record every currently-active finding as intentional."""
    reasons = {}
    if path.exists():
        reasons = {e["key"]: e["reason"]
                   for e in json.loads(path.read_text()).get("findings", ())
                   if e.get("reason")}
    entries = [{"key": f.key(), "rule": f.rule, "path": f.path,
                "symbol": f.symbol, "message": f.message}
               for f in findings if f.active]
    for e in entries:
        if e["key"] in reasons:
            e["reason"] = reasons[e["key"]]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["key"]))
    path.write_text(json.dumps(
        {"version": BASELINE_VERSION,
         "comment": "intentional repro-lint findings; regenerate with "
                    "`python -m repro_torch.analysis.cli --update-baseline`",
         "findings": entries}, indent=2) + "\n")


def apply(path: Path, findings: list[Finding]) -> tuple[int, int]:
    """Mark findings present in the baseline. Returns (matched, stale):
    stale entries match nothing anymore and should be pruned with
    `--update-baseline`."""
    data = json.loads(path.read_text())
    budget = collections.Counter(e["key"] for e in data.get("findings", ()))
    matched = 0
    for f in findings:
        if f.suppressed or not budget.get(f.key()):
            continue
        budget[f.key()] -= 1
        f.baselined = True
        matched += 1
    stale = sum(budget.values())
    return matched, stale
