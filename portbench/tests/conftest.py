"""The benchmark's own tests: `python -m pytest portbench/tests` from the
root of the repository (the repository's `tests/` are collected apart).
They run on the CPU at reduced sizes; a test marked `gpu` needs a card
and skips without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
