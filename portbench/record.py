"""The record of a run's measured window, which every metric's reader
(`metrics/<name>.py`, a function `read(w) -> float | None`) takes, and
the statistics the readers share.

Steps are the engine steps whose end fell inside the window. A traced
run profiles a stretch of consecutive steps in the window's middle:
`traced` holds those, `untraced` the rest, and host-clock readings of a
traced run come from the untraced steps alone.
"""

from __future__ import annotations

import dataclasses
import math

from portbench.loop import StepRec, Track
from portbench.spec import Model


@dataclasses.dataclass
class Window:
    model: Model
    policy: str
    t0: float                      # host clock at the window's start
    t1: float                      # ... at its close
    steps: list[StepRec]           # steps that ended in the window
    step_dt: list[float]           # each one's end minus the previous end
    traced: list[int]              # indices into steps, profiled
    tracks: list[Track]            # every request that lived in the window
    stats: dict[str, int]          # engine counter deltas over the window
    setup_s: float
    peak_bytes: int
    trace: object = None           # portbench.trace.Trace of the traced steps
    launches: dict | None = None   # kernel launch deltas over the traced steps

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def finished(self) -> list[Track]:
        """Requests that finished in the window."""
        return [t for t in self.tracks
                if t.t_finish is not None and self.t0 < t.t_finish <= self.t1]

    def first_tokens(self) -> list[Track]:
        """Requests whose first token came in the window."""
        return [t for t in self.tracks
                if t.t_first is not None and self.t0 < t.t_first <= self.t1]

    def untraced(self) -> list[tuple[StepRec, float]]:
        """(step, its share of the window's time) outside the traced
        stretch and the step after it (whose share holds the
        profiler's teardown)."""
        skip = set(self.traced) | ({max(self.traced) + 1} if self.traced
                                   else set())
        return [(s, dt) for i, (s, dt) in enumerate(zip(self.steps,
                                                        self.step_dt))
                if i not in skip]

    def traced_steps(self) -> list[StepRec]:
        return [self.steps[i] for i in self.traced]


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
