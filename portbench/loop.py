"""What drives one run: a traffic source, the engine's `submit` and
`step`, and the host clock at the end of every step.

A step is `Engine.step()`, which syncs with the card once at its end, so
the time a step ends is when its tokens exist on the host. A request's
submission, first token and finish are stamped with the end of the step
at which they happen (submission: the step at which its client's
previous request finished, or the start). The benchmark's own spans
(`bench.step`, `bench.bookkeeping`, `bench.submit`) wrap the three parts
of an iteration so that a traced run can lay each idle gap of the card
to what the host was doing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from torch.profiler import record_function


@dataclasses.dataclass
class Track:
    """One request's life, as the benchmark sees it."""
    client: int
    prompt_len: int
    max_new: int
    req: object
    t_submit: float
    t_first: float | None = None
    t_finish: float | None = None
    seen: int = 0
    token_times: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepRec:
    """One engine step: host times, what it dispatched (engine counter
    deltas), the output tokens it emitted and their model FLOPs."""
    t0: float
    t1: float
    prefill_dispatches: int
    decode_dispatches: int
    decode_rows: int
    chunk_tokens: int
    emitted: int
    flops: float


_COUNTERS = ("prefill_dispatches", "decode_dispatches", "decode_rows",
             "chunk_tokens")


class Loop:
    """Drives `eng` with the requests of `source` (a traffic kind's
    `Source`). `make_request(rid, tokens, max_new)` builds the engine's
    request; `flops(track, n_before, n_after)` gives the model
    FLOPs of the tokens a step emitted for a track (None: none
    counted)."""

    def __init__(self, eng, source, make_request: Callable,
                 flops: Callable | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.eng, self.source = eng, source
        self.make_request = make_request
        self.flops = flops
        self.clock = clock
        self.live: dict[str, Track] = {}
        self.done: list[Track] = []
        self.steps: list[StepRec] = []
        self._n_finished = 0
        self._n = 0
        self._submit(self.source.poll([]), self.clock())

    def _submit(self, reqs, now: float) -> None:
        for r in reqs:
            rid = f"r{self._n}"
            self._n += 1
            req = self.make_request(rid, r.tokens, r.max_new)
            self.eng.submit(req)
            self.live[rid] = Track(r.client, len(r.tokens), r.max_new, req,
                                   now)

    def step(self) -> StepRec:
        eng = self.eng
        before = [eng.stats[k] for k in _COUNTERS]
        t0 = self.clock()
        with record_function("bench.step"):
            eng.step()
        t1 = self.clock()
        with record_function("bench.bookkeeping"):
            emitted, flops = 0, 0.0
            for tr in self.live.values():
                n = len(tr.req.output)
                if n == tr.seen:
                    continue
                if tr.t_first is None:
                    tr.t_first = t1
                if self.flops is not None:
                    flops += self.flops(tr, tr.seen, n)
                tr.token_times += [t1] * (n - tr.seen)
                emitted += n - tr.seen
                tr.seen = n
            finished = []
            for req in eng.finished[self._n_finished:]:
                tr = self.live.pop(req.request_id)
                tr.t_finish = t1
                self.done.append(tr)
                finished.append(tr.client)
            self._n_finished = len(eng.finished)
        after = [eng.stats[k] for k in _COUNTERS]
        rec = StepRec(t0, t1, *(a - b for a, b in zip(after, before)),
                      emitted, flops)
        self.steps.append(rec)
        with record_function("bench.submit"):
            self._submit(self.source.poll(finished), t1)
        return rec
