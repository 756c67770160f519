"""Deterministic fault injection for multi-replica serving.

The port of the JAX package's `serving/faults.py`. A `FaultPlan` is an
explicit, serializable list of `FaultEvent`s keyed by (router step,
replica), written by hand or drawn from a seeded RNG (`FaultPlan.seeded`),
and always replayable: the same plan against the same requests gives the
same failures in the same order, which is what lets a test hold failover
output to a run without faults.

Event kinds and where they land:

* ``raise``   -- the replica's next `Engine.step` raises `InjectedFault`
  at the engine's containment point (the top of the step, before any
  state mutates), a crashed iteration.
* ``stall``   -- adds `arg` milliseconds to the step
  (`Engine.inject_stall_ms`): the engine folds it into its measured step
  time, so the dual-precision controller reacts, and the router's
  step-cost clock advances by it.
* ``corrupt`` -- flips one byte of a host-tier entry chosen by a seeded
  RNG, modelling rot in a spilled payload. The blake2b checksum taken at
  spill time (`HostPool.put`) catches it at match or restore time and the
  engine recomputes: counted, never a crash, never a wrong token.
* ``kill`` / ``revive`` -- taken by the router itself: the replica leaves
  (returns to) service, its in-flight work drained and failed over.

The engine-side kinds run through `FaultInjector.hook(replica)`, set as
`Engine.fault_hook` and armed with the router's step each iteration.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


class InjectedFault(RuntimeError):
    """A deliberately injected step failure (never a real defect)."""


ENGINE_KINDS = ("raise", "stall", "corrupt")
ROUTER_KINDS = ("kill", "revive")
KINDS = ENGINE_KINDS + ROUTER_KINDS


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    step: int                # router step at which the event fires
    replica: int
    kind: str                # one of KINDS
    arg: float = 0.0         # stall milliseconds (kind == "stall")

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


@dataclasses.dataclass
class FaultPlan:
    """An ordered, replayable fault schedule."""
    events: list[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [[e.step, e.replica, e.kind, e.arg]
                           for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(events=[FaultEvent(int(s), int(r), k, float(a))
                           for s, r, k, a in d["events"]],
                   seed=int(d["seed"]))

    @classmethod
    def seeded(cls, seed: int, *, replicas: int, steps: int,
               p_raise: float = 0.0, p_stall: float = 0.0,
               p_corrupt: float = 0.0, p_kill: float = 0.0,
               stall_ms: float = 50.0, revive_after: int | None = 10
               ) -> "FaultPlan":
        """Draw a random but deterministic plan, in a fixed step and
        replica order. A kill is drawn only while at least two replicas
        are alive (the plan degrades the fleet, it never extinguishes
        it), and each kill schedules a revive `revive_after` steps later
        unless revives are off (None)."""
        rng = np.random.RandomState(seed)
        events: list[FaultEvent] = []
        dead: dict[int, int | None] = {}     # rid -> revive step (or None)
        for s in range(steps):
            for rid, at in list(dead.items()):
                if at is not None and at <= s:
                    events.append(FaultEvent(s, rid, "revive"))
                    del dead[rid]
            for rid in range(replicas):
                if rid in dead:
                    continue
                if p_kill and rng.rand() < p_kill \
                        and replicas - len(dead) > 1:
                    events.append(FaultEvent(s, rid, "kill"))
                    dead[rid] = None if revive_after is None \
                        else s + revive_after
                    continue
                if p_raise and rng.rand() < p_raise:
                    events.append(FaultEvent(s, rid, "raise"))
                if p_stall and rng.rand() < p_stall:
                    events.append(FaultEvent(s, rid, "stall", stall_ms))
                if p_corrupt and rng.rand() < p_corrupt:
                    events.append(FaultEvent(s, rid, "corrupt"))
        return cls(events=events, seed=seed)


class FaultInjector:
    """Runs a plan's engine-side events through `Engine.fault_hook`.

    The router arms the injector with its step, then steps its replicas;
    each replica's hook fires the events of (step, replica) exactly once.
    Within one step a stall or corrupt runs before a raise (the raise
    aborts the engine step and must not swallow its co-scheduled
    events)."""

    def __init__(self, plan: FaultPlan):
        self.seed = plan.seed
        self.step = 0
        self.fired: list[FaultEvent] = []
        self._queue: dict[tuple[int, int], list[FaultEvent]] = \
            collections.defaultdict(list)
        order = {"stall": 0, "corrupt": 1, "raise": 2}
        for ev in plan.events:
            if ev.kind in ENGINE_KINDS:
                self._queue[(ev.step, ev.replica)].append(ev)
        for q in self._queue.values():
            q.sort(key=lambda e: order[e.kind])

    def arm(self, step: int) -> None:
        self.step = step

    def hook(self, replica: int):
        """The `Engine.fault_hook` callable of one replica."""
        def _hook(engine) -> None:
            for ev in self._queue.pop((self.step, replica), []):
                self.fired.append(ev)
                if ev.kind == "stall":
                    engine.inject_stall_ms += ev.arg
                elif ev.kind == "corrupt":
                    self._corrupt(engine, ev)
                else:
                    raise InjectedFault(
                        f"injected step failure @ step {ev.step} "
                        f"replica {ev.replica}")
        return _hook

    def _corrupt(self, engine, ev: FaultEvent) -> None:
        """Flip one byte of one host-tier entry, chosen by an RNG seeded
        from the event alone (not from what other replicas hold). No-op
        when the tier is empty."""
        host = getattr(getattr(engine, "blocks", None), "host", None)
        if host is None or not len(host.entries):
            return
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + ev.step * 1_009 + ev.replica * 101)
            % (2 ** 31))
        key = sorted(host.entries)[rng.randint(len(host.entries))]
        planes = host.entries[key]
        name = sorted(planes)[rng.randint(len(planes))]
        arr = planes[name]
        if not arr.flags.writeable:
            # the rot must land in the pool's entry: rebind a mutable copy
            arr = arr.copy()
            planes[name] = arr
        buf = arr.view(np.uint8).reshape(-1)
        if buf.size:
            buf[rng.randint(buf.size)] ^= 0xFF
