"""Fault-tolerant multi-replica serving router.

The port of the JAX package's `serving/router.py`. One `Router` owns R
`Engine` replicas and fronts admission for all of them:

* **Prefix-affinity placement.** A request is keyed by the blake2b chain
  hash (`kvcache._chain_hash`) of its leading prompt blocks, the digest
  the prefix index and the persisted store use, and placed by rendezvous
  hashing over the serving replicas: tenants of one shared prefix land on
  the same warm replica, and a kill re-homes only the dead replica's
  keys. A load gap beyond `balance_slack_tokens` overrides affinity with
  the least-loaded replica.

* **Health states.** healthy -> degraded (a step raised; its work drained
  and failed over, the replica stays in service) -> dead (consecutive
  errors, or a planned kill) -> recovering (revived; on probation) ->
  healthy. Dead replicas receive no work; recovering ones do.

* **Drain and deterministic failover.** A failed replica's in-flight
  requests are exported (`Engine.drain_requests`) and submitted to the
  survivors. Re-prefilling prompt + emitted tokens continues greedy
  generation exactly, so outputs equal a run without faults wherever the
  replay sums as the original decode did (bitwise on the CPU). Their KV
  comes back through a survivor's prefix cache or host tier where chains
  match (counted as restored tokens) and is recomputed otherwise (also
  counted). If the drain itself fails, the requests come from the
  router's own registry and the engine is rebuilt from its factory.

* **Graceful degradation.** A `core.policy.DegradePolicy` turns the
  NestedFP knob when live capacity drops: survivors are pinned to FP8
  (same weights, switched per iteration), new admissions beyond a
  per-replica outstanding-token budget are shed (explicitly, never
  silently lost), and host-tier restore grants tighten. FP16 comes back
  after a dwell.

For deterministic latency accounting the router takes a shared
`VirtualClock` and a `StepCostModel`: each router step advances the clock
by the slowest replica's modelled step time (injected stalls included),
so TTFT / TPOT percentiles are functions of the schedule, not of host
noise. The replicas of one router step one after another in one process;
on one card a router step's wall time is the sum of its replicas' steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.policy import DegradeDecision, DegradePolicy
from repro_torch.serving.engine import Request, _strip_pending
from repro_torch.serving.faults import ROUTER_KINDS, FaultInjector, FaultPlan
from repro_torch.serving.kvcache import _ROOT_HASH, _chain_hash

HEALTHY, DEGRADED, DEAD, RECOVERING = \
    "healthy", "degraded", "dead", "recovering"


class VirtualClock:
    """A monotonic clock the caller advances — share one instance as
    every replica's `clock=` so arrival gating, TTFT/TPOT stamps, and
    the router's step costs all read the same deterministic time."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt_s: float) -> None:
        assert dt_s >= 0.0
        self.now += dt_s


@dataclasses.dataclass
class StepCostModel:
    """Modeled per-replica step latency: fixed overhead + per-token
    cost by precision mode (FP8 cheaper — the whole point of degrading
    into it). Decode tokens pay the full memory-bound per-step rate;
    prefill-chunk tokens ride a cheaper compute-bound rate (they batch
    into one ragged dispatch and amortize the weight reads)."""
    fixed_ms: float = 2.0
    ms_per_token: dict[str, float] = dataclasses.field(
        default_factory=lambda: {"fp16": 4.0, "fp8": 2.0})
    prefill_ms_per_token: dict[str, float] = dataclasses.field(
        default_factory=lambda: {"fp16": 1.0, "fp8": 0.5})

    def step_ms(self, mode: str | None, decode_tokens: int,
                prefill_tokens: int = 0) -> float:
        m = mode or "fp16"
        return (self.fixed_ms + self.ms_per_token[m] * decode_tokens
                + self.prefill_ms_per_token[m] * prefill_tokens)


@dataclasses.dataclass
class _Replica:
    rid: int
    engine: object
    factory: Callable[[], object] | None = None
    state: str = HEALTHY
    errors: int = 0          # consecutive failed steps
    clean: int = 0           # consecutive clean steps since last error
    usable: bool = True      # False: broken beyond rebuild, never revive
    fin_cursor: int = 0      # engine.finished entries already collected
    fp8_dwell: int = 0       # steps this replica spent policy-pinned to FP8
    saved: tuple | None = None           # (forced_mode, restore_policy)

    @property
    def serving(self) -> bool:
        return self.state != DEAD


class Router:
    """R-replica front: placement, health, failover, degradation."""

    def __init__(self, engines: list, *,
                 policy: DegradePolicy | None = None,
                 plan: FaultPlan | None = None,
                 factories: list[Callable[[], object] | None] | None = None,
                 clock: VirtualClock | None = None,
                 cost_model: StepCostModel | None = None,
                 affinity_blocks: int = 2,
                 balance_slack_tokens: int = 512,
                 dead_after_errors: int = 2,
                 heal_steps: int = 4,
                 recover_probe_steps: int = 4,
                 block_size: int | None = None):
        if not engines:
            raise ValueError("router needs at least one replica")
        factories = factories or [None] * len(engines)
        self.replicas = [_Replica(i, e, f)
                         for i, (e, f) in enumerate(zip(engines, factories))]
        self.policy = policy
        self.clock = clock
        self.cost_model = cost_model
        self.affinity_blocks = affinity_blocks
        self.balance_slack_tokens = balance_slack_tokens
        self.dead_after_errors = dead_after_errors
        self.heal_steps = heal_steps
        self.recover_probe_steps = recover_probe_steps
        self.block_size = block_size if block_size is not None \
            else getattr(engines[0], "block_size", 16)
        self.step_count = 0
        self.finished: list[Request] = []
        self.shed_requests: list[Request] = []
        self._live: dict[int, dict[str, Request]] = \
            {r.rid: {} for r in self.replicas}
        self._orphans: list[Request] = []    # in-flight with zero survivors
        self._decision: DegradeDecision | None = None
        self._submitted = 0
        self._shed_by: dict[int, int] = {r.rid: 0 for r in self.replicas}
        self._c = {"kills": 0, "revives": 0, "step_errors": 0,
                   "rebuilds": 0, "failovers": 0, "failover_requests": 0,
                   "failover_restored_tokens": 0,
                   "failover_recomputed_tokens": 0,
                   "degrade_fp8_steps": 0, "stall_ms": 0.0}
        self.injector = FaultInjector(plan) if plan is not None else None
        self._router_events: dict[int, list] = {}
        if plan is not None:
            for ev in plan.events:
                if ev.kind in ROUTER_KINDS:
                    self._router_events.setdefault(ev.step, []).append(ev)
            for rep in self.replicas:
                rep.engine.fault_hook = self.injector.hook(rep.rid)

    # -- placement ------------------------------------------------------------
    def _affinity_key(self, tokens) -> int:
        """Chain hash of the request's leading `affinity_blocks` prompt
        blocks — the prefix identity warm KV would be shared under. A
        short prompt hashes whatever it has (stable either way)."""
        bs = self.block_size
        h = _ROOT_HASH
        for i in range(max(1, min(self.affinity_blocks,
                                  -(-len(tokens) // bs)))):
            h = _chain_hash(h, tuple(tokens[i * bs: (i + 1) * bs]))
        return h

    def _outstanding(self, rep: _Replica) -> int:
        """Tokens of work still owed by replica `rep`: remaining
        generation + unprefilled prompt across its registered
        requests (router-side bookkeeping — no engine sync)."""
        return sum(len(r.tokens) + r.max_new - len(r.output)
                   for r in self._live[rep.rid].values())

    def _place(self, tokens, among: list[_Replica] | None = None
               ) -> _Replica | None:
        """Rendezvous-hash the affinity key over candidate replicas:
        each (key, replica) pair gets a stable score, the max wins — so
        removing a replica re-homes ONLY its keys. A load imbalance
        beyond `balance_slack_tokens` falls back to least-loaded."""
        cands = among if among is not None \
            else [r for r in self.replicas if r.serving]
        if not cands:
            return None
        key = self._affinity_key(tokens)
        primary = max(cands, key=lambda r: _chain_hash(key, (r.rid,)))
        least = min(cands, key=lambda r: (self._outstanding(r), r.rid))
        if self._outstanding(primary) - self._outstanding(least) \
                > self.balance_slack_tokens:
            return least
        return primary

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Place and enqueue one request. Returns False iff the request
        was SHED: degrade mode is active and every serving replica is
        beyond the policy's outstanding-token budget (the shed is
        recorded — shed work is never silently lost work)."""
        cands = [r for r in self.replicas if r.serving]
        if not cands:
            raise RuntimeError("no serving replicas")
        d = self._decision
        if d is not None and d.active and d.shed_budget_tokens is not None:
            est = len(req.tokens) + req.max_new
            within = [r for r in cands
                      if self._outstanding(r) + est <= d.shed_budget_tokens]
            if not within:
                primary = self._place(req.tokens, among=cands)
                self._shed_by[primary.rid] += 1
                self.shed_requests.append(req)
                self._submitted += 1
                return False
            cands = within
        target = self._place(req.tokens, among=cands)
        target.engine.submit(req)            # may raise: invalid requests
        self._submitted += 1                 # are the caller's bug
        self._live[target.rid][req.request_id] = req
        return True

    # -- failure containment --------------------------------------------------
    def _restore_overrides(self, rep: _Replica) -> None:
        if rep.saved is not None:
            rep.engine.forced_mode, rep.engine.restore_policy = rep.saved
            rep.saved = None

    def _drain(self, rep: _Replica) -> list[Request]:
        """Export a failed replica's in-flight requests. If the drain
        itself fails (the engine is inconsistent beyond its containment
        point), recover the requests from the router's registry and
        rebuild the engine from its factory — a replica without a
        factory is marked unusable and stays dead."""
        try:
            return rep.engine.drain_requests()
        except Exception:
            pass
        # outside the handler: the traceback's frames no longer hold the
        # old engine, so its pool and graphs go before the new ones come
        reqs = [_strip_pending(r) for r in self._live[rep.rid].values()]
        if rep.factory is not None:
            rep.engine = None
            rep.engine = rep.factory()
            rep.fin_cursor = 0
            rep.saved = None
            if self.injector is not None:
                rep.engine.fault_hook = self.injector.hook(rep.rid)
            self._c["rebuilds"] += 1
        else:
            rep.state = DEAD
            rep.usable = False
        return reqs

    def _failover(self, rep: _Replica, reqs: list[Request]) -> None:
        """Re-home drained requests on the surviving replicas,
        counting, per request, the prefix tokens a survivor can serve
        from its own warm KV (device cache, host tier, or persisted
        store — chains are stable content hashes, so they match across
        replicas) vs. the tokens it must recompute."""
        if reqs:
            self._c["failovers"] += 1
        survivors = [r for r in self.replicas
                     if r.serving and r is not rep]
        if not survivors and rep.serving:
            survivors = [rep]                # sole replica: requeue on self
        for req in reqs:
            self._live[rep.rid].pop(req.request_id, None)
            self._resubmit(req, survivors)

    def _resubmit(self, req: Request, survivors: list[_Replica]) -> None:
        if not survivors:
            self._orphans.append(req)        # parked until a revive
            return
        target = self._place(req.tokens, among=survivors)
        seq = req.tokens + req.output
        bm = getattr(target.engine, "blocks", None)
        matched = bm.lookup_prefix(seq, allow_host=True) \
            if bm is not None else 0
        self._c["failover_requests"] += 1
        self._c["failover_restored_tokens"] += matched
        self._c["failover_recomputed_tokens"] += max(len(seq) - matched, 0)
        target.engine.submit(req)            # already-admitted work is
        self._live[target.rid][req.request_id] = req   # never shed

    def _on_step_error(self, rep: _Replica) -> None:
        rep.errors += 1
        rep.clean = 0
        self._c["step_errors"] += 1
        rep.state = DEAD if rep.errors >= self.dead_after_errors \
            else DEGRADED
        if rep.state == DEAD:
            self._restore_overrides(rep)
        self._failover(rep, self._drain(rep))

    def _kill(self, rep: _Replica) -> None:
        if not rep.serving:
            return
        rep.state = DEAD
        rep.errors = 0
        self._c["kills"] += 1
        self._restore_overrides(rep)
        self._failover(rep, self._drain(rep))

    def _revive(self, rep: _Replica) -> None:
        if rep.state != DEAD or not rep.usable:
            return
        rep.state = RECOVERING
        rep.clean = 0
        self._c["revives"] += 1

    def _promote(self, rep: _Replica) -> None:
        if rep.state == DEGRADED and rep.clean >= self.heal_steps:
            rep.state = HEALTHY
        elif rep.state == RECOVERING \
                and rep.clean >= self.recover_probe_steps:
            rep.state = HEALTHY

    # -- degradation ----------------------------------------------------------
    def _apply_degrade(self) -> None:
        if self.policy is None:
            return
        live = sum(1 for r in self.replicas if r.serving)
        d = self.policy.decide(live, len(self.replicas))
        self._decision = d
        for rep in self.replicas:
            if not rep.serving:
                continue
            if d.active:
                if rep.saved is None:
                    rep.saved = (rep.engine.forced_mode,
                                 rep.engine.restore_policy)
                    rep.engine.restore_policy = \
                        rep.saved[1].scaled(d.restore_scale)
                if d.force_fp8:
                    rep.engine.forced_mode = "fp8"
                    rep.fp8_dwell += 1
                    self._c["degrade_fp8_steps"] += 1
            else:
                self._restore_overrides(rep)

    # -- stepping -------------------------------------------------------------
    def _busy(self, rep: _Replica) -> bool:
        e = rep.engine
        return bool(e.queue or e.active or e.prefilling)

    def in_flight(self) -> int:
        return sum(len(v) for v in self._live.values()) + len(self._orphans)

    def step(self) -> None:
        """One fleet iteration: fire this step's planned kill/revive
        events, re-home any orphans, step every serving replica inside
        its failure containment, collect completions, drive the degrade
        policy, and advance the shared clock by the slowest replica's
        modeled step cost."""
        s = self.step_count
        if self.injector is not None:
            self.injector.arm(s)
        # revives before kills: a seeded plan may schedule both in one
        # step, and its no-extinction guarantee assumes this ordering
        for ev in sorted(self._router_events.pop(s, ()),
                         key=lambda e: e.kind != "revive"):
            if not 0 <= ev.replica < len(self.replicas):
                continue                     # plan sized for a larger fleet
            rep = self.replicas[ev.replica]
            self._kill(rep) if ev.kind == "kill" else self._revive(rep)
        if self._orphans and any(r.serving for r in self.replicas):
            orphans, self._orphans = self._orphans, []
            for req in orphans:
                self._resubmit(req,
                               [r for r in self.replicas if r.serving])
        step_ms = 0.0
        for rep in self.replicas:
            if not rep.serving:
                continue
            if not self._busy(rep):
                rep.clean += 1               # idle steps are clean steps:
                self._promote(rep)           # probation can pass on a
                continue                     # quiet fleet
            mark = self._token_counts(rep)
            try:
                rep.engine.step()
                failed = False
            except Exception:
                failed = True
            if failed:                       # drained outside the handler
                self._on_step_error(rep)
                continue
            rep.errors = 0
            rep.clean += 1
            self._promote(rep)
            if self.cost_model is not None:
                now = self._token_counts(rep)
                stall = float(getattr(rep.engine, "last_stall_ms", 0.0))
                self._c["stall_ms"] += stall
                step_ms = max(step_ms, stall + self.cost_model.step_ms(
                    getattr(rep.engine, "last_mode", None),
                    now[0] - mark[0], now[1] - mark[1]))
        self._collect_finished()
        self._apply_degrade()
        if self.clock is not None and self.cost_model is not None:
            self.clock.advance(max(step_ms, self.cost_model.fixed_ms) / 1e3)
        self.step_count += 1

    @staticmethod
    def _token_counts(rep: _Replica) -> tuple[int, int]:
        """(decode, prefill-chunk) token counters — deltas across one
        step feed the StepCostModel."""
        stats = getattr(rep.engine, "stats", None)
        if not stats:
            return 0, 0
        return stats.get("decode_tokens", 0), stats.get("chunk_tokens", 0)

    def _collect_finished(self) -> None:
        for rep in self.replicas:
            fin = rep.engine.finished
            while rep.fin_cursor < len(fin):
                req = fin[rep.fin_cursor]
                rep.fin_cursor += 1
                self._live[rep.rid].pop(req.request_id, None)
                self.finished.append(req)

    def run(self, max_steps: int = 10_000,
            allow_partial: bool = False) -> list[Request]:
        """Step until every submitted request is retired (or shed).
        Stuck states — work in flight but zero serving replicas and no
        planned revive, or the step cap — raise unless
        `allow_partial=True`."""
        steps = 0
        while self.in_flight() and steps < max_steps:
            if not any(r.serving for r in self.replicas) \
                    and not self._router_events:
                break                        # nothing can ever progress
            self.step()
            steps += 1
        if self.in_flight() and not allow_partial:
            raise RuntimeError(
                f"run(max_steps={max_steps}) ended with "
                f"{self.in_flight()} requests in flight "
                f"(serving replicas: "
                f"{sum(1 for r in self.replicas if r.serving)})")
        return self.finished

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        """Conservation + health + degradation accounting. `lost` MUST
        be zero: every submitted request is exactly-once completed,
        shed, or still in flight."""
        inflight = self.in_flight()
        corrupt_detected = 0
        corrupt_fallbacks = 0
        for rep in self.replicas:
            host = getattr(getattr(rep.engine, "blocks", None),
                           "host", None)
            if host is not None:
                corrupt_detected += host.stats.get("corrupt_blocks", 0)
            estats = getattr(rep.engine, "stats", None)
            if estats:
                corrupt_fallbacks += estats.get("corrupt_fallbacks", 0)
        return {"steps": self.step_count,
                "replicas": {r.rid: r.state for r in self.replicas},
                "submitted": self._submitted,
                "completed": len(self.finished),
                "shed": len(self.shed_requests),
                "in_flight": inflight,
                "lost": self._submitted - len(self.finished)
                - len(self.shed_requests) - inflight,
                "degrade_active": bool(self._decision is not None
                                       and self._decision.active),
                "fp8_dwell": {r.rid: r.fp8_dwell for r in self.replicas},
                "shed_by_replica": dict(self._shed_by),
                "corrupt_detected": corrupt_detected,
                "corrupt_fallbacks": corrupt_fallbacks,
                **self._c}

    # -- construction helper --------------------------------------------------
    @classmethod
    def build(cls, cfg, serving_params, n_replicas: int, *,
              meshes: list | None = None,
              engine_kwargs: dict | None = None,
              **router_kwargs) -> "Router":
        """Build R identical engines, keeping their factories for the
        rebuild after a failed drain. Engines built from one serving tree
        on one device share its weights (`params_to` returns the same
        storage); each has its own pool and graphs. `meshes`: replica i
        serves on mesh meshes[i] (`launch.mesh.make_replica_meshes`), with
        its own shards' weight slices, pools and graphs, which a killed or
        rebuilt replica frees without touching another's."""
        from repro_torch.serving.engine import Engine
        base = dict(engine_kwargs or {})
        if meshes is not None and len(meshes) != n_replicas:
            raise ValueError(f"{len(meshes)} meshes for {n_replicas} "
                             f"replicas")
        factories = []
        for i in range(n_replicas):
            kw = dict(base)
            if meshes is not None:
                kw["mesh"] = meshes[i]

            def factory(kw=kw):
                return Engine(cfg, serving_params, **kw)
            factories.append(factory)
        return cls([f() for f in factories], factories=factories,
                   **router_kwargs)
