"""SLO-aware precision controller (paper §3.2, Fig. 1b).

Decides, per serving iteration, whether to run the next step in FP16
(quality) or FP8 (speed). NestedFP makes the switch free: both modes read
the same weight buffers, so the decision can follow load at iteration
granularity.

The controller estimates the next iteration's TPOT from a calibrated
per-token cost model and the current batch, and falls back to FP8
whenever the estimate (or the recent measured p90) threatens the SLO, or
when the paged KV pool's free-block headroom drops below
`free_block_frac_min`. Hysteresis avoids oscillation on the boundary.

Also here: `RestorePolicy`, the SLO guard on the tiered-KV restore path,
`DegradePolicy`, the router's response to lost replicas, and
`SpeculationConfig` / `AdaptiveKController`, the n-gram speculation
knobs and the per-step draft-length policy. Host-only logic, the same as
the JAX package's.
"""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class SLOConfig:
    ttft_ms: float = 200.0           # industry-standard interactive SLOs
    tpot_ms: float = 33.3
    headroom: float = 0.9            # act before the SLO is breached
    hysteresis_steps: int = 5        # min FP8 dwell before returning to FP16
    p90_window: int = 64             # measured-latency window
    free_block_frac_min: float = 0.1 # KV headroom below this forces FP8


@dataclasses.dataclass
class StepObservation:
    batch_tokens: int                # decode tokens in this iteration's batch
    queue_depth: int                 # requests waiting
    measured_step_ms: float | None   # wall time of the last step
    prefill_tokens: int = 0          # prompt-chunk tokens scheduled alongside
    free_block_frac: float | None = None
                                     # allocatable fraction of the paged KV
                                     # pool (None: caller has no pool)
    spec_drafted: int = 0            # draft tokens verified in the last step
    spec_accepted: int = 0           # ... of which the model confirmed


class DualPrecisionController:
    """Iteration-level FP16/FP8 selector."""

    def __init__(self, slo: SLOConfig, *,
                 fp16_ms_per_token: float, fp8_ms_per_token: float,
                 fixed_overhead_ms: float = 2.0):
        self.slo = slo
        self.fp16_ms_per_token = fp16_ms_per_token
        self.fp8_ms_per_token = fp8_ms_per_token
        self.fixed_overhead_ms = fixed_overhead_ms
        # measured step times PER MODE: every measured decision is made
        # against samples of the mode it predicts (FP16), or an FP8 dwell
        # would drag the p90 under budget and the controller would flap
        self._recent = {m: collections.deque(maxlen=slo.p90_window)
                        for m in ("fp16", "fp8")}
        self._fp8_dwell = 0
        self.mode: str = "fp16"
        self.history: list[str] = []

    def predict_step_ms(self, batch_tokens: int, mode: str) -> float:
        per_tok = self.fp16_ms_per_token if mode == "fp16" else self.fp8_ms_per_token
        return self.fixed_overhead_ms + per_tok * batch_tokens

    def _p90(self, mode: str = "fp16") -> float | None:
        recent = self._recent[mode]
        if len(recent) < 8:
            return None
        s = sorted(recent)
        return s[int(0.9 * (len(s) - 1))]

    def decide(self, obs: StepObservation) -> str:
        if obs.measured_step_ms is not None:
            # the sample measures the PREVIOUS step, which ran in the
            # previously-decided mode — tag it accordingly
            prev = self.history[-1] if self.history else self.mode
            self._recent[prev].append(obs.measured_step_ms)

        budget = self.slo.tpot_ms * self.slo.headroom
        # chunked prefill rides the same iteration as decode
        pred_fp16 = self.predict_step_ms(
            obs.batch_tokens + obs.prefill_tokens, "fp16")
        pred_over = pred_fp16 > budget
        p90 = self._p90("fp16")
        measured_over = p90 is not None and p90 > budget
        mem_pressure = (obs.free_block_frac is not None
                        and obs.free_block_frac < self.slo.free_block_frac_min)
        overloaded = pred_over or measured_over or mem_pressure

        if overloaded:
            self.mode = "fp8"
            self._fp8_dwell = self.slo.hysteresis_steps
            if measured_over and not (pred_over or mem_pressure) \
                    and self.history and self.history[-1] == "fp8":
                # evidence-only overload while dwelling in FP8: FP8 steps
                # add no FP16 samples, so age the stale evidence one
                # sample per step until the controller re-probes FP16
                self._recent["fp16"].popleft()
        elif self.mode == "fp8":
            self._fp8_dwell -= 1
            if self._fp8_dwell <= 0:
                self.mode = "fp16"
        self.history.append(self.mode)
        return self.mode

    def fp16_time_fraction(self) -> float:
        if not self.history:
            return 1.0
        return self.history.count("fp16") / len(self.history)


# ---------------------------------------------------------------------------
# tiered-KV restore guard (serving/engine.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RestorePolicy:
    """SLO guard for the tiered-KV restore path.

    Restoring a host-tier prefix block is an upload that shares the step
    with live decodes, so an unbounded restore queue would blow TPOT for
    every active sequence. `max_restore_bytes_per_step` caps the bytes
    each step uploads (the engine always grants at least one block, so
    gated rows make progress); `max_queue_bytes` is the admission gate:
    once the queued backlog reaches it, new prefix matches fall back to
    recompute (counted in `stats["restore_fallbacks"]`). Zero disables
    host-tier matching (spills still fill the tier for persistence)."""
    max_restore_bytes_per_step: int = 32 << 20
    max_queue_bytes: int = 256 << 20

    def admit(self, queued_bytes: int) -> bool:
        """May a new admission match host-tier blocks, given the current
        restore backlog?"""
        return queued_bytes < self.max_queue_bytes

    def grant(self, queued_bytes: int) -> int:
        """Restore-byte budget for this step."""
        return self.max_restore_bytes_per_step

    @classmethod
    def from_slo(cls, slo: SLOConfig, *, h2d_gbps: float = 16.0,
                 frac: float = 0.25, queue_steps: int = 8) -> RestorePolicy:
        """`frac` of each step's TPOT budget goes to restore uploads at
        `h2d_gbps`, and the admission gate tolerates a backlog worth
        `queue_steps` steps of that budget."""
        per_step = int(slo.tpot_ms * slo.headroom * frac / 1e3
                       * h2d_gbps * 1e9)
        return cls(max_restore_bytes_per_step=max(per_step, 1),
                   max_queue_bytes=max(per_step * queue_steps, 1))

    def scaled(self, scale: float) -> RestorePolicy:
        """A tightened (or relaxed) copy: both the per-step grant and the
        admission backlog scale together."""
        return RestorePolicy(
            max_restore_bytes_per_step=max(
                1, int(self.max_restore_bytes_per_step * scale)),
            max_queue_bytes=max(1, int(self.max_queue_bytes * scale)))


# ---------------------------------------------------------------------------
# fleet-level graceful degradation (serving/router.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DegradeDecision:
    """What the router applies to the surviving replicas this step."""
    active: bool                     # running short-handed (or dwelling)
    force_fp8: bool                  # pin survivors to FP8
    shed_budget_tokens: int | None   # per-replica outstanding-token cap for
                                     # NEW admissions (None: admit all)
    restore_scale: float             # RestorePolicy tightening factor


class DegradePolicy:
    """The fleet's counterpart of the `DualPrecisionController`: while live
    replicas are fewer than the fleet, survivors absorb the dead ones'
    load. FP8 is the free knob for that (same weights, switched per
    iteration), shedding bounds the backlog a survivor may take on, and a
    tightened `RestorePolicy` keeps host-tier uploads from competing with
    the extra decode work.

    Recovery dwells: after capacity returns, the degraded regime holds for
    `hysteresis_steps` more decisions before FP16 (and full grants and
    admissions) come back, so a flapping replica does not flap the fleet's
    precision with it."""

    def __init__(self, *, force_fp8: bool = True,
                 shed_budget_tokens: int | None = None,
                 restore_scale: float = 0.5,
                 hysteresis_steps: int = 8):
        self.force_fp8 = force_fp8
        self.shed_budget_tokens = shed_budget_tokens
        self.restore_scale = restore_scale
        self.hysteresis_steps = hysteresis_steps
        self.active = False
        self._dwell = 0
        self.history: list[bool] = []

    def decide(self, live: int, total: int) -> DegradeDecision:
        if live < total:
            self.active = True
            self._dwell = self.hysteresis_steps
        elif self.active:
            self._dwell -= 1
            if self._dwell <= 0:
                self.active = False
        self.history.append(self.active)
        return DegradeDecision(
            active=self.active,
            force_fp8=self.force_fp8 and self.active,
            shed_budget_tokens=self.shed_budget_tokens if self.active
            else None,
            restore_scale=self.restore_scale if self.active else 1.0)

    def degraded_step_fraction(self) -> float:
        if not self.history:
            return 0.0
        return sum(self.history) / len(self.history)


# ---------------------------------------------------------------------------
# speculation-length policy (serving/speculate.py drafting)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpeculationConfig:
    """Knobs for n-gram speculative decoding and the adaptive draft
    length. Each decode step verifies up to K drafted tokens a row in one
    C=K+1 ragged `paged_step` chunk; K walks inside [k_min, k_max] with
    the recent acceptance rate."""
    k_max: int = 8                   # draft-length ceiling
    k_min: int = 1                   # > 0: K=0 would draft nothing and the
                                     # acceptance signal would go silent
    k_init: int = 4
    ngram_max: int = 3               # longest suffix n-gram matched first
    ngram_min: int = 1
    adapt_window: int = 16           # recent steps in the acceptance window
    adapt_min_drafted: int = 8       # don't adapt on fewer drafted tokens
    accept_hi: float = 0.7           # grow K above this acceptance rate
    accept_lo: float = 0.3           # shrink K below it


class AdaptiveKController:
    """Per-step draft-length selector, driven by the same
    `StepObservation` stream the precision controller reads: the engine
    reports how many draft tokens the last step verified and how many the
    model confirmed."""

    def __init__(self, cfg: SpeculationConfig):
        assert 0 < cfg.k_min <= cfg.k_init <= cfg.k_max
        self.cfg = cfg
        self.k = cfg.k_init
        self._recent = collections.deque(maxlen=cfg.adapt_window)
        self.history: list[int] = []

    def acceptance_rate(self) -> float:
        drafted = sum(d for d, _ in self._recent)
        return sum(a for _, a in self._recent) / drafted if drafted else 0.0

    def decide(self, obs: StepObservation) -> int:
        if obs.spec_drafted:
            self._recent.append((obs.spec_drafted, obs.spec_accepted))
        drafted = sum(d for d, _ in self._recent)
        if drafted >= self.cfg.adapt_min_drafted:
            rate = self.acceptance_rate()
            if rate >= self.cfg.accept_hi:
                self.k = min(self.k + 1, self.cfg.k_max)
            elif rate <= self.cfg.accept_lo:
                self.k = max(self.k - 1, self.cfg.k_min)
        self.history.append(self.k)
        return self.k
