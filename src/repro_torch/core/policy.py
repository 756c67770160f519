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
Host-only logic, the same as the JAX package's controller.
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
