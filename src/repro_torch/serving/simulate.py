"""Discrete-event serving simulation with a roofline cost model (paper
Fig. 1b: FP16 against FP8 against dual-precision SLO compliance).

The port of the JAX package's `serving/simulate.py`. A serving iteration
costs

    step_ms(mode) = fixed + weight_ms(mode) + kv_ms + compute_ms(mode)·tokens

with the weight traffic halved and the tensor-core rate doubled in FP8
mode, the two effects NestedFP unlocks (paper §4.1). The simulator
replays a trace through the same continuous-batching schedule and
`DualPrecisionController` as the engine, and reports p90 TPOT / TTFT,
SLO-violation seconds and the share of time served in FP16.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policy import (DualPrecisionController, SLOConfig,
                                     StepObservation)
from repro_torch.roofline.analysis import HBM_BYTES_S, PEAK_FLOPS
from repro_torch.serving.trace import TraceRequest

# one H100 SXM5 80GB's HBM3 rate and dense FP16 tensor-core peak, from
# the roofline's data-sheet constants
H100_HBM_BYTES_S = HBM_BYTES_S
H100_FP16_FLOPS = PEAK_FLOPS["f16"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-iteration latency model (ms)."""
    fixed_ms: float = 2.0
    weight_read_ms_fp16: float = 10.0      # params x 2 B / memory rate
    weight_read_ms_fp8: float = 5.0        # upper byte only: half the bytes
    kv_ms_per_ktoken: float = 0.02         # cache read per 1k cached tokens
    compute_ms_per_token_fp16: float = 0.05
    compute_ms_per_token_fp8: float = 0.025

    @classmethod
    def from_model(cls, n_params: float, *,
                   hbm_bw: float = H100_HBM_BYTES_S,
                   peak_flops: float = H100_FP16_FLOPS, n_chips: int = 1,
                   kv_bytes_per_token: float = 0.0) -> "CostModel":
        """Roofline terms of a model of `n_params` weights on `n_chips`
        cards; the defaults are one H100 SXM5 80GB's data-sheet rates."""
        w16 = n_params * 2 / (hbm_bw * n_chips) * 1e3
        c16 = 2 * n_params / (peak_flops * n_chips) * 1e3
        kv = kv_bytes_per_token * 1000 / (hbm_bw * n_chips) * 1e3
        return cls(fixed_ms=2.0, weight_read_ms_fp16=w16,
                   weight_read_ms_fp8=w16 / 2, kv_ms_per_ktoken=kv,
                   compute_ms_per_token_fp16=c16,
                   compute_ms_per_token_fp8=c16 / 2)

    def step_ms(self, mode: str, decode_tokens: int, prefill_tokens: int,
                cached_ktokens: float) -> float:
        if mode == "fp16":
            w, c = self.weight_read_ms_fp16, self.compute_ms_per_token_fp16
        else:
            w, c = self.weight_read_ms_fp8, self.compute_ms_per_token_fp8
        tokens = decode_tokens + prefill_tokens
        # one weight pass a step, shared by the whole batch
        return (self.fixed_ms + w + self.kv_ms_per_ktoken * cached_ktokens
                + c * tokens)


@dataclasses.dataclass
class SimResult:
    policy: str
    p50_tpot_ms: float
    p90_tpot_ms: float
    p99_tpot_ms: float
    p90_ttft_ms: float
    slo_violation_s: float
    duration_s: float
    fp16_fraction: float
    n_finished: int

    def row(self) -> dict:
        return dataclasses.asdict(self)


def simulate(reqs: list[TraceRequest], cost: CostModel, *,
             policy: str = "dual", slo: SLOConfig | None = None,
             max_batch: int = 64, duration_s: float | None = None
             ) -> SimResult:
    """policy: 'fp16' | 'fp8' | 'dual' (controller-driven)."""
    slo = slo or SLOConfig()
    controller = DualPrecisionController(
        slo,
        fp16_ms_per_token=cost.compute_ms_per_token_fp16,
        fp8_ms_per_token=cost.compute_ms_per_token_fp8,
        fixed_overhead_ms=cost.fixed_ms + cost.weight_read_ms_fp16)

    queue: list[TraceRequest] = []
    pending = sorted(reqs, key=lambda r: r.arrival_s)
    active: list[dict] = []
    now = 0.0
    tpots: list[float] = []
    ttfts: list[float] = []
    viol_time = 0.0
    mode_time = {"fp16": 0.0, "fp8": 0.0}
    finished = 0
    last_ms = None

    while pending or queue or active:
        while pending and pending[0].arrival_s <= now:
            queue.append(pending.pop(0))
        prefill_tokens = 0
        while queue and len(active) < max_batch:
            r = queue.pop(0)
            active.append({"req": r, "left": r.max_new, "cached": r.prompt_len,
                           "first": True})
            prefill_tokens += r.prompt_len
        if not active:
            if pending:
                now = max(now, pending[0].arrival_s)
                continue
            break
        batch_tokens = prefill_tokens + len(active)
        if policy == "dual":
            mode = controller.decide(StepObservation(
                batch_tokens=batch_tokens, queue_depth=len(queue),
                measured_step_ms=last_ms))
        else:
            mode = policy
        cached_k = sum(a["cached"] for a in active) / 1000.0
        step = cost.step_ms(mode, len(active), prefill_tokens, cached_k)
        last_ms = step
        now += step / 1000.0
        mode_time[mode] += step / 1000.0
        if step > slo.tpot_ms:
            viol_time += step / 1000.0
        done = []
        for a in active:
            a["cached"] += 1
            a["left"] -= 1
            if a["first"]:
                ttfts.append((now - a["req"].arrival_s) * 1000.0)
                a["first"] = False
            else:
                tpots.append(step)
            if a["left"] <= 0:
                done.append(a)
        for a in done:
            active.remove(a)
            finished += 1

    tp = np.asarray(tpots) if tpots else np.asarray([0.0])
    tt = np.asarray(ttfts) if ttfts else np.asarray([0.0])
    total = sum(mode_time.values()) or 1.0
    return SimResult(
        policy=policy,
        p50_tpot_ms=float(np.percentile(tp, 50)),
        p90_tpot_ms=float(np.percentile(tp, 90)),
        p99_tpot_ms=float(np.percentile(tp, 99)),
        p90_ttft_ms=float(np.percentile(tt, 90)),
        slo_violation_s=viol_time,
        duration_s=now,
        fp16_fraction=mode_time["fp16"] / total,
        n_finished=finished,
    )
