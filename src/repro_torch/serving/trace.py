"""Bursty request-arrival traces (paper §3.1, Fig. 1a).

The port of the JAX package's `serving/trace.py`: the same seeded numpy
draws, so both packages give the same traces. The Azure LLM inference
trace is not available offline; `azure_like()` reproduces its published
statistics instead: per-second rates in [0, 100] with ~5.8x swings inside
the most variable hour and ~3.2x inside the most variable minute, from a
slowly varying base load, Poisson sampling and random spikes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TraceRequest:
    arrival_s: float
    prompt_len: int
    max_new: int


def azure_like(duration_s: float = 60.0, mean_rate: float = 5.0,
               seed: int = 0, prompt_len: int = 256, max_new: int = 512,
               spike_factor: float = 3.2, spike_prob: float = 0.05
               ) -> list[TraceRequest]:
    """Bursty arrivals: a sinusoidal base times random spikes, Poisson
    sampled per second (the downscaled trace of paper Fig. 1b: 1-11
    req/s, ~5 on average)."""
    rng = np.random.RandomState(seed)
    reqs: list[TraceRequest] = []
    t = 0.0
    while t < duration_s:
        phase = 0.5 + 0.5 * np.sin(2 * np.pi * t / 37.0)          # slow wave
        rate = mean_rate * (0.4 + 1.2 * phase)
        if rng.rand() < spike_prob:
            rate *= spike_factor
        n = rng.poisson(rate)
        for _ in range(n):
            jitter = rng.rand()
            plen = max(8, int(rng.lognormal(np.log(prompt_len), 0.4)))
            mnew = max(4, int(rng.lognormal(np.log(max_new), 0.3)))
            # clamped: jitter in the last second must not push an arrival
            # past the trace's end (callers size runs by duration_s)
            reqs.append(TraceRequest(min(t + jitter, duration_s), plen, mnew))
        t += 1.0
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def steady(duration_s: float, rate: float, seed: int = 0,
           prompt_len: int = 256, max_new: int = 512) -> list[TraceRequest]:
    rng = np.random.RandomState(seed)
    n = rng.poisson(rate * duration_s)
    times = np.sort(rng.uniform(0, duration_s, n))
    return [TraceRequest(float(t), prompt_len, max_new) for t in times]


def rate_stats(reqs: list[TraceRequest], duration_s: float) -> dict:
    """Per-second arrival-rate stats over exactly ceil(duration_s)
    buckets; an arrival clamped to exactly `duration_s` counts in the last
    second. An empty trace has burstiness 0."""
    nbins = max(int(np.ceil(duration_s)), 1)
    counts = np.zeros(nbins)
    for r in reqs:
        counts[min(int(r.arrival_s), nbins - 1)] += 1
    nz = counts[counts > 0]
    burstiness = float(counts.max() / max(nz.min(), 1.0)) if nz.size else 0.0
    return {"mean_rate": float(counts.mean()),
            "max_rate": float(counts.max()),
            "min_rate": float(counts.min()),
            "burstiness": burstiness}
