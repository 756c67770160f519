"""Reduction of a `torch.profiler` trace to what the per-layer metrics and
the breakdown read: the device's kernels and copies as intervals, the
busy time (their union), the idle gaps laid to what the host was doing,
and device time by name.

The program's own kernels are known by their CUDA symbol names (the
names the port's `csrc/` gives its `__global__` functions); every other
device operation is a PyTorch op. K1 and K3 share one templated body
(`nfp_wg::wg_kernel<Cfg<..., NESTED, ...>>`): K1 is its NESTED = true
instance.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

PORT_KERNELS = ("wg_kernel", "mma_kernel", "gemm_kernel",
                "flash_prefill_kernel", "flash_prefill_tc_kernel",
                "quant_kernel", "nestedfp_encode_kernel",
                "paged_split_kernel", "planar_split_kernel",
                "combine_kernel", "quant_per_token_kernel", "row_absmax")
SPAN_PREFIX = "bench."
# under CUPTI a graph launch pays for each of its nodes on the host (a
# ds step's graph holds ~2,500), which it does not without the profiler
GRAPH_LAUNCH = "cudaGraphLaunch"
_CFG = re.compile(r"Cfg<\s*\d+\s*,\s*\d+\s*,\s*\d+\s*,\s*(true|false|1|0)")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_k1(name: str) -> bool:
    """K1 (`nestedfp16_matmul`): the wgmma body with NESTED true."""
    if "wg_kernel" not in name:
        return False
    m = _CFG.search(name)
    return m is not None and m.group(1) in ("true", "1")


@dataclasses.dataclass
class Trace:
    """Device operations [(name, start_us, end_us)] and host spans
    [(name, start_us, end_us)] of a traced window [t0_us, t1_us]."""
    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    t0_us: float
    t1_us: float

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations, clipped to the window."""
        iv = sorted((max(a, self.t0_us), min(b, self.t1_us))
                    for _, a, b in self.device)
        out: list[list[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def idle(self) -> list[tuple[float, float]]:
        """The stretches of the window in which no operation ran."""
        edges = [self.t0_us] + [x for iv in self.busy() for x in iv] \
            + [self.t1_us]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def graph_launch_idle_s(self) -> float:
        """Idle seconds during which the host was inside a CUDA-graph
        launch: the profiler's own cost, for the most part."""
        calls = sorted((a, b) for n, a, b in self.host if n == GRAPH_LAUNCH)
        out, i = 0.0, 0
        for a, b in self.idle():
            while i < len(calls) and calls[i][1] <= a:
                i += 1
            j = i
            while j < len(calls) and calls[j][0] < b:
                out += min(b, calls[j][1]) - max(a, calls[j][0])
                j += 1
        return out / 1e6

    def step_spans(self) -> list[tuple[float, float]]:
        """The host spans of the traced engine steps, in order."""
        return sorted((a, b) for n, a, b in self.host
                      if n == SPAN_PREFIX + "step")

    def by_step(self) -> list[dict[str, float]]:
        """Device seconds by operation name for each traced step: an
        operation belongs to the step whose host span holds its middle
        (a step's work ends before the step's closing sync)."""
        spans = self.step_spans()
        out: list[dict[str, float]] = [{} for _ in spans]
        starts = [a for a, _ in spans]
        for n, a, b in self.device:
            i = bisect.bisect_right(starts, (a + b) / 2) - 1
            if i >= 0 and (a + b) / 2 <= spans[i][1]:
                out[i][n] = out[i].get(n, 0.0) + (b - a) / 1e6
        return out

    def by_name(self) -> dict[str, float]:
        """Device seconds by operation name."""
        out: dict[str, float] = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + (b - a) / 1e6
        return out

    def gaps(self, min_us: float = 5.0) -> list[tuple[str, float]]:
        """Idle stretches of the device inside the window, each laid to
        the innermost host span open at its middle ("host" when none)."""
        host = sorted(self.host, key=lambda e: e[1])
        out, open_, at = [], [], 0
        for a, b in self.idle():
            if b - a < min_us:
                continue
            mid = (a + b) / 2
            while at < len(host) and host[at][1] <= mid:
                open_.append(host[at])
                at += 1
            open_ = [h for h in open_ if h[2] >= mid]
            label = max(open_, key=lambda h: h[1])[0] if open_ else "host"
            out.append((label, (b - a) / 1e6))
        return out


def from_profiler(prof) -> Trace:
    """A `Trace` of a finished `torch.profiler.profile` over the steps it
    recorded: from the first host `bench.step` span's start (or device
    operation, if earlier) to the last one's end (the profiler's own
    clock)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # the host spans' copies on the device's timeline are not work
            if not getattr(ev, "is_user_annotation", False) \
                    and not ev.name.startswith(SPAN_PREFIX):
                device.append((ev.name, tr.start, tr.end))
        else:
            host.append((ev.name, tr.start, tr.end))
    # the profiler ran over whole steps, each ending in a sync: every
    # device operation it saw belongs to them (the two clocks are
    # aligned to within microseconds, so none is cut at the edges)
    steps = [(a, b) for n, a, b in host if n == SPAN_PREFIX + "step"]
    t0 = min([a for a, _ in steps] + [a for _, a, _ in device])
    t1 = max([b for _, b in steps] + [b for _, _, b in device])
    host = [h for h in host if h[2] >= t0 and h[1] <= t1]
    return Trace(device, host, t0, t1)


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, n of each, in seconds."""
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:n]
    idle: dict[str, float] = {}
    for label, s in tr.gaps():
        idle[label] = idle.get(label, 0.0) + s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
