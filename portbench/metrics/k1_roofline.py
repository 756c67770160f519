"""K1's (`nestedfp16_matmul`) share of its roofline over the traced
steps, in %: the least time its calls could take (each call the larger
of its FLOPs at the f16 peak and its bytes at the HBM rate, with the
rows the inputs need: the decode's active rows, the prefill's real chunk
tokens) over the device time of its kernels. The calls the trace shows
are held to the launch counters; a mismatch gives no reading."""

import sys

from portbench import reckon
from portbench.trace import is_k1


def read(w):
    if w.trace is None or not w.traced:
        return None
    calls = [(a, b) for n, a, b in w.trace.device if is_k1(n)]
    launched = (w.launches or {}).get("nestedfp16_matmul", 0)
    if not calls or not launched:
        return None
    if len(calls) != launched:
        print(f"k1_roofline: the trace holds {len(calls)} K1 calls, the "
              f"launch counters {launched}", file=sys.stderr)
        if abs(len(calls) - launched) > 0.01 * launched:
            return None
    bound = 0.0
    for s in w.traced_steps():
        if s.decode_dispatches:
            bound += reckon.k1_bound_s(w.model, s.decode_rows)
        if s.prefill_dispatches:
            bound += reckon.k1_bound_s(w.model, s.chunk_tokens)
    # a call the profiler dropped is charged at the mean of those it saw
    spent = sum(b - a for a, b in calls) / 1e6 * launched / len(calls)
    return 100.0 * bound / spent
