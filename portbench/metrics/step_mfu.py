"""The whole step's share of the card's peak, in %: model FLOPs of the
window's work (each prompt's prefill counted at its first token, each
later output token at its position; 2 x the weights a token multiplies,
an MoE's routed experts only, plus attention over the keys it sees)
over the untraced window time times the peak of the mode's GEMM type
(989 TFLOP/s f16, 1979 e4m3)."""

from portbench import reckon


def read(w):
    steps = w.untraced()
    t = sum(dt for _, dt in steps)
    if t <= 0:
        return None
    flops = sum(s.flops for s, _ in steps)
    return 100.0 * flops / (t * reckon.PEAK_FLOPS[w.policy])
