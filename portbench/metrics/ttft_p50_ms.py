"""The median, over every request whose first token came in the window,
of first token minus submission, in ms (the wait for admission and for
the prefill budget counts). A window holds some 35 first tokens, too few
for a tail: a p90 would have three or four beyond it."""

from portbench.record import percentile


def read(w):
    xs = [(t.t_first - t.t_submit) * 1e3 for t in w.first_tokens()]
    return percentile(xs, 50) if xs else None
