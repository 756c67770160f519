"""The 90th percentile, over every gap between two consecutive output
tokens of a request whose later token came in the window, of that gap
(the host times of the ends of the steps that emitted them), in ms: the
stall a reader of a streamed answer feels, a mixed step's length where
a prefill chunk rides beside the decode."""

from portbench.record import percentile


def read(w):
    xs = [(b - a) * 1e3 for t in w.tracks
          for a, b in zip(t.token_times, t.token_times[1:])
          if w.t0 < b <= w.t1]
    return percentile(xs, 90) if xs else None
