"""Mean host time of `Engine.step` over the window's steps that ran a
prefill dispatch (a decode beside it or not), untraced steps only, in
ms."""


def read(w):
    xs = [s.t1 - s.t0 for s, _ in w.untraced() if s.prefill_dispatches]
    return sum(xs) / len(xs) * 1e3 if xs else None
