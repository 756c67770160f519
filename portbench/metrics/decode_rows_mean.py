"""Rows a decode dispatch carried, on average over the window (the
engine's `decode_rows` over `decode_dispatches`)."""


def read(w):
    n = w.stats["decode_dispatches"]
    return w.stats["decode_rows"] / n if n else None
