"""Output tokens emitted in the window over the window's seconds (every
token of every request, counted at the end of the step that emitted it)."""


def read(w):
    return sum(s.emitted for s in w.steps) / w.window_s
