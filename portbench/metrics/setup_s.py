"""Seconds from the process's start to the window's start: kernel builds
(first run in a checkout), weights, engine, step-key planning, graph
captures and the closed loop's warm-up."""


def read(w):
    return w.setup_s
