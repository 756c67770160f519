"""NFP002 fixture (good): each static output is copied out (or fully
consumed) before its runner runs again; the caches a decode step hands
back are the caller's own, written in place, and stay readable."""

import torch


def replay(graph, launches):
    graph.replay()


class StepGraphs:
    def __init__(self):
        self._steps = {}

    def run(self, key):
        st = self._steps[key]
        replay(st.graph, st.launches)
        return st.ids


class DecodeStep:
    def __call__(self, params, caches, tokens, cache_len):
        st = self._keys[cache_len]
        replay(st.graph, st.launches)
        return st.logits, caches


def two_steps(graphs, key_a, key_b):
    first = graphs.run(key_a).clone()
    second = graphs.run(key_b)
    return torch.cat([first, second])


def chunk_loop(graphs, keys):
    outs = []
    for key in keys:
        outs.append(graphs.run(key).clone())
    return torch.cat(outs)


def greedy(params, caches, tokens):
    step = DecodeStep()
    logits, caches = step(params, caches, tokens, 1)
    tok = logits.argmax(-1)
    nxt, caches = step(params, caches, tok, 2)
    return tok, nxt, caches
