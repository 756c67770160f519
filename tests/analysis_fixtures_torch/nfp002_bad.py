"""NFP002 fixture (bad): a graph runner's static output read after the
same runner ran again — it holds the later step's values."""

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
    first = graphs.run(key_a)
    head = first[:4]
    second = graphs.run(key_b)
    return torch.cat([first, second]), head.sum()   # expect: NFP002 NFP002


def chunk_loop(graphs, keys):
    outs = []
    for key in keys:
        outs.append(graphs.run(key))
    return torch.cat(outs)                     # expect: NFP002


def greedy(params, caches, tokens):
    step = DecodeStep()
    logits, caches = step(params, caches, tokens, 1)
    nxt, caches = step(params, caches, logits.argmax(-1), 2)
    return logits, nxt                         # expect: NFP002
