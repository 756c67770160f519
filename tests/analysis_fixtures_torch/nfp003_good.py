"""NFP003 fixture (good): the key's length passes through a pow2/bucket
helper, bounding the number of captured graphs."""

import dataclasses

import torch


@dataclasses.dataclass
class _Entry:
    buf: torch.Tensor
    graph: torch.cuda.CUDAGraph | None = None


class Graphs:
    def __init__(self):
        self._steps = {}

    def _entry(self, key):
        st = self._steps.get(key)
        if st is None:
            st = _Entry(torch.zeros(key[-1]))
            self._steps[key] = st
        return st

    def inputs(self, key):
        return self._entry(key).buf

    def run(self, key):
        return self._steps[key].buf


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prefill(graphs, mode: str, tokens: list, take: int):
    key = ("chunk", mode, _bucket(take))
    graphs.inputs(key)[:take] = torch.tensor(tokens[:take])
    return graphs.run(key)


def decode(graphs, mode: str, spec: int):
    key = ("spec", mode, _bucket(spec + 1, 1)) if spec else ("decode", mode)
    return graphs.run(key)
