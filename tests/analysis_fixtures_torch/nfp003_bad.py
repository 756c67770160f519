"""NFP003 fixture (bad): a CUDA-graph cache keyed on a raw length — one
captured graph (and one set of static buffers) per distinct value."""

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


def prefill(graphs, mode: str, tokens: list, take: int):
    key = ("chunk", mode, take)                # expect: NFP003
    graphs.inputs(key)[:take] = torch.tensor(tokens[:take])
    return graphs.run(key)


def prefill_all(graphs, mode: str, tokens: list):
    return graphs.run(("rows", mode, len(tokens)))   # expect: NFP003
