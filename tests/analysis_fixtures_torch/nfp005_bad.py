"""NFP005 fixture (bad): Python control flow on a tensor's value inside
a body a CUDA graph captures — a sync mid-capture, or a branch frozen
into every replay."""

import torch

from repro_torch.serving import graphs


def _body(x, out):
    total = torch.sum(x)
    if total > 0:                              # expect: NFP005
        x = x / total
    while torch.any(x > 1.0):                  # expect: NFP005
        x = x * 0.5
    assert torch.all(x <= 1.0)                 # expect: NFP005
    n = int(total)                             # expect: NFP005
    out.copy_(x[:n])


def captured_step(x, out, pool):
    return graphs.capture(lambda: _body(x, out), pool, x.device)
