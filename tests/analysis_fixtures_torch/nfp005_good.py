"""NFP005 fixture (good): metadata checks (`.ndim`, `.numel()`,
`.dtype`, `is None`, `in`) stay Python control flow — they read no
tensor value — while value-dependent choices go through torch.where."""

import torch

from repro_torch.serving import graphs


def _body(x, out, bias=None):
    assert x.ndim in (1, 2) and x.numel() > 0
    total = torch.sum(x)
    if total.dim() == 0 and x.dtype == torch.float32:
        total = total.reshape(1)
    if bias is not None:
        x = x + bias
    safe = torch.where(total > 0, total, torch.ones_like(total))
    out.copy_(x / safe)


def captured_step(x, out, pool):
    return graphs.capture(lambda: _body(x, out), pool, x.device)
