"""The port's one rule for where its entry points run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None means the card. Without a GPU that raises: the port never
    carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions of the kernels")
    return dev
