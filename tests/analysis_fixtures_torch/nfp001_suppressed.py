"""Suppression fixture: one real NFP001 finding, acknowledged with an
inline ignore directive carrying its required reason."""

import torch


# nfp: hot-path
def decode_step(state):
    logits = torch.sum(state)
    # nfp: ignore[NFP001] fixture: demonstrates the suppression syntax
    return logits.item()
