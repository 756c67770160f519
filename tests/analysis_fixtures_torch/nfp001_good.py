"""NFP001 fixture (good): the hot path defers every device->host pull
to its single declared `# nfp: sync-point` function, which the
reachability walk never enters."""

import numpy as np
import torch


# nfp: hot-path
def decode_step(state, tokens, lens):
    logits = torch.matmul(state, tokens)
    rows = np.asarray([int(n) for n in lens], np.int32)   # host staging
    return finalize(logits.argmax(-1)), rows


# nfp: sync-point
def finalize(ids):
    return ids.cpu().numpy()
