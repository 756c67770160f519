"""NFP001 fixture (bad): host syncs inside a hot-path function.

Never imported — parsed by the port's repro-lint in
tests/test_torch_analysis.py; the `# expect:` trailing comments are the
golden finding locations.
"""

import numpy as np
import torch


# nfp: hot-path
def decode_step(state, tokens, done):
    logits = torch.matmul(state, tokens)
    best = logits.item()                       # expect: NFP001
    host = np.asarray(logits)                  # expect: NFP001
    score = float(logits)                      # expect: NFP001
    ids = logits.argmax(-1).cpu()              # expect: NFP001
    moved = logits.to("cpu")                   # expect: NFP001
    rows = logits.tolist()                     # expect: NFP001
    torch.cuda.synchronize()                   # expect: NFP001
    done.synchronize()                         # expect: NFP001
    view = logits.numpy()          # raises on a CUDA tensor: never a silent sync
    return best, host, score, ids, moved, rows, view
