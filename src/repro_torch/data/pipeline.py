"""Synthetic-but-structured LM data pipeline (numpy).

The port's copy of the JAX package's `data/pipeline.py`: for the same
config and seed it yields the same batches, bit for bit. No corpus is
read; the stream is a noisy Markov chain over the vocabulary with a copy
motif, learnable enough that training shows a falling loss, and fully
reproducible from the seed.

A batch is a dict of numpy arrays in the model's batch contract:
"tokens" (global_batch, seq_len + 1) int32, plus a vlm's "patch_embeds"
(global_batch, frontend_len, frontend_dim) or an encdec's "frames"
(global_batch, `models.model.encdec_enc_len(seq_len)`, frontend_dim),
f32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 97            # Markov states
    copy_period: int = 24         # repeat motif every N tokens


class SyntheticLM:
    """Markov-chain + copy-motif synthetic corpus."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.RandomState(data.seed)
        v = cfg.vocab_size
        s = data.n_states
        # sparse-ish row-stochastic transition over states
        trans = rng.dirichlet(np.full(8, 0.5), size=s)
        self._next_states = np.stack(
            [rng.choice(s, size=8, replace=False) for _ in range(s)])
        self._trans = trans
        self._state_tokens = rng.randint(0, v, size=s)

    def _sample_stream(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        s = rng.randint(self.data.n_states)
        out = np.empty(n, np.int32)
        period = self.data.copy_period
        for i in range(n):
            if period and i % period == 0 and i >= period:
                out[i] = out[i - period]                  # copy motif
                continue
            nxt = rng.choice(8, p=self._trans[s])
            s = self._next_states[s, nxt]
            out[i] = self._state_tokens[s]
        return out

    def batches(self, n_batches: int | None = None) -> Iterator[dict]:
        cfg, d = self.cfg, self.data
        i = 0
        while n_batches is None or i < n_batches:
            rng = np.random.RandomState(d.seed + 1000 + i)
            toks = np.stack([self._sample_stream(rng, d.seq_len + 1)
                             for _ in range(d.global_batch)])
            batch = {"tokens": toks}
            if cfg.frontend == "vision":
                p = cfg.frontend_len or 16
                batch["patch_embeds"] = rng.randn(
                    d.global_batch, p, cfg.frontend_dim).astype(np.float32)
            if cfg.family == "encdec":
                from repro_torch.models.model import encdec_enc_len
                e = encdec_enc_len(d.seq_len)
                batch["frames"] = rng.randn(
                    d.global_batch, e, cfg.frontend_dim).astype(np.float32)
            yield batch
            i += 1


def microbatch_split(batch: dict, n_micro: int) -> dict:
    """Reshape every (B, ...) array to (n_micro, B / n_micro, ...) for a
    train step that accumulates gradients over microbatches."""
    def split(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}
