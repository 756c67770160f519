"""Architecture configs for the PyTorch port (dense decoders only).

A copy of the fields of `repro.configs.base.ArchConfig` that the dense
GQA decoder reads, so the port imports nothing of the JAX package.
`reduced()` derives the same 2-layer smoke-test variant as the JAX
package does, so tests can build matching configs on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None    # window size for local layers
    swa_pattern: int = 0                 # N => 1 global every N layers
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131072

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def cache_kind(self) -> str:
        """Serving cache-descriptor family; the port serves 'gqa' only."""
        return "gqa"

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model 256 variant for CPU tests (same rule as the
        JAX package's `ArchConfig.reduced`)."""
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            n_layers=2,
            d_model=256,
            n_heads=n_heads,
            n_kv_heads=max(n_kv, 1),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=512,
            swa_pattern=min(self.swa_pattern, 2) if self.swa_pattern else 0,
            sliding_window=(8 * max(min(self.swa_pattern, 2), 1) + 3)
            if self.sliding_window else None,
            max_seq_len=4096,
        )
