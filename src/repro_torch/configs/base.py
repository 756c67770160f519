"""Architecture configs for the PyTorch port (dense, MoE, SSM, hybrid,
vision-language and encoder-decoder models), and the four workload
shapes (`INPUT_SHAPES`).

A copy of the fields of `repro.configs.base.ArchConfig` (and of its
`MoEConfig`, `MLAConfig` and `SSMConfig`) that the ported decoders read,
so the port
imports nothing of the JAX package. `reduced()` derives the same 2-layer
smoke-test variant as the JAX package does, so tests can build matching
configs on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # the expert BANKS (not the router) are padded to this many rows, as
    # in the JAX package (granite's 40 experts pad to 48); padded rows
    # are never routed to
    pad_experts_to: int | None = None

    @property
    def n_experts_padded(self) -> int:
        return self.pad_experts_to or self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention [arXiv:2412.19437]."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD [arXiv:2405.21060]."""
    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int           # 0 for attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int              # dense FFN width (0 if all-MoE / attention-free)
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None    # window size for local layers
    swa_pattern: int = 0                 # N => 1 global every N layers
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0                  # hybrid: shared attn block period
    # enc-dec / multimodal (stub frontends: precomputed embeddings)
    n_enc_layers: int = 0
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_dim: int = 0                # embedding dim delivered by the stub
    frontend_len: int = 0                # frames/patches (0 = derived)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp_heads: int = 0                   # deepseek-v3 multi-token prediction
    max_seq_len: int = 131072

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def is_sub_quadratic(self) -> bool:
        """Attention cost sub-quadratic in the sequence: a recurrent stack
        (ssm, hybrid) or a sliding window."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def cache_kind(self) -> str:
        """Serving cache-descriptor family (serving/kvcache.py): 'encdec'
        (no paged layout: the dense-slot steps alone serve it), 'ssm' or
        'hybrid' for a recurrent stack (slot-resident state), 'mla'
        (latent planes) for an MLA stack, else 'gqa' (a vlm too)."""
        if self.family == "encdec":
            return "encdec"
        if self.family in ("ssm", "hybrid"):
            return self.family
        return "mla" if self.mla is not None else "gqa"

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model 256 variant for CPU tests (same rule as the
        JAX package's `ArchConfig.reduced`): 4 experts, top-2, expert
        width 128 (banks padded to 6 where the full config pads), MLA
        ranks 64 / 96 / 16 / 32 / 32, SSM d_state 16, head dim 32, chunk
        32, a shared-attention period of at most 2, at most 2 encoder
        layers, a frontend of at most 128 wide and 16 long; an
        attention-free config keeps no heads."""
        small_moe = None
        if self.moe is not None:
            small_moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=128,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                pad_experts_to=6 if self.moe.pad_experts_to else None)
        small_mla = None
        if self.mla is not None:
            small_mla = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                                  qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
        small_ssm = None
        if self.ssm is not None:
            small_ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                            chunk_size=32)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if n_heads else 0
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=256,
            n_heads=n_heads,
            n_kv_heads=max(n_kv, 1) if n_heads else 0,
            head_dim=64 if n_heads else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=512,
            moe=small_moe, mla=small_mla, ssm=small_ssm,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            swa_pattern=min(self.swa_pattern, 2) if self.swa_pattern else 0,
            sliding_window=(8 * max(min(self.swa_pattern, 2), 1) + 3)
            if self.sliding_window else None,
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            max_seq_len=4096,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A workload shape: `seq_len` tokens a row, `global_batch` rows."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# the JAX package's four shapes
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
