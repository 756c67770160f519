"""Zamba2-2.7B [arXiv:2411.15242]: hybrid, a Mamba2 backbone with one
SHARED full-attention block applied after every 6th layer (9 applications
over 54L). The real model's per-application LoRA deltas on the shared
block are omitted, as in the JAX package."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64),
    attn_every=6,
    max_seq_len=1_048_576,
)
