"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense, GQA with 32 q and 8 kv heads, head
dim 128, qk_norm (RMS norm of q and k per head), 36 layers, untied head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
