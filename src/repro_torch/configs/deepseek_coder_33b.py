"""DeepSeek-Coder-33B [arXiv:2401.14196]: llama-architecture dense
decoder, 62 layers, d_model 7168, GQA with 56 q and 8 kv heads (group 7),
head dim 128, d_ff 19200, untied head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256, rope_theta=100000.0,
)
