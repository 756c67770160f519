"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD, 64L, d_state=128."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128),
    max_seq_len=1_048_576,
)
