"""Llama-3.1-8B — the paper's own primary evaluation model (Table 1/2,
Fig 7/8): 32 layers, GQA with 32 q and 8 kv heads, untied LM head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
)
