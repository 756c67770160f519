"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-*-base family]:
MoE 40 experts top-8, per-expert d_ff=512, GQA 24 q / 8 kv heads, 32L."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=0, vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  pad_experts_to=48),
)
