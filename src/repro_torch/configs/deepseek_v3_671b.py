"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA, MoE 256 routed experts top-8
+ 1 shared, per-expert d_ff=2048, 61L, MTP. All layers MoE (the real
model's 3 leading dense layers are folded into the MoE stack, as in the
JAX package)."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=0, vocab_size=129280,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128),
    mtp_heads=1,
)
