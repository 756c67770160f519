"""Config registry of the port: --arch <id> resolution (every family of
the JAX package: dense, MoE, SSM, hybrid, vlm and encdec)."""
from repro_torch.configs import (deepseek_coder_33b, deepseek_v3_671b,
                                 gemma3_1b, granite_moe_3b, llama31_8b,
                                 mamba2_2p7b, phi3_vision_4p2b, qwen3_8b,
                                 qwen15_0p5b, seamless_m4t_v2, zamba2_2p7b)
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (qwen15_0p5b, llama31_8b, gemma3_1b,
                                         qwen3_8b, deepseek_coder_33b,
                                         granite_moe_3b, deepseek_v3_671b,
                                         mamba2_2p7b, zamba2_2p7b,
                                         phi3_vision_4p2b, seamless_m4t_v2)
}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]

# the archs the dry run sweeps: all but llama3.1-8b, as in the JAX package
ASSIGNED = [a for a in ARCHS if a != "llama3.1-8b"]
