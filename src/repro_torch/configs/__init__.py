"""Config registry of the port: --arch <id> resolution (dense archs)."""
from repro_torch.configs import llama31_8b, qwen15_0p5b
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (qwen15_0p5b, llama31_8b)
}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
