"""Phi-3-Vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: a phi3-mini
decoder (32L, 32 heads of 96) and a CLIP vision frontend. The vision tower
is a STUB, as in the JAX package: the caller supplies precomputed patch
embeddings (frontend_dim 1024, 576 patches); the in-model projector maps
them to d_model and they are prepended to the text tokens."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    frontend="vision", frontend_dim=1024, frontend_len=576,
    rope_theta=500000.0,
)
