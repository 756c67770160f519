"""SeamlessM4T-Large-v2 [arXiv:2308.11596]: encoder-decoder; the speech
frontend (mel + conv codec) is a STUB, as in the JAX package: the caller
supplies precomputed frame embeddings (frontend_dim 1024). 24 encoder and
24 decoder layers of 16 heads of 64; the decoder cross-attends to the
encoder's memory."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    n_enc_layers=24, frontend="audio", frontend_dim=1024,
)
