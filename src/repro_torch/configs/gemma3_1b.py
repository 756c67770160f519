"""Gemma3-1B [hf:google/gemma-3-1b-pt]: dense, 5:1 local:global sliding
window (window 512 on local layers, one global layer every 6), head dim
256, one kv head, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=512, swa_pattern=6,
    rope_theta=1_000_000.0, tie_embeddings=True,
    max_seq_len=524288,
)
