"""PaliGemma-3B [arXiv:2407.07726]: SigLIP frontend STUBBED (precomputed
patch embeddings) + gemma decoder with bidirectional image prefix."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, n_img_tokens=256,
    scale_embed=True, act="gelu", norm_eps=1e-6, tie_embeddings=True,
))
