"""Gemma2-27B [arXiv:2408.00118]: alternating local/global attention,
attention + final logit soft-capping, post-block norms."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    head_pad_multiple=16, local_global_alternate=True, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_norm=True,
    scale_embed=True, act="gelu", norm_eps=1e-6, tie_embeddings=True,
))
