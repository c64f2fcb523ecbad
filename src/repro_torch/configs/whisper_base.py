"""Whisper-base [arXiv:2212.04356]: encoder-decoder; the conv frontend is a
stub: the encoder consumes precomputed frame embeddings."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865, enc_ctx=1500,
    act="gelu", norm_eps=1e-5, tie_embeddings=True,
))
