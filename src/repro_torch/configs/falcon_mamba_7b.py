"""Falcon-Mamba-7B [arXiv:2410.05355]: pure Mamba-1, attention-free."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=65024,
    ssm_state=16, ssm_version=1, ssm_conv=4, ssm_expand=2,
    act="silu", norm_eps=1e-5, tie_embeddings=True,
))
