"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block
applied periodically (hybrid)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_version=2, ssm_head_dim=64, ssm_conv=4, ssm_expand=2,
    head_pad_multiple=16, hybrid_attn_every=6, act="gelu", norm_eps=1e-5,
))
