"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE, SWA."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    head_pad_multiple=16, n_experts=8, n_experts_per_tok=2, sliding_window=4096,
    rope_theta=1_000_000.0, act="silu", norm_eps=1e-5,
))
