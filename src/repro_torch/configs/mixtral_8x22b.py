"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE, SWA."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    head_pad_multiple=16, n_experts=8, n_experts_per_tok=2, sliding_window=4096,
    rope_theta=1_000_000.0, act="silu", norm_eps=1e-5,
))
