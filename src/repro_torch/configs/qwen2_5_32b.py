"""Qwen2.5-32B [hf:Qwen/Qwen2.5-*]: dense, GQA kv=8, QKV bias."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, head_pad_multiple=16, rope_theta=1_000_000.0, act="silu", norm_eps=1e-6,
))
