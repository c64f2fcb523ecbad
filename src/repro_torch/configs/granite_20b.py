"""Granite-20B-code [arXiv:2405.04324]: llama-arch, MQA (kv=1)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    head_pad_multiple=16, rope_theta=10000.0, act="gelu", norm_eps=1e-5,
))
