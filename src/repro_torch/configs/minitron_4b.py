"""Minitron-4B [arXiv:2407.14679]: pruned Nemotron; squared-ReLU MLP."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    head_pad_multiple=16, rope_theta=10000.0, act="relu2", norm_eps=1e-5,
))
