"""Shared building blocks of the port's language models (plain PyTorch);
counterpart of ``repro.models.layers``."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def layer_params(blocks, layer: int, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """One layer's slice of a stacked (L, ...) parameter dict, in ``dtype``
    (the JAX package casts the parameters to the compute type on every
    call; a model stored in that type is not cast again)."""
    return {k: cast(v[layer], dtype) for k, v in blocks.items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 with a ``(1 + w)`` gain (zero-initialised w)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved).
    x: (B, S, H, hd); positions: (B, S) absolute token positions."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _normal(shape: Sequence[int], gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               scale: float = 1.0, device=None, lead: Sequence[int] = ()) -> torch.Tensor:
    """N(0, 1) * scale / sqrt(fan_in), float32; ``lead`` prepends stacked axes
    (the layer axis) that do not count in the fan-in."""
    return _normal((*lead, *shape), gen, device) * (scale / math.sqrt(shape[in_axis]))


def embed_init(gen: torch.Generator, shape: Sequence[int], device=None) -> torch.Tensor:
    return _normal(shape, gen, device) * 0.02
