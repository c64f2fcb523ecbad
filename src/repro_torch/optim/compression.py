"""Gradient compression for slow links, with error feedback; counterpart of
``repro.optim.compression``.

Two codecs:
  * top-k sparsification -- keep the k largest-magnitude entries per tensor,
    accumulate the residual locally (error feedback, Stich et al.) so the
    compression bias vanishes over steps;
  * int8 linear quantization -- per-tensor scale, ~4x wire reduction
    (``torch.round`` rounds half to even, as ``jnp.round`` does).

Off the training path: one card has no slow link to compress.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class CompressionState(NamedTuple):
    residual: Any  # error-feedback accumulator: name -> float32 tensor


def compressed_allreduce_init(grads) -> CompressionState:
    return CompressionState(
        residual={k: torch.zeros_like(g, dtype=torch.float32) for k, g in grads.items()})


def compress_topk(x: torch.Tensor, frac: float = 0.05):
    """Returns (values, flat_indices) keeping max(1, int(frac * n)) entries."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def decompress_topk(values: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros((n,), dtype=torch.float32, device=values.device)
    out[idx] = values
    return out.reshape(shape)


def topk_roundtrip_with_feedback(g: torch.Tensor, residual: torch.Tensor,
                                 frac: float = 0.05):
    """Error-feedback top-k: compress (g + residual), return (g_hat, new_res)."""
    corrected = g.float() + residual
    vals, idx = compress_topk(corrected, frac)
    g_hat = decompress_topk(vals, idx, g.shape)
    return g_hat.to(g.dtype), corrected - g_hat


def int8_compress(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x.float())), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
