"""Shared building blocks of the port's language models (plain PyTorch);
counterpart of ``repro.models.layers``."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.sharding import embed_rows, gather_fsdp, gather_params, sharding_of


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as ``jnp.einsum`` computes
    it: a float32 stream (gemma's scaled embedding, whisper's encoder) meets
    bf16 weights in float32, where ``torch.matmul`` would raise."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(cast(x, dt), cast(w, dt))


def unbind_layers(blocks) -> list[dict[str, torch.Tensor]]:
    """Per-layer views of a stacked (L, ...) parameter dict, each leaf
    unbound once: under autograd, the L views' gradients meet in one stacked
    gradient, where selecting ``v[layer]`` per layer would give each layer's
    backward a whole-stack zero gradient."""
    per_leaf = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: views[layer] for k, views in per_leaf.items()} for layer in range(n)]


def cast_params(p: dict[str, torch.Tensor], dtype: torch.dtype,
                shardings: Optional[dict] = None) -> dict[str, torch.Tensor]:
    """One layer's parameters in ``dtype`` (the JAX package casts the
    parameters to the compute type on every call; a model stored in that
    type is not cast again). Cast per layer, inside the layer's recompute
    region under remat, so no whole-model copy in ``dtype`` is held; the
    cast's backward gives the float32 gradient of the cast parameters.
    The leaves with a sharding in ``shardings`` (name -> the layer view's
    ``Sharding``) are then gathered whole (``gather_params``: one collective
    a layer, the cast type on the wire, the gradients reduce-scattered)."""
    return gather_params({k: cast(v, dtype) for k, v in p.items()}, shardings or {})


def layer_shardings(blocks, stacked: bool = True) -> dict:
    """name -> the ``Sharding`` of one layer's view of each stacked leaf of
    ``blocks`` (of each leaf, where not ``stacked``); sharded models only."""
    return {k: sh.per_layer() if stacked else sh
            for k, v in blocks.items() if (sh := sharding_of(v)) is not None}


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A top-level weight (head, shared block) in ``dtype``, gathered whole
    where it is sharded."""
    return gather_fsdp(cast(w, dtype), sharding_of(w))


def apply_layers(cfg, blocks, x: torch.Tensor, layer_fn: Callable, group: int = 1,
                 group_end: Optional[Callable] = None) -> torch.Tensor:
    """x through every layer of ``blocks`` (a dict of stacked (L, ...)
    leaves): ``layer_fn(x, p, layer)`` gets the layer's parameters cast to
    the compute type, and ``group_end(x, g)``, where given, runs after each
    ``group`` consecutive layers (the hybrid's shared block). Sharded
    leaves are gathered right after the cast (``cast_params``). When the
    forward is recorded for a backward and ``cfg.remat`` is set, each group
    is recomputed in the backward (``torch.utils.checkpoint``, as the JAX
    package's ``jax.checkpoint`` of the scanned body), the casts and the
    gathers included."""
    cdt = compute_dtype(cfg)
    # recorded for a backward: grad mode on and a parameter that requires
    # grad (serving models have none)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in blocks.values())
    per_layer = unbind_layers(blocks)
    shardings = layer_shardings(blocks)
    names = tuple(per_layer[0])
    for g0 in range(0, len(per_layer), group):
        layers = per_layer[g0:g0 + group]

        def run(x, *leaves, g0=g0, n=len(layers)):
            for i in range(n):
                p = dict(zip(names, leaves[i * len(names):(i + 1) * len(names)]))
                x = layer_fn(x, cast_params(p, cdt, shardings), g0 + i)
            return x if group_end is None else group_end(x, g0 // group)

        leaves = [v for p in layers for v in p.values()]
        if remat:
            x = torch.utils.checkpoint.checkpoint(run, x, *leaves, use_reentrant=False)
        else:
            x = run(x, *leaves)
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 with a ``(1 + w)`` gain (zero-initialised w)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in float32 with gain ``w`` and bias ``b``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


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


def sinusoidal_embedding(n_pos: int, dim: int) -> np.ndarray:
    """(n_pos, dim) float32 sin / cos position table (the encoder's)."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _normal(shape: Sequence[int], gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


@torch.no_grad()
def dense_fill_(out: torch.Tensor, gen: torch.Generator, lead: int = 1, in_axis: int = 0,
                scale: float = 1.0) -> torch.Tensor:
    """Fills ``out`` with the JAX package's dense initialiser, N(0, 1) * scale
    / sqrt(fan_in) over the dims after its ``lead`` stacked axes (layers,
    experts), which do not count in the fan-in. Drawn in float32 one trailing
    block (a layer's or an expert's leaf) at a time and stored in ``out``'s
    type, so the float32 transient is one block, never the whole stack."""
    shape = out.shape[lead:]
    s = scale / math.sqrt(shape[in_axis])
    for block in out.view(-1, *shape):
        block.copy_(_normal(shape, gen, out.device).mul_(s))
    return out


@torch.no_grad()
def embed_fill_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return out.copy_(_normal(out.shape, gen, out.device).mul_(0.02))


def loss_denominator(labels: torch.Tensor, weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """sum of valid * w over the batch (the count of valid labels without
    weights): the weighted mean's denominator, from labels and weights
    only, so a data-parallel step sums it over the ranks before its forward."""
    valid = labels >= 0
    if weights is not None:
        return torch.sum(valid * weights[:, None])
    return torch.sum(valid).float()


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           logit_softcap: float = 0.0,
                           denom: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in float32 with optional per-SAMPLE weights (the
    Cocktail |D_j| aggregation of eq. 15 folds into these weights). Returns
    (loss, n_tokens); labels < 0 are masked out. ``denom`` (a data-parallel
    rank's global ``loss_denominator``) replaces the batch's own, so the
    ranks' losses sum to the global weighted mean."""
    if logit_softcap > 0:
        logits = softcap(logits, logit_softcap)
    logits = logits.float()
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * valid
    if weights is not None:
        nll = nll * weights[:, None]
    if denom is None:
        denom = loss_denominator(labels, weights)
    return torch.sum(nll) / torch.clamp(denom, min=1.0), denom
