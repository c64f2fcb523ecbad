"""Decoder-only dense transformer LM in PyTorch; counterpart of
``repro.models.transformer`` (dense only: MoE comes in a later slice,
ROADMAP.md).

Covers minitron (relu^2 MLP) and the dense features of the JAX module: GQA,
QKV bias, attention and final-logit soft-caps, post-norms, embedding
scaling, tied heads, sliding windows and alternating local / global layers.

  * ``DenseLM`` keeps the JAX package's parameter tree: every per-layer
    parameter is stacked on a leading L axis under its JAX name
    (``blocks.wq`` is (L, D, H, hd)), so weights bridge name for name. The
    layers run in a Python loop (``layers.apply_layers``: each stacked leaf
    unbound once, the cast per layer, per-layer recompute under remat).
  * ``forward`` is differentiable (training, ``launch/steps.py``); the
    parameters are created with ``requires_grad=False`` and a trainer turns
    them on. ``decode_step`` runs under ``torch.no_grad``.
  * Attention goes through ``flash_attention`` (the CUDA kernel on the card,
    prefill and decode alike).
  * Decode keeps ring-buffer KV caches for windowed layers (W slots) and full
    caches for global layers; ``kv_pos`` holds absolute positions (-1 for an
    empty slot), so masks stay right after wrap-around. ``decode_step``
    writes the caches in place (the JAX version returns new ones).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import AttnSpec
from . import layers as L


class DenseLM(nn.Module):
    """Parameters of a dense decoder LM, under the JAX package's names and
    stacked layouts. Built empty; ``init_params`` draws them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported to PyTorch yet "
                                      "(MoE: see ROADMAP.md)")
        self.cfg = cfg
        dtype = dtype or getattr(torch, cfg.param_dtype)
        n, d, ff, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        h, hkv, hd = cfg.padded_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        shapes = {
            "attn_norm": (n, d), "wq": (n, d, h, hd), "wk": (n, d, hkv, hd),
            "wv": (n, d, hkv, hd), "wo": (n, h, hd, d), "mlp_norm": (n, d),
        }
        if cfg.qkv_bias:
            shapes.update(bq=(n, h, hd), bk=(n, hkv, hd), bv=(n, hkv, hd))
        if cfg.post_norm:
            shapes.update(attn_post_norm=(n, d), mlp_post_norm=(n, d))
        if cfg.act in ("silu", "gelu"):
            shapes["w_gate"] = (n, d, ff)
        shapes.update(w_up=(n, d, ff), w_down=(n, ff, d))

        def empty(shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.embed = empty((v, d))
        self.blocks = nn.ParameterDict({k: empty(s) for k, s in shapes.items()})
        self.final_norm = empty((d,))
        if not cfg.tie_embeddings:
            self.head = empty((d, v))

    def forward(self, tokens: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        return forward(self.cfg, self, tokens, impl=impl)


@torch.no_grad()
def init_params(cfg: ArchConfig, model: DenseLM, gen: torch.Generator) -> DenseLM:
    """Draw the parameters in float32 from ``gen`` with the JAX package's
    initialisers and scales, then store them in the model's dtype."""
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, hd = cfg.padded_heads, cfg.resolved_head_dim
    dev = model.embed.device
    out_scale = 1.0 / math.sqrt(2 * n)

    def dense(shape, scale=1.0):
        return L.dense_init(gen, shape, scale=scale, device=dev, lead=(n,))

    draws = {
        "wq": lambda: dense(model.blocks["wq"].shape[1:]),
        "wk": lambda: dense(model.blocks["wk"].shape[1:]),
        "wv": lambda: dense(model.blocks["wv"].shape[1:]),
        "wo": lambda: dense((h, hd, d), scale=out_scale * math.sqrt(hd)),
        "w_gate": lambda: dense((d, ff)),
        "w_up": lambda: dense((d, ff)),
        "w_down": lambda: dense((ff, d), scale=out_scale * math.sqrt(ff)),
    }
    model.embed.copy_(L.embed_init(gen, model.embed.shape, device=dev))
    for name, p in model.blocks.items():
        if name in draws:
            p.copy_(draws[name]())
        else:  # norms and biases
            p.zero_()
    # Padded heads never contribute: their rows of wo are zero.
    model.blocks["wo"][:, cfg.n_heads:] = 0.0
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        model.head.copy_(L.dense_init(gen, (d, cfg.vocab_size), device=dev))
    return model


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig) -> list[AttnSpec]:
    """Attention spec of each layer in a group of consecutive layers (two for
    alternating local / global, else one); layer l uses entry l % len."""
    base = dict(causal=True, softcap=cfg.attn_softcap)
    if cfg.local_global_alternate:
        return [AttnSpec(window=cfg.sliding_window, **base), AttnSpec(window=0, **base)]
    return [AttnSpec(window=cfg.sliding_window, **base)]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) by w (D, *out) -> (B, S, *out)."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(cfg: ArchConfig, x, p, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta), v


def _ffn(cfg: ArchConfig, x, p):
    if cfg.act in ("silu", "gelu"):
        h = L.activate(torch.matmul(x, p["w_gate"]), cfg.act) * torch.matmul(x, p["w_up"])
    else:
        h = L.activate(torch.matmul(x, p["w_up"]), cfg.act)
    return torch.matmul(h, p["w_down"])


def _out(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """attn (B, S, H, hd) by wo (H, hd, D) -> (B, S, D)."""
    return torch.matmul(attn.reshape(*attn.shape[:2], -1), wo.reshape(-1, wo.shape[-1]))


def _residual_tail(cfg: ArchConfig, x, attn, p):
    if cfg.post_norm:
        attn = L.rms_norm(attn, p["attn_post_norm"], cfg.norm_eps)
    x = x + attn
    ff = _ffn(cfg, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps), p)
    if cfg.post_norm:
        ff = L.rms_norm(ff, p["mlp_post_norm"], cfg.norm_eps)
    return x + ff


def block_apply(cfg: ArchConfig, x, p, positions, spec: AttnSpec, impl: str = "auto"):
    """One transformer block over a whole sequence (its own keys)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, h, p, positions)
    attn = flash_attention(q, k, v, positions, positions, spec, impl=impl)
    return _residual_tail(cfg, x, _out(attn, p["wo"]), p)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, model: DenseLM, tokens: torch.Tensor) -> torch.Tensor:
    x = L.cast(model.embed[tokens.long()], L.compute_dtype(cfg))
    if cfg.scale_embed:  # float32 from here on, as the JAX package promotes
        x = x.float() * math.sqrt(cfg.d_model)
    return x


def _logits(cfg: ArchConfig, model: DenseLM, x: torch.Tensor) -> torch.Tensor:
    cdt = L.compute_dtype(cfg)
    x = L.rms_norm(x, L.cast(model.final_norm, cdt), cfg.norm_eps)
    head = L.cast(model.embed, cdt).t() if cfg.tie_embeddings else L.cast(model.head, cdt)
    logits = torch.matmul(x, head)
    if cfg.logit_softcap > 0:
        logits = L.softcap(logits.float(), cfg.logit_softcap)
    return logits


def forward(cfg: ArchConfig, model: DenseLM, tokens: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V). Differentiable: recorded for a
    backward when a parameter requires grad (then with per-layer recompute
    under ``cfg.remat``); serving calls it under ``torch.no_grad``."""
    x = _embed(cfg, model, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    specs = attn_specs(cfg)
    x = L.apply_layers(cfg, model, x, lambda x, p, layer: block_apply(
        cfg, x, p, positions, specs[layer % len(specs)], impl=impl))
    return _logits(cfg, model, x)


# ---------------------------------------------------------------------------
# Decode (KV cache, one token per call)
# ---------------------------------------------------------------------------

def _cache_len(spec: AttnSpec, max_len: int) -> int:
    return min(max_len, spec.window) if spec.window > 0 else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """KV caches per position in the layer group: ``k{i}``/``v{i}``
    (L / group, B, slots, Hkv, hd) and ``kv_pos{i}`` (L / group, B, slots),
    -1 for an empty slot; windowed layers get W slots. ``pos`` is the
    number of tokens decoded so far."""
    dt = dtype or L.compute_dtype(cfg)
    specs = attn_specs(cfg)
    n = cfg.n_layers // len(specs)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache: dict[str, Any] = {"pos": 0}
    for i, spec in enumerate(specs):
        slots = _cache_len(spec, max_len)
        cache[f"k{i}"] = torch.zeros((n, batch, slots, hkv, hd), dtype=dt, device=device)
        cache[f"v{i}"] = torch.zeros((n, batch, slots, hkv, hd), dtype=dt, device=device)
        cache[f"kv_pos{i}"] = torch.full((n, batch, slots), -1, dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: DenseLM, cache: dict, tokens: torch.Tensor,
                impl: str = "auto"):
    """tokens (B, 1) -> (logits (B, 1, V), cache); the cache is updated in
    place and returned."""
    cdt = L.compute_dtype(cfg)
    x = _embed(cfg, model, tokens)
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    specs = attn_specs(cfg)
    group = len(specs)
    for layer, p in enumerate(L.unbind_layers(model.blocks)):
        i, li = layer % group, layer // group
        spec = specs[i]
        p = L.cast_params(p, cdt)
        kc, vc, pc = cache[f"k{i}"][li], cache[f"v{i}"][li], cache[f"kv_pos{i}"][li]
        slots = kc.shape[1]
        slot = pos % slots if spec.window > 0 else min(pos, slots - 1)
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(cfg, h, p, positions)
        kc[:, slot] = k_new[:, 0].to(kc.dtype)
        vc[:, slot] = v_new[:, 0].to(vc.dtype)
        pc[:, slot] = pos
        attn = flash_attention(q, kc, vc, positions, pc, spec, kv_valid=pc >= 0, impl=impl)
        x = _residual_tail(cfg, x, _out(attn, p["wo"]), p)
    cache["pos"] = pos + 1
    return _logits(cfg, model, x), cache
