"""Decoder-only transformer LM (dense and MoE) in PyTorch; counterpart of
``repro.models.transformer``.

Covers qwen2.5 (GQA + QKV bias), minitron (relu^2 MLP), granite (MQA),
gemma2 (alternating local / global attention, soft-caps, post-norms,
embedding scaling, tied head), mixtral (top-2 MoE, ``moe.moe_ffn``, + sliding
windows) and the PaliGemma text backbone (prefix-LM mask over prepended
patch embeddings, ``vlm.py``).

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
  * Types promote as in the JAX package: every product is ``layers.matmul``,
    so a float32 stream (gemma's embedding scale makes it float32) meets the
    bf16 weights in float32, and in decode a float32 q meets the bf16 cache
    in float32 (``flash_attention`` promotes).
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
from . import moe

FAMILIES = ("dense", "moe", "vlm")


class DenseLM(nn.Module):
    """Parameters of a decoder LM (dense, MoE or the VLM's text backbone),
    under the JAX package's names and stacked layouts. Built empty;
    ``init_params`` draws them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"DenseLM takes the families {FAMILIES}, not {cfg.family!r}")
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
        if cfg.family == "moe":
            shapes.update(moe.moe_shapes(cfg, n))
        else:
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
    """Draw the parameters from ``gen`` with the JAX package's initialisers
    and scales, layer by layer (and expert by expert) in float32, each
    stored in the model's dtype as it is drawn."""
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    # name -> dense_fill_ keywords; the rest (norms, biases) is zero
    draws = {"wq": {}, "wk": {}, "wv": {}, "wo": {"scale": out_scale * math.sqrt(hd)},
             "w_gate": {}, "w_up": {}, "w_down": {"scale": out_scale * math.sqrt(ff)},
             **moe.init_draws(cfg)}
    L.embed_fill_(model.embed, gen)
    for name, p in model.blocks.items():
        if name in draws:
            L.dense_fill_(p, gen, **draws[name])
        else:
            p.zero_()
    # Padded heads never contribute: their rows of wo are zero.
    model.blocks["wo"][:, cfg.n_heads:] = 0.0
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        L.dense_fill_(model.head, gen, lead=0)
    return model


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig, prefix_len: int = 0) -> list[AttnSpec]:
    """Attention spec of each layer in a group of consecutive layers (two for
    alternating local / global, else one); layer l uses entry l % len.
    ``prefix_len`` keys are visible to every query (the VLM's image)."""
    base = dict(causal=True, softcap=cfg.attn_softcap, prefix_len=prefix_len)
    if cfg.local_global_alternate:
        return [AttnSpec(window=cfg.sliding_window, **base), AttnSpec(window=0, **base)]
    return [AttnSpec(window=cfg.sliding_window, **base)]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) by w (D, *out) -> (B, S, *out)."""
    return L.matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(cfg: ArchConfig, x, p, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta), v


def _ffn(cfg: ArchConfig, x, p):
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, x, p)
    if cfg.act in ("silu", "gelu"):
        h = L.activate(L.matmul(x, p["w_gate"]), cfg.act) * L.matmul(x, p["w_up"])
    else:
        h = L.activate(L.matmul(x, p["w_up"]), cfg.act)
    return L.matmul(h, p["w_down"])


def _out(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """attn (B, S, H, hd) by wo (H, hd, D) -> (B, S, D)."""
    return L.matmul(attn.reshape(*attn.shape[:2], -1), wo.reshape(-1, wo.shape[-1]))


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

def _embed(cfg: ArchConfig, model: DenseLM, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = L.embed_rows(model.embed, tokens, L.compute_dtype(cfg))
    if extra_embeds is not None:  # vlm: prepend the patch embeddings
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    if cfg.scale_embed:  # float32 from here on, as the JAX package promotes
        x = x.float() * math.sqrt(cfg.d_model)
    return x


def logits_of(cfg: ArchConfig, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Final norm, head (the tied embedding or ``head``) and soft-cap."""
    cdt = L.compute_dtype(cfg)
    x = L.rms_norm(x, L.cast(model.final_norm, cdt), cfg.norm_eps)
    head = L.weight(model.embed, cdt).t() if cfg.tie_embeddings else L.weight(model.head, cdt)
    logits = L.matmul(x, head)
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        logits = logits.float()
        # In place where autograd does not record it: a prefill's float32
        # logits are the largest tensor of its peak (8.4 GB at gemma2-27b's
        # B 4 x 2048), and the same ops in place give the same bits.
        logits = (L.softcap(logits, cap) if logits.requires_grad
                  else logits.div_(cap).tanh_().mul_(cap))
    return logits


def forward(cfg: ArchConfig, model: DenseLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None, prefix_len: int = 0,
            impl: str = "auto") -> torch.Tensor:
    """tokens (B, S_text) -> logits (B, S_total, V); ``extra_embeds``
    (B, P, D) are prepended (PaliGemma's patches) and the first
    ``prefix_len`` positions seen by every query. Differentiable: recorded
    for a backward when a parameter requires grad (then with per-layer
    recompute under ``cfg.remat``); serving calls it under ``torch.no_grad``."""
    x = _embed(cfg, model, tokens, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    specs = attn_specs(cfg, prefix_len)
    x = L.apply_layers(cfg, model.blocks, x, lambda x, p, layer: block_apply(
        cfg, x, p, positions, specs[layer % len(specs)], impl=impl))
    return logits_of(cfg, model, x)


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
    shardings = L.layer_shardings(model.blocks)
    for layer, p in enumerate(L.unbind_layers(model.blocks)):
        i, li = layer % group, layer // group
        spec = specs[i]
        p = L.cast_params(p, cdt, shardings)
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
    return logits_of(cfg, model, x), cache
