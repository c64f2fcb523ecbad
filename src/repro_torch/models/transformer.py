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
  * Tensor parallelism (a ``model`` axis above 1, the JAX package's GSPMD
    layout): a rank runs its block of q heads (and of kv heads where they
    divide; else it computes every kv head and reads those of its block),
    of ffn columns and of the vocab; ``wo`` and ``w_down`` end in one
    all-reduce each (g), the column-parallel inputs and whole kv products
    pass through f (``parallel.sharding.tp_copy``), and the logits are
    gathered along the vocab (a loss keeps each rank's block).
    The decode cache is laid out by ``launch.specs.cache_pspecs``: by kv
    heads where they divide (``heads``), else by slots (``seq``): q is
    gathered over ``model``, each rank writes the new key only where it owns
    the slot (ring slots too), attends over its slots with every q head and
    returns (o, log-sum-exp) from the decode kernel, and the ranks' partials
    are merged by log-sum-exp before each rank takes its head block into
    ``wo``.
  * A batch that does not divide over the data-parallel axes (a batch below
    dp, long_500k's batch of 1): every data rank serves the whole batch and
    the cache's slots are split over the data axes too (``cache_pspecs``),
    after them ``model`` where the kv heads do not divide. The owner of a
    slot is the rank's row-major index over those axes
    (``sharding.axes_index``), and the partials are merged over their group
    (``sharding.slot_all_gather``); with the kv heads on ``model`` and the
    slots on the data axes alone each ``model`` rank keeps its heads and
    merges over the data axes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import AttnSpec
from ..parallel.sharding import (axes_index, sharding_of, slot_all_gather, tp_all_gather,
                                 tp_copy)
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
    # Padded heads never contribute: their rows of wo are zero (the rows of
    # this rank's block of heads past n_heads, under tensor parallelism).
    wo = model.blocks["wo"]
    sh = sharding_of(wo)
    wo[:, max(cfg.n_heads - (sh.offset(1) if sh is not None else 0), 0):] = 0.0
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


def _project_qkv(cfg: ArchConfig, x, p, positions, tp: Optional[L.LocalCounts] = None,
                 prefix: str = "", rope: bool = True):
    """q, k, v of ``x`` (B, S, D) by the leaves ``prefix`` + wq / wk / wv
    (and biases), rope'd where ``rope``. Under tensor parallelism the q
    block (and a kv block beside it) reads ``x`` through f; whole kv heads
    beside a q block are computed from ``x`` itself and pass through f as
    products (each rank reads only its block's kv heads)."""
    heads = tp is not None and tp.heads_sharded
    xq = L.column_input(x, heads)
    kv_whole = heads and tp.kv_whole
    q = _proj(xq, p[prefix + "wq"])
    k, v = (_proj(x if kv_whole else xq, p[prefix + name]) for name in ("wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if kv_whole:
        k, v = tp_copy(k), tp_copy(v)
    if rope:
        q, k = L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _own_kv(tp: L.LocalCounts, k: torch.Tensor) -> torch.Tensor:
    """The kv heads of this rank's block of q heads, where ``wk`` / ``wv``
    are whole and the q heads a block (every head otherwise)."""
    if tp.kv_whole and tp.heads_sharded:
        return k[:, :, tp.kv0:tp.kv0 + tp.kv_heads]
    return k


def _ffn(cfg: ArchConfig, x, p, tp: Optional[L.LocalCounts] = None):
    sharded = tp is not None and tp.ffn_sharded
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, x, p, tp_sharded=sharded)
    x = L.column_input(x, sharded)
    if "w_gate" in p:
        h = L.activate(L.matmul(x, p["w_gate"]), cfg.act) * L.matmul(x, p["w_up"])
    else:
        h = L.activate(L.matmul(x, p["w_up"]), cfg.act)
    return L.row_parallel(h, p["w_down"], sharded)


def _out(attn: torch.Tensor, wo: torch.Tensor, sharded: bool = False) -> torch.Tensor:
    """attn (B, S, H, hd) by wo (H, hd, D) -> (B, S, D); summed over
    ``model`` where the heads are a block."""
    return L.row_parallel(attn.reshape(*attn.shape[:2], -1), wo.reshape(-1, wo.shape[-1]),
                          sharded)


def _residual_tail(cfg: ArchConfig, x, attn, p, tp: Optional[L.LocalCounts] = None):
    if cfg.post_norm:
        attn = L.rms_norm(attn, p["attn_post_norm"], cfg.norm_eps)
    x = x + attn
    ff = _ffn(cfg, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps), p, tp)
    if cfg.post_norm:
        ff = L.rms_norm(ff, p["mlp_post_norm"], cfg.norm_eps)
    return x + ff


def block_apply(cfg: ArchConfig, x, p, positions, spec: AttnSpec, impl: str = "auto"):
    """One transformer block over a whole sequence (its own keys)."""
    tp = L.local_counts(cfg, p)
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, h, p, positions, tp)
    attn = flash_attention(q, _own_kv(tp, k), _own_kv(tp, v), positions, positions, spec,
                           impl=impl)
    return _residual_tail(cfg, x, _out(attn, p["wo"], tp.heads_sharded), p, tp)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention over the union of R disjoint key sets from each set's
    output ``o`` (R, B, Sq, H, hd) and log-sum-exp ``lse`` (R, B, Sq, H)
    (-1e30 where a set holds no visible key): sum_r e^(lse_r - M) o_r /
    sum_r e^(lse_r - M), M the largest lse, in float32. A row no set sees
    stays 0."""
    mx = lse.amax(dim=0)
    w = torch.exp(lse - mx)
    return (o.float() * w[..., None]).sum(dim=0) / w.sum(dim=0)[..., None]


def seq_attention(q, kc, vc, positions, pc, spec, tp, impl, axes=("model",)):
    """Decode attention over a cache whose slots are split over the mesh
    axes ``axes``: this rank's q heads (every q head, gathered over
    ``model``, where ``model`` splits the slots and the heads are a block)
    over this rank's slots, (o, lse) merged over the ranks of ``axes`` by
    one all-gather (``sharding.slot_all_gather``), then this rank's block
    of heads."""
    gathered = tp.heads_sharded and "model" in axes
    if gathered:
        q = tp_all_gather(q, 2)
    else:  # the kv heads of this rank's q heads
        kc, vc = _own_kv(tp, kc), _own_kv(tp, vc)
    o, lse = flash_attention(q, kc, vc, positions, pc, spec, kv_valid=pc >= 0, impl=impl,
                             return_lse=True)
    part = torch.cat([o.float(), lse[..., None]], dim=-1)  # (B, 1, H, hd + 1)
    parts = slot_all_gather(part[None], axes)
    out = merge_partials(parts[..., :-1], parts[..., -1]).to(q.dtype)
    return out[:, :, tp.q0:tp.q0 + tp.heads] if gathered else out


def cached_attention(q, k_new, v_new, kc, vc, pc, slots: int, slot: int, positions,
                     spec: AttnSpec, tp: L.LocalCounts, impl: str = "auto",
                     axes: tuple[str, ...] = ()):
    """One decode step's attention over a KV cache of ``slots`` global
    slots (this rank's block of them, split over the mesh axes ``axes``,
    where ``kc`` holds fewer): the new key and value are written at global
    ``slot`` where this rank owns it (block ``axes_index(axes)``), then q
    attends over the cache (``seq_attention`` where the slots are split;
    else over the kv heads of this rank's q block)."""
    split = slots != kc.shape[1]
    slot -= axes_index(axes) * kc.shape[1] if split else 0
    if 0 <= slot < kc.shape[1]:  # this rank owns the slot
        kc[:, slot] = k_new[:, 0].to(kc.dtype)
        vc[:, slot] = v_new[:, 0].to(vc.dtype)
        pc[:, slot] = positions[:, 0]
    if split:
        return seq_attention(q, kc, vc, positions, pc, spec, tp, impl, axes)
    return flash_attention(q, _own_kv(tp, kc), _own_kv(tp, vc), positions, pc, spec,
                           kv_valid=pc >= 0, impl=impl)


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
    """Final norm, head (the tied embedding or ``head``, this rank's vocab
    block under tensor parallelism) and soft-cap, gathered along the vocab."""
    cdt = L.compute_dtype(cfg)
    x = L.rms_norm(x, L.cast(model.final_norm, cdt), cfg.norm_eps)
    head = L.weight(model.embed, cdt).t() if cfg.tie_embeddings else L.weight(model.head, cdt)
    return L.vocab_logits(x, head, cfg.vocab_size, cfg.logit_softcap)


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
        cfg, x, p, positions, specs[layer % len(specs)], impl=impl), seq_carry=True)
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
    number of tokens decoded so far. Under a mesh each rank holds its block
    (``layers.alloc_cache``; ``slots{i}`` / ``slot_axes{i}``: the global
    slot count and the mesh axes where the slots are split)."""
    dt = dtype or L.compute_dtype(cfg)
    specs = attn_specs(cfg)
    n = cfg.n_layers // len(specs)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    leaves = {}
    for i, spec in enumerate(specs):
        slots = _cache_len(spec, max_len)
        leaves[f"k{i}"] = leaves[f"v{i}"] = ((n, batch, slots, hkv, hd), dt, 0)
        leaves[f"kv_pos{i}"] = ((n, batch, slots), torch.int32, -1)
    return {"pos": 0, **L.alloc_cache(cfg, leaves, batch, device)}


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
        tp = L.local_counts(cfg, p)
        kc, vc, pc = cache[f"k{i}"][li], cache[f"v{i}"][li], cache[f"kv_pos{i}"][li]
        slots, axes = L.slot_split(cache, f"k{i}")  # global; this rank's are a block
        slot = pos % slots if spec.window > 0 else min(pos, slots - 1)
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(cfg, h, p, positions, tp)
        attn = cached_attention(q, k_new, v_new, kc, vc, pc, slots, slot, positions, spec, tp,
                                impl, axes)
        x = _residual_tail(cfg, x, _out(attn, p["wo"], tp.heads_sharded), p, tp)
    cache["pos"] = pos + 1
    return logits_of(cfg, model, x), cache
