"""Whisper-style encoder-decoder backbone in PyTorch; counterpart of
``repro.models.encdec``.

The conv / mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, enc_ctx, D). Encoder: bidirectional
self-attention over sinusoidal positions. Decoder: causal self-attention
(rope) and cross-attention to the encoder's output. Decode keeps the
self-attention KV cache and the cross-attention keys and values, which
``prefill_cross`` computes once; both are updated in place.

Types follow the JAX package: the float32 position table makes the encoder
run in float32, so in ``forward`` the cross-attention keys are float32
against a compute-type query (attention promotes, and returns the query's
type); in decode they come from the compute-type cache.

Tensor parallelism (a ``model`` axis above 1): every attention (encoder,
decoder self- and cross-) runs on the rank's q / kv heads and every MLP on
its ffn columns, as the transformer's blocks do (``transformer
._project_qkv``, ``_out``, ``_ffn``). The caches follow
``launch.specs.cache_pspecs``: ``k`` / ``v`` and ``cross_k`` / ``cross_v``
by kv head where the kv heads divide over ``model``, else by slots (the
decode attends over the rank's slots and merges by log-sum-exp,
``transformer.seq_attention``); ``prefill_cross`` writes each rank's
block. A batch that does not divide over the data-parallel axes splits the
slots of both caches (the 1,500 frames too) over them as well. A vocabulary that does not divide (whisper's 51,865) leaves the tied
embedding whole, so the logits are whole on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import AttnSpec
from ..parallel.sharding import axes_index, tp_copy
from . import layers as L
from .transformer import (_ffn, _out, _own_kv, _proj, _project_qkv, cached_attention,
                          logits_of, seq_attention)

_BI = AttnSpec(causal=False)
_CAUSAL = AttnSpec(causal=True)


def _attn_shapes(cfg: ArchConfig, n: int, prefix: str = "") -> dict[str, tuple[int, ...]]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {prefix + "norm": (n, d), prefix + "wq": (n, d, h, hd), prefix + "wk": (n, d, hkv, hd),
            prefix + "wv": (n, d, hkv, hd), prefix + "wo": (n, h, hd, d)}


def _mlp_shapes(cfg: ArchConfig, n: int) -> dict[str, tuple[int, ...]]:
    return {"mlp_norm": (n, cfg.d_model), "w_up": (n, cfg.d_model, cfg.d_ff),
            "w_down": (n, cfg.d_ff, cfg.d_model)}


class EncDecLM(nn.Module):
    """Parameters under the JAX package's names: ``enc_blocks`` (self-
    attention + MLP, stacked), ``dec_blocks`` (self-attention, ``cross_*``
    attention, MLP, stacked), ``embed`` (tied head), ``enc_norm``,
    ``final_norm``. Built empty; ``init_params`` draws them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM takes the encdec family, not {cfg.family!r}")
        self.cfg = cfg
        dtype = dtype or getattr(torch, cfg.param_dtype)

        def params(shapes):
            return nn.ParameterDict({k: nn.Parameter(torch.empty(s, device=device, dtype=dtype),
                                                     requires_grad=False)
                                     for k, s in shapes.items()})

        ne, nd = cfg.n_enc_layers, cfg.n_layers
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), device=device,
                                              dtype=dtype), requires_grad=False)
        self.enc_blocks = params({**_attn_shapes(cfg, ne), **_mlp_shapes(cfg, ne)})
        self.dec_blocks = params({**_attn_shapes(cfg, nd), **_attn_shapes(cfg, nd, "cross_"),
                                  **_mlp_shapes(cfg, nd)})
        self.enc_norm = nn.Parameter(torch.empty((cfg.d_model,), device=device, dtype=dtype),
                                     requires_grad=False)
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,), device=device, dtype=dtype),
                                       requires_grad=False)


@torch.no_grad()
def init_params(cfg: ArchConfig, model: EncDecLM, gen: torch.Generator) -> EncDecLM:
    """The JAX package's initialisers and scales (the decoder's depth sets
    the output scale of both stacks), drawn in float32 layer by layer."""
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    scales = {"wo": math.sqrt(cfg.resolved_head_dim) * out_scale,
              "w_down": math.sqrt(cfg.d_ff) * out_scale}
    L.embed_fill_(model.embed, gen)
    for blocks in (model.enc_blocks, model.dec_blocks):
        for name, p in blocks.items():
            base = name.removeprefix("cross_")
            if base.endswith("norm"):
                p.zero_()
            else:
                L.dense_fill_(p, gen, scale=scales.get(base, 1.0))
    model.enc_norm.zero_()
    model.final_norm.zero_()
    return model


def _attn_apply(cfg: ArchConfig, x, p, prefix, q_pos, kv, kv_pos, spec: AttnSpec,
                kv_valid=None, impl: str = "auto"):
    """x + attention of the block ``prefix`` over its own keys (``kv`` None;
    rope in the causal decoder self-attention) or over the keys and values
    of ``kv``: a pair (k, v), or the encoder's output (B, enc, D) that the
    block's ``cross_wk`` / ``cross_wv`` project."""
    tp = L.local_counts(cfg, p, prefix)
    h = L.rms_norm(x, p[prefix + "norm"], cfg.norm_eps)
    if kv is None:
        q, k, v = _project_qkv(cfg, h, p, q_pos, tp, prefix, rope=spec.causal)
    else:
        q = _proj(L.column_input(h, tp.heads_sharded), p[prefix + "wq"])
        k, v = kv if isinstance(kv, tuple) else _cross_kv(kv, p, tp)
    attn = flash_attention(q, _own_kv(tp, k), _own_kv(tp, v), q_pos, kv_pos, spec,
                           kv_valid=kv_valid, impl=impl)
    return x + _out(attn, p[prefix + "wo"], tp.heads_sharded)


def _cross_kv(enc_out, p, tp: L.LocalCounts):
    """The cross-attention keys and values of the encoder's output: a kv
    block from the output through f, or whole kv heads beside a q block,
    through f as products."""
    if tp.heads_sharded and tp.kv_whole:
        return tuple(tp_copy(_proj(enc_out, p[k])) for k in ("cross_wk", "cross_wv"))
    e = L.column_input(enc_out, tp.heads_sharded)
    return _proj(e, p["cross_wk"]), _proj(e, p["cross_wv"])


def _mlp_apply(cfg: ArchConfig, x, p):
    return x + _ffn(cfg, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps), p, L.local_counts(cfg, p))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(cfg: ArchConfig, model: EncDecLM, frames: torch.Tensor,
           impl: str = "auto") -> torch.Tensor:
    """frames (B, enc_ctx, D) precomputed frame embeddings -> the encoder's
    output (float32: the position table promotes the stream)."""
    b, s, _ = frames.shape
    pos_tab = torch.as_tensor(L.sinusoidal_embedding(s, cfg.d_model), device=frames.device)
    x = L.cast(frames, L.compute_dtype(cfg)) + pos_tab
    positions = _positions(b, s, frames.device)
    x = L.apply_layers(cfg, model.enc_blocks, x, lambda x, p, layer: _mlp_apply(
        cfg, _attn_apply(cfg, x, p, "", positions, None, positions, _BI, impl=impl), p))
    return L.rms_norm(x, L.cast(model.enc_norm, L.compute_dtype(cfg)), cfg.norm_eps)


def forward(cfg: ArchConfig, model: EncDecLM, tokens: torch.Tensor, frames: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """Teacher-forced decoder logits: tokens (B, S), frames (B, enc_ctx, D)
    -> (B, S, V); differentiable, per-layer recompute under ``cfg.remat``."""
    enc_out = encode(cfg, model, frames, impl)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    enc_pos = _positions(b, enc_out.shape[1], tokens.device)
    x = L.embed_rows(model.embed, tokens, L.compute_dtype(cfg))

    def layer_fn(x, p, layer):
        x = _attn_apply(cfg, x, p, "", positions, None, positions, _CAUSAL, impl=impl)
        x = _attn_apply(cfg, x, p, "cross_", positions, enc_out, enc_pos, _BI, impl=impl)
        return _mlp_apply(cfg, x, p)

    x = L.apply_layers(cfg, model.dec_blocks, x, layer_fn)
    return logits_of(cfg, model, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Self-attention KV cache ``k`` / ``v`` (L, B, max_len, Hkv, hd) with
    ``kv_pos`` (-1 for an empty slot), and the cross-attention keys and
    values ``cross_k`` / ``cross_v`` (L, B, enc_ctx, Hkv, hd) that
    ``prefill_cross`` fills."""
    dt = dtype or L.compute_dtype(cfg)
    hkv, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers

    kv = ((nl, batch, max_len, hkv, hd), dt, 0)
    cross = ((nl, batch, cfg.enc_ctx, hkv, hd), dt, 0)
    return {"pos": 0, **L.alloc_cache(cfg, {
        "k": kv, "v": kv, "kv_pos": ((nl, batch, max_len), torch.int32, -1),
        "cross_k": cross, "cross_v": cross}, batch, device)}


@torch.no_grad()
def prefill_cross(cfg: ArchConfig, model: EncDecLM, frames: torch.Tensor, cache: dict,
                  impl: str = "auto") -> dict:
    """Encode the frames once and write every decoder layer's cross-attention
    keys and values into the cache (in place; returned): this rank's kv
    heads, or its block of the encoder's positions where the cache's slots
    are split (over ``model``, the data-parallel axes or both)."""
    enc_out = encode(cfg, model, frames, impl)
    n = cache["cross_k"].shape[2]
    if n < enc_out.shape[1]:  # this rank's block of positions
        first = axes_index(L.slot_split(cache, "cross_k")[1]) * n
        enc_out = enc_out[:, first:first + n]
    cdt = L.compute_dtype(cfg)
    shardings = L.layer_shardings(model.dec_blocks)
    for layer, p in enumerate(L.unbind_layers(model.dec_blocks)):
        p = L.cast_params({k: p[k] for k in ("cross_wk", "cross_wv")}, cdt, shardings)
        cache["cross_k"][layer] = _proj(enc_out, p["cross_wk"])
        cache["cross_v"][layer] = _proj(enc_out, p["cross_wv"])
    return cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: EncDecLM, cache: dict, tokens: torch.Tensor,
                impl: str = "auto"):
    """tokens (B, 1) -> (logits (B, 1, V), cache); the cache is updated in
    place and returned."""
    cdt = L.compute_dtype(cfg)
    x = L.embed_rows(model.embed, tokens, cdt)
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    n_cross = cache["cross_k"].shape[2]
    cross_split = n_cross < cfg.enc_ctx
    cross_axes = L.slot_split(cache, "cross_k")[1]
    enc_pos = _positions(b, n_cross, x.device) + axes_index(cross_axes) * n_cross
    slots, axes = L.slot_split(cache, "k")  # global; this rank's are a block
    shardings = L.layer_shardings(model.dec_blocks)
    for layer, p in enumerate(L.unbind_layers(model.dec_blocks)):
        p = L.cast_params(p, cdt, shardings)
        tp = L.local_counts(cfg, p)
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(cfg, h, p, positions, tp)
        attn = cached_attention(q, k_new, v_new, cache["k"][layer], cache["v"][layer],
                                cache["kv_pos"][layer], slots, min(pos, slots - 1), positions,
                                _CAUSAL, tp, impl, axes)
        x = x + _out(attn, p["wo"], tp.heads_sharded)
        ck, cv = cache["cross_k"][layer], cache["cross_v"][layer]
        if cross_split:
            ctp = L.local_counts(cfg, p, "cross_")
            hq = _proj(L.rms_norm(x, p["cross_norm"], cfg.norm_eps), p["cross_wq"])
            attn = seq_attention(hq, ck, cv, positions, enc_pos, _BI, ctp, impl, cross_axes)
            x = x + _out(attn, p["cross_wo"], ctp.heads_sharded)
        else:
            x = _attn_apply(cfg, x, p, "cross_", positions, (ck, cv), enc_pos, _BI, impl=impl)
        x = _mlp_apply(cfg, x, p)
    cache["pos"] = pos + 1
    return logits_of(cfg, model, x), cache
