"""Zamba2-style hybrid in PyTorch: a Mamba-2 backbone and one SHARED
attention + MLP block applied after every ``hybrid_attn_every`` Mamba-2
layers; counterpart of ``repro.models.hybrid``.

The shared block's weights are the same at every application; only its KV
cache is per application (``attn_k`` / ``attn_v`` / ``attn_pos``, one slab
per group of layers). As in the JAX package, the shared block attends over
the hidden stream only (no concatenation with the initial embedding, no
per-application LoRA deltas). ``forward`` recomputes a group (its Mamba-2
layers and the shared block) in the backward under ``cfg.remat``;
``decode_step`` updates the cache in place.

Tensor parallelism (a ``model`` axis above 1): the Mamba-2 layers run on
each rank's heads (``ssm.mamba2_block``; the fused ``in_proj`` held as
``[z_r | x_r | B | C | dt_r]``, ``tp_fused``), the shared block on its q /
kv heads and ffn columns as the transformer's blocks do; the caches follow
``launch.specs.cache_pspecs`` (``conv`` by DI, ``h`` by Mamba-2 head,
``attn_k`` / ``attn_v`` by kv head, or by slots where the kv heads do not
divide: ``transformer.cached_attention``). A batch that does not divide over
the data-parallel axes splits the attention cache's slots over them too
(every data rank runs the whole batch; the Mamba-2 states replicate over
them).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import AttnSpec
from . import layers as L
from . import ssm
from .transformer import _ffn, _out, _own_kv, _project_qkv, cached_attention, logits_of

_CAUSAL = AttnSpec(causal=True)


def n_groups(cfg: ArchConfig) -> int:
    k = cfg.hybrid_attn_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {k}")
    return cfg.n_layers // k


def shared_attn_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    d, ff = cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {"attn_norm": (d,), "wq": (d, h, hd), "wk": (d, hkv, hd), "wv": (d, hkv, hd),
            "wo": (h, hd, d), "mlp_norm": (d,), "w_gate": (d, ff), "w_up": (d, ff),
            "w_down": (ff, d)}


class HybridLM(nn.Module):
    """Parameters of the hybrid under the JAX package's names: ``blocks``
    (stacked Mamba-2 layers), ``shared_attn`` (one block, unstacked). Built
    empty; ``init_params`` draws them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM takes the hybrid family, not {cfg.family!r}")
        n_groups(cfg)
        self.cfg = cfg
        # in_proj (D, 2 DI + 2 N + H) is [z | x | B | C | dt]: a model rank
        # holds [z_r | x_r | B | C | dt_r]
        di, n = cfg.d_inner, cfg.ssm_state
        self.tp_fused = {"blocks.in_proj": ((di, True), (di, True), (2 * n, False),
                                            (di // cfg.ssm_head_dim, True))}
        dtype = dtype or getattr(torch, cfg.param_dtype)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.embed = empty((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ParameterDict(
            {k: empty(s) for k, s in ssm.mamba2_shapes(cfg, cfg.n_layers).items()})
        self.shared_attn = nn.ParameterDict(
            {k: empty(s) for k, s in shared_attn_shapes(cfg).items()})
        self.final_norm = empty((cfg.d_model,))
        if not cfg.tie_embeddings:
            self.head = empty((cfg.d_model, cfg.vocab_size))


@torch.no_grad()
def init_params(cfg: ArchConfig, model: HybridLM, gen: torch.Generator) -> HybridLM:
    """The JAX package's initialisers and scales, drawn in float32 block by
    block and stored in the model's dtype."""
    L.embed_fill_(model.embed, gen)
    ssm.init_mamba2_stack(cfg, model.blocks, gen)
    sp = model.shared_attn
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
        L.dense_fill_(sp[name], gen, lead=0)
    L.dense_fill_(sp["wo"], gen, lead=0, scale=math.sqrt(cfg.resolved_head_dim) * out_scale)
    L.dense_fill_(sp["w_down"], gen, lead=0, scale=math.sqrt(cfg.d_ff) * out_scale)
    sp["attn_norm"].zero_()
    sp["mlp_norm"].zero_()
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        L.dense_fill_(model.head, gen, lead=0)
    return model


def _shared_attn_apply(cfg: ArchConfig, x, sp, positions, kv=None, impl: str = "auto"):
    """The shared block over x; ``kv`` = (k cache, v cache, kv_pos, global
    slot count, slot, the mesh axes of a slot split) in decode, where the
    new key is written at ``slot`` first."""
    tp = L.local_counts(cfg, sp)
    h = L.rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, h, sp, positions, tp)
    if kv is None:
        attn = flash_attention(q, _own_kv(tp, k), _own_kv(tp, v), positions, positions,
                               _CAUSAL, impl=impl)
    else:
        kc, vc, pc, slots, slot, axes = kv
        attn = cached_attention(q, k, v, kc, vc, pc, slots, slot, positions, _CAUSAL, tp, impl,
                                axes)
    x = x + _out(attn, sp["wo"], tp.heads_sharded)
    return x + _ffn(cfg, L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps), sp, tp)


def forward(cfg: ArchConfig, model: HybridLM, tokens: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V); differentiable, with per-group
    recompute under ``cfg.remat``."""
    cdt = L.compute_dtype(cfg)
    x = L.embed_rows(model.embed, tokens, cdt)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def shared(x, g):
        sp = L.cast_params(dict(model.shared_attn), cdt,
                           L.layer_shardings(model.shared_attn, stacked=False))
        return _shared_attn_apply(cfg, x, sp, positions, impl=impl)

    x = L.apply_layers(cfg, model.blocks, x,
                       lambda x, p, layer: ssm.mamba2_block(cfg, x, p, impl=impl)[0],
                       group=cfg.hybrid_attn_every, group_end=shared, seq_carry=True)
    return logits_of(cfg, model, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Per Mamba-2 layer its conv tail ``conv`` (L, B, K-1, DI) and float32
    state ``h`` (L, B, heads, N, P); per application of the shared block
    its KV cache ``attn_k`` / ``attn_v`` (G, B, max_len, Hkv, hd) and
    ``attn_pos`` (G, B, max_len), -1 for an empty slot."""
    dt = dtype or L.compute_dtype(cfg)
    g = n_groups(cfg)
    di, n, kc, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_head_dim
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    i32 = torch.int32
    return {"pos": 0, **L.alloc_cache(cfg, {
        "conv": ((cfg.n_layers, batch, kc - 1, di), dt, 0),
        "h": ((cfg.n_layers, batch, di // ph, n, ph), torch.float32, 0),
        "attn_k": ((g, batch, max_len, hkv, hd), dt, 0),
        "attn_v": ((g, batch, max_len, hkv, hd), dt, 0),
        "attn_pos": ((g, batch, max_len), i32, -1)}, batch, device)}


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: HybridLM, cache: dict, tokens: torch.Tensor,
                impl: str = "auto"):
    """tokens (B, 1) -> (logits (B, 1, V), cache); the cache is updated in
    place and returned."""
    cdt = L.compute_dtype(cfg)
    x = L.embed_rows(model.embed, tokens, cdt)
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    k = cfg.hybrid_attn_every
    slots, axes = L.slot_split(cache, "attn_k")  # global; this rank's are a block
    sp = L.cast_params(dict(model.shared_attn), cdt,
                       L.layer_shardings(model.shared_attn, stacked=False))
    shardings = L.layer_shardings(model.blocks)
    for layer, p in enumerate(L.unbind_layers(model.blocks)):
        state = {"conv": cache["conv"][layer], "h": cache["h"][layer]}
        x, new = ssm.mamba2_block(cfg, x, L.cast_params(p, cdt, shardings), state=state, impl=impl)
        cache["conv"][layer] = new["conv"]
        cache["h"][layer] = new["h"]
        if (layer + 1) % k == 0:
            g = layer // k
            x = _shared_attn_apply(cfg, x, sp, positions, impl=impl, kv=(
                cache["attn_k"][g], cache["attn_v"][g], cache["attn_pos"][g], slots,
                min(pos, slots - 1), axes))
    cache["pos"] = pos + 1
    return logits_of(cfg, model, x), cache
