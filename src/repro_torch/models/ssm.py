"""Mamba-1 / Mamba-2 blocks and the pure-SSM LM (falcon-mamba) in PyTorch;
counterpart of ``repro.models.ssm`` (the Mamba-2 blocks serve the hybrid,
``hybrid.py``).

``MambaLM`` keeps the JAX package's parameter tree (per-layer parameters
stacked on a leading L axis under their JAX names). The selective scan goes
through ``mamba1_scan`` (the CUDA kernel on the card, in prefill, in decode
and, with its backward kernel, in training); the Mamba-2 scan through ``mamba2_scan`` (plain PyTorch on every
device: no kernel, as in the JAX package). Decode is O(1) per token: a K-1
conv tail and the recurrent state per layer, updated in place by
``decode_step``.

Tensor parallelism (a ``model`` axis above 1). Mamba-1: a rank holds its
block of the DI channels -- ``in_proj`` as ``[x_r | z_r]`` (``tp_fused``),
``conv_w``, ``conv_b``, ``dt_proj``'s columns, ``dt_bias``, ``a_log``,
``ssm_d``, ``x_proj``'s and ``out_proj``'s rows -- and of the ``conv`` /
``h`` cache; ``x_proj``'s (dt, B, C) output and ``out_proj``'s are
all-reduced, and the scan runs on DI / m channels. Mamba-2: a rank holds its
block of the heads -- ``in_proj`` as ``[z_r | x_r | B | C | dt_r]`` (B and C
whole on every rank), ``conv_w`` / ``conv_b`` on its DI channels,
``dt_bias`` / ``ssm_d`` by head, ``out_proj``'s rows -- while ``a_log`` and
``gate_norm`` are whole (the rank slices its heads / channels at use); the
gated RMSNorm normalises over the whole DI (its sum of squares all-reduced).
Under autograd the replicated inputs of rank-local work pass through f
(``layers.column_input``): the normed stream before ``in_proj``, Mamba-1's
all-reduced (dt, B, C), Mamba-2's B and C products (not the stream: its
gradient would count that path m times), the gated norm's sum of squares,
``a_log`` and ``gate_norm``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.mamba_scan.ops import mamba1_scan, mamba2_scan
from ..parallel.sharding import tp_all_reduce, tp_copy
from . import layers as L


def mamba1_shapes(cfg: ArchConfig, n_layers: int) -> dict[str, tuple[int, ...]]:
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.resolved_dt_rank, cfg.ssm_conv)
    return {
        "norm": (n_layers, d), "in_proj": (n_layers, d, 2 * di),
        "conv_w": (n_layers, di, k), "conv_b": (n_layers, di),
        "x_proj": (n_layers, di, r + 2 * n), "dt_proj": (n_layers, r, di),
        "dt_bias": (n_layers, di), "a_log": (n_layers, di, n),
        "ssm_d": (n_layers, di), "out_proj": (n_layers, di, d),
    }


def mamba2_shapes(cfg: ArchConfig, n_layers: int) -> dict[str, tuple[int, ...]]:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    heads = di // cfg.ssm_head_dim
    return {
        "norm": (n_layers, d),
        # [z | x | B | C | dt] fused input projection (the Mamba-2 layout)
        "in_proj": (n_layers, d, 2 * di + 2 * n + heads),
        "conv_w": (n_layers, di, k), "conv_b": (n_layers, di),
        "dt_bias": (n_layers, heads), "a_log": (n_layers, heads), "ssm_d": (n_layers, heads),
        "gate_norm": (n_layers, di), "out_proj": (n_layers, di, d),
    }


class MambaLM(nn.Module):
    """Parameters of a pure Mamba-1 LM under the JAX package's names. Built
    empty; ``init_params`` draws them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "ssm" or cfg.ssm_version != 1:
            raise ValueError(f"MambaLM takes the ssm family with Mamba-1 layers, not "
                             f"{cfg.family!r} / Mamba-{cfg.ssm_version}")
        self.cfg = cfg
        # in_proj (D, 2 DI) is [x | z]: a model rank holds [x_r | z_r]
        self.tp_fused = {"blocks.in_proj": 2}
        dtype = dtype or getattr(torch, cfg.param_dtype)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.embed = empty((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ParameterDict(
            {k: empty(s) for k, s in mamba1_shapes(cfg, cfg.n_layers).items()})
        self.final_norm = empty((cfg.d_model,))
        if not cfg.tie_embeddings:
            self.head = empty((cfg.d_model, cfg.vocab_size))

    def forward(self, tokens: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        return forward(self.cfg, self, tokens, impl=impl)


@torch.no_grad()
def init_mamba1_stack(cfg: ArchConfig, blocks: nn.ParameterDict, gen: torch.Generator) -> None:
    """Fill a stacked Mamba-1 parameter dict with the JAX package's
    initialisers (drawn layer by layer in float32, stored in the parameters'
    dtype)."""
    n_layers = blocks["norm"].shape[0]
    n, r, di = cfg.ssm_state, cfg.resolved_dt_rank, cfg.d_inner
    dev = blocks["norm"].device
    blocks["norm"].zero_()
    L.dense_fill_(blocks["in_proj"], gen)
    L.dense_fill_(blocks["conv_w"], gen, in_axis=1)
    blocks["conv_b"].zero_()
    L.dense_fill_(blocks["x_proj"], gen)
    L.dense_fill_(blocks["dt_proj"], gen, scale=r ** 0.5 * 0.1)
    blocks["dt_bias"].fill_(math.log(math.expm1(0.01)))
    arange = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    blocks["a_log"].copy_(torch.log(arange).expand(blocks["a_log"].shape))
    blocks["ssm_d"].fill_(1.0)
    L.dense_fill_(blocks["out_proj"], gen,
                  scale=1.0 / math.sqrt(2 * cfg.n_layers) * math.sqrt(di))


@torch.no_grad()
def init_mamba2_stack(cfg: ArchConfig, blocks: nn.ParameterDict, gen: torch.Generator) -> None:
    """Fill a stacked Mamba-2 parameter dict with the JAX package's
    initialisers (drawn layer by layer in float32)."""
    L.dense_fill_(blocks["in_proj"], gen)
    L.dense_fill_(blocks["conv_w"], gen, in_axis=1)
    L.dense_fill_(blocks["out_proj"], gen,
                  scale=1.0 / math.sqrt(2 * cfg.n_layers) * math.sqrt(cfg.d_inner))
    for name in ("norm", "conv_b", "a_log", "gate_norm"):
        blocks[name].zero_()
    blocks["dt_bias"].fill_(math.log(math.expm1(0.01)))
    blocks["ssm_d"].fill_(1.0)


@torch.no_grad()
def init_params(cfg: ArchConfig, model: MambaLM, gen: torch.Generator) -> MambaLM:
    L.embed_fill_(model.embed, gen)
    init_mamba1_stack(cfg, model.blocks, gen)
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        L.dense_fill_(model.head, gen, lead=0)
    return model


# ---------------------------------------------------------------------------
# Causal depthwise conv (+ its tail for decode)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """x (B, S, DI), w (DI, K), b (DI,). Returns (y, new_state), where the
    state holds the last K-1 inputs for streaming decode."""
    bsz, s, di = x.shape
    k = w.shape[1]
    pad = (torch.zeros((bsz, k - 1, di), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)  # (B, S + K - 1, DI)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s] * w[:, i]
    new_state = xp[:, s:] if k > 1 else xp[:, :0]
    return y + b, new_state


# ---------------------------------------------------------------------------
# Block and LM
# ---------------------------------------------------------------------------

def mamba1_block(cfg: ArchConfig, x, p, state=None, impl: str = "auto"):
    """x (B, S, D); state None (prefill) or dict(conv, h) for decode.
    Returns (out, new_state)."""
    r, n = cfg.resolved_dt_rank, cfg.ssm_state
    tp = L.local_counts(cfg, p)
    di = tp.inner  # this rank's channels
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    xi, z = torch.matmul(L.column_input(h, tp.inner_sharded), p["in_proj"]).split([di, di],
                                                                                 dim=-1)
    xi, new_conv = causal_conv(xi, p["conv_w"], p["conv_b"],
                               None if state is None else state["conv"])
    xi = F.silu(xi)
    proj = torch.matmul(xi, p["x_proj"])
    if tp.inner_sharded:
        proj = tp_copy(tp_all_reduce(proj))
    dt_r, bmat, cmat = proj.split([r, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_r, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    y, h_new = mamba1_scan(xi, dt, a, bmat, cmat, h0=None if state is None else state["h"],
                           chunk=cfg.ssm_chunk, impl=impl)
    y = (y + xi * p["ssm_d"]) * F.silu(z)
    out = x + L.row_parallel(y, p["out_proj"], tp.inner_sharded)
    return out, (None if state is None else {"conv": new_conv, "h": h_new})


def _mamba2_in_proj(x, w, tp: L.LocalCounts, n: int):
    """(z, x, B, C, dt) of ``x`` by a fused ``in_proj``; on a rank's block
    ``[z_r | x_r | B | C | dt_r]``, z / x / dt from the stream through f and
    B / C from the stream itself, through f as products."""
    di, heads = tp.inner, tp.ssm_heads
    if not tp.inner_sharded:
        return L.matmul(x, w).split([di, di, n, n, heads], dim=-1)
    xf = tp_copy(x)
    z, xi = L.matmul(xf, w[..., :2 * di]).split([di, di], dim=-1)
    bmat, cmat = tp_copy(L.matmul(x, w[..., 2 * di:2 * di + 2 * n])).split([n, n], dim=-1)
    return z, xi, bmat, cmat, L.matmul(xf, w[..., 2 * di + 2 * n:])


def gated_rms_norm(cfg: ArchConfig, y: torch.Tensor, w: torch.Tensor,
                   tp: L.LocalCounts) -> torch.Tensor:
    """RMSNorm over the whole DI of ``y`` (this rank's channels ``c0`` ..
    ``c0 + inner`` under tensor parallelism: the sum of squares summed over
    ``model``, one all-reduce of B x S floats) with the whole gain ``w``."""
    if not tp.inner_sharded:
        return L.rms_norm(y, w, cfg.norm_eps)
    yf = y.float()
    ss = tp_copy(tp_all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True)))
    gain = tp_copy(w)[tp.c0:tp.c0 + tp.inner]
    return (yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps) * (1.0 + gain.float())).to(y.dtype)


def mamba2_block(cfg: ArchConfig, x, p, state=None, impl: str = "auto"):
    """Mamba-2 (SSD) block: heads = d_inner / ssm_head_dim sharing B and C,
    a per-head D term and the gated RMSNorm. x (B, S, D); state None
    (prefill) or dict(conv, h) for decode. Returns (out, new_state). Under
    tensor parallelism on this rank's heads (see the module doc)."""
    n, ph = cfg.ssm_state, cfg.ssm_head_dim
    tp = L.local_counts(cfg, p)
    di, heads = tp.inner, tp.ssm_heads
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xi, bmat, cmat, dt_in = _mamba2_in_proj(h, p["in_proj"], tp, n)
    xi, new_conv = causal_conv(xi, p["conv_w"], p["conv_b"],
                               None if state is None else state["conv"])
    xi = F.silu(xi)
    dt = F.softplus(dt_in + p["dt_bias"])  # (B, S, H)
    a_log = p["a_log"]
    if tp.inner_sharded:  # whole on every rank: this rank's heads
        a_log = tp_copy(a_log)[tp.h0:tp.h0 + heads]
    a = -torch.exp(a_log.float())  # (H,)
    bsz, s = xi.shape[:2]
    xh = xi.reshape(bsz, s, heads, ph)
    y, h_new = mamba2_scan(xh, dt, a, bmat, cmat, h0=None if state is None else state["h"],
                           chunk=cfg.ssm_chunk, impl=impl)
    y = (y + xh * p["ssm_d"][:, None]).reshape(bsz, s, di)  # per-head D term
    y = gated_rms_norm(cfg, y * F.silu(z), p["gate_norm"], tp)
    out = x + L.row_parallel(y, p["out_proj"], tp.inner_sharded)
    return out, (None if state is None else {"conv": new_conv, "h": h_new})


def _logits(cfg: ArchConfig, model: MambaLM, x: torch.Tensor) -> torch.Tensor:
    cdt = L.compute_dtype(cfg)
    x = L.rms_norm(x, L.cast(model.final_norm, cdt), cfg.norm_eps)
    head = L.weight(model.embed, cdt).t() if cfg.tie_embeddings else L.weight(model.head, cdt)
    return L.vocab_logits(x, head, cfg.vocab_size)


def forward(cfg: ArchConfig, model: MambaLM, tokens: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V). Differentiable as the dense
    ``forward`` is; on the card a recorded forward runs the scan through
    ``ops.KernelScan`` (the forward and backward kernels)."""
    x = L.embed_rows(model.embed, tokens, L.compute_dtype(cfg))
    x = L.apply_layers(cfg, model.blocks, x,
                       lambda x, p, layer: mamba1_block(cfg, x, p, impl=impl)[0], seq_carry=True)
    return _logits(cfg, model, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Per-layer conv tails (L, B, K-1, DI) and float32 states (L, B, DI, N);
    ``max_len`` is not needed (the state has a fixed size). Under a mesh each
    rank holds its block (``layers.alloc_cache``: DI on ``model``)."""
    dt = dtype or L.compute_dtype(cfg)
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"pos": 0, **L.alloc_cache(cfg, {
        "conv": ((cfg.n_layers, batch, k - 1, di), dt, 0),
        "h": ((cfg.n_layers, batch, di, n), torch.float32, 0)}, batch, device)}


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: MambaLM, cache: dict, tokens: torch.Tensor,
                impl: str = "auto"):
    """tokens (B, 1) -> (logits (B, 1, V), cache); the cache is updated in
    place and returned."""
    cdt = L.compute_dtype(cfg)
    x = L.embed_rows(model.embed, tokens, cdt)
    shardings = L.layer_shardings(model.blocks)
    for layer, p in enumerate(L.unbind_layers(model.blocks)):
        state = {"conv": cache["conv"][layer], "h": cache["h"][layer]}
        x, new = mamba1_block(cfg, x, L.cast_params(p, cdt, shardings), state=state, impl=impl)
        cache["conv"][layer] = new["conv"]
        cache["h"][layer] = new["h"]
    cache["pos"] = int(cache["pos"]) + 1
    return _logits(cfg, model, x), cache
