"""Shared building blocks of the port's language models (plain PyTorch);
counterpart of ``repro.models.layers``.

Tensor parallelism (a ``model`` axis above 1): a rank holds its block of
every leaf that the rule table puts on ``model`` (``parallel.sharding``), so
a layer reads its local head, kv-head, ffn, channel and Mamba-2 head counts
off its own leaves (``local_counts``); a product whose contracting dim is on
``model`` ends in one all-reduce (``row_parallel``: Megatron's g), and the
replicated input of a column-parallel product passes through f
(``sharding.tp_copy``) once. Serving gathers the logits along the vocab
(``vocab_logits``); a loss (``vocab_parallel``) keeps each rank's vocab
block and takes the cross-entropy over the blocks (``weighted_cross_entropy``:
three small all-reduces, the (B, S, V) logits never gathered). A decode
cache is allocated as ``launch.specs.cache_pspecs`` places it
(``alloc_cache``).

The other styles (``parallel.sharding``): under ``tp_sp`` the layers run
as under ``tp`` and the carry between them is each ``model`` rank's block
of positions (``apply_layers``); under ``fsdp`` every leaf is gathered whole
at its use (``cast_params``, ``weight``), ``tp_rank()`` is 0 and
``tp_size()`` 1, so ``local_counts`` reports no block and the f / g pair,
the vocab-parallel lookup and the vocab-parallel cross-entropy take their
unsharded forms by themselves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.sharding import (_tp_reduce_, axis_sizes, check_decode, current_mesh,
                                 embed_rows, gather_fsdp, gather_params, seq_gather,
                                 seq_parallel, seq_split, sharding_of, tp_all_gather,
                                 tp_all_reduce, tp_copy, tp_rank)


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
    ``Sharding``) are then gathered over ``data`` (over ``data`` and
    ``model`` under ``fsdp``: ``gather_params``, one collective a layer for
    each set of axes, the cast type on the wire, the gradients
    reduce-scattered)."""
    return gather_params({k: cast(v, dtype) for k, v in p.items()}, shardings or {})


def layer_shardings(blocks, stacked: bool = True) -> dict:
    """name -> the ``Sharding`` of one layer's view of each stacked leaf of
    ``blocks`` (of each leaf, where not ``stacked``); sharded models only."""
    return {k: sh.per_layer() if stacked else sh
            for k, v in blocks.items() if (sh := sharding_of(v)) is not None}


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A top-level weight (head, tied embedding) in ``dtype``, its ``data``
    shard gathered; a ``model`` block stays this rank's, except under
    ``fsdp``, which gathers it too."""
    return gather_fsdp(cast(w, dtype), sharding_of(w))


@dataclasses.dataclass(frozen=True)
class LocalCounts:
    """A layer's counts on this rank, read off its leaves: q heads (first
    global head ``q0``), kv heads, ffn columns, Mamba channels (first global
    channel ``c0``) and Mamba-2 heads (first ``h0``), and whether each is a
    ``model`` block (then its row-parallel product ends in an all-reduce and
    its column-parallel input passes through f). The kv heads of a block of
    q heads are ``kv0`` .. ``kv0 + kv_heads``; where ``wk`` / ``wv`` are
    whole (MQA, kv heads that do not divide) ``kv_whole`` is set and a rank
    computes every kv head."""

    rank: int
    heads: int = 0
    q0: int = 0
    heads_sharded: bool = False
    kv_heads: int = 0
    kv0: int = 0
    kv_whole: bool = True
    ffn_sharded: bool = False
    inner: int = 0
    c0: int = 0
    inner_sharded: bool = False
    ssm_heads: int = 0
    h0: int = 0


def local_counts(cfg, p: dict, prefix: str = "") -> LocalCounts:
    """``LocalCounts`` of one layer's (cast) parameters ``p``; ``prefix``
    names an attention's leaves (``cross_``)."""
    r = tp_rank()
    kw: dict[str, Any] = {}
    if prefix + "wq" in p:
        h, hkv = cfg.padded_heads, cfg.n_kv_heads
        heads = p[prefix + "wq"].shape[1]
        kw.update(heads=heads, q0=r * heads if heads < h else 0, heads_sharded=heads < h)
        group = h // hkv
        if p[prefix + "wk"].shape[1] < hkv:  # a kv block beside its q block
            kw.update(kv_heads=p[prefix + "wk"].shape[1], kv0=kw["q0"] // group,
                      kv_whole=False)
        elif heads < h:  # whole kv: the heads that this q block reads
            if heads % group and group % heads:
                raise ValueError(f"a block of {heads} q heads does not align with kv groups "
                                 f"of {group}")
            kw.update(kv_heads=max(heads // group, 1), kv0=kw["q0"] // group)
        else:
            kw.update(kv_heads=hkv)
    ff = p.get("w_up", p.get("we_up"))
    if ff is not None:
        kw["ffn_sharded"] = ff.shape[-1] < cfg.d_ff
    if "x_proj" in p:  # Mamba-1: in_proj holds [x_r | z_r]
        inner = p["in_proj"].shape[-1] // 2
        kw.update(inner=inner, c0=r * inner, inner_sharded=inner < cfg.d_inner)
    elif "gate_norm" in p:  # Mamba-2: in_proj holds [z_r | x_r | B | C | dt_r]
        inner = p["conv_w"].shape[0]
        heads = inner // cfg.ssm_head_dim
        if p["in_proj"].shape[-1] != 2 * inner + 2 * cfg.ssm_state + heads:
            raise NotImplementedError(
                f"a Mamba-2 in_proj of {p['in_proj'].shape[-1]} columns beside {inner} "
                f"channels on this rank (the fused parts on model, or none)")
        kw.update(inner=inner, c0=r * inner, inner_sharded=inner < cfg.d_inner,
                  ssm_heads=heads, h0=r * heads)
    return LocalCounts(rank=r, **kw)


def row_parallel(x: torch.Tensor, w: torch.Tensor, sharded: bool) -> torch.Tensor:
    """``matmul(x, w)``, summed over the ``model`` group where ``w``'s
    contracting dim is a ``model`` block (one all-reduce, in the product's
    type: the partial sums are rounded to it first, as the JAX package's
    partitioner rounds them; g under autograd)."""
    y = matmul(x, w)
    return tp_all_reduce(y.contiguous()) if sharded else y


def column_input(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The replicated input of a column-parallel product: through f
    (``tp_copy``) where the product's columns are a ``model`` block."""
    return tp_copy(x) if sharded else x


_VOCAB_BLOCKS = False


@contextlib.contextmanager
def vocab_parallel():
    """Within the block, ``vocab_logits`` returns each rank's vocab block of
    a vocab-sharded head's logits, ungathered (a loss's forward)."""
    global _VOCAB_BLOCKS
    prev, _VOCAB_BLOCKS = _VOCAB_BLOCKS, True
    try:
        yield
    finally:
        _VOCAB_BLOCKS = prev


def vocab_logits(x: torch.Tensor, head: torch.Tensor, vocab_size: int,
                 cap: float = 0.0) -> torch.Tensor:
    """``x @ head`` (head (D, V) or this rank's (D, V / m) block), soft-capped
    in float32 where ``cap`` is set, then gathered along the vocab (left a
    block within ``vocab_parallel``)."""
    block = head.shape[-1] < vocab_size
    logits = matmul(column_input(x, block), head)
    if cap > 0:
        logits = logits.float()
        # In place where autograd does not record it: a prefill's float32
        # logits are the largest tensor of its peak (8.4 GB at gemma2-27b's
        # B 4 x 2048), and the same ops in place give the same bits.
        logits = (softcap(logits, cap) if logits.requires_grad
                  else logits.div_(cap).tanh_().mul_(cap))
    return tp_all_gather(logits, -1) if block and not _VOCAB_BLOCKS else logits


# A decode cache's kv leaves (their slots may be split over mesh axes), and
# the key leaves among them: "k0" / "k" / "attn_k" / "cross_k" record their
# global slot count under "slots0" / "slots" / "attn_slots" / "cross_slots"
# and the axes of the split under "slot_axes0" / ... / "cross_slot_axes".
_KV_LEAF = re.compile(r"((attn|cross)_)?(k|v|kv_pos)\d*|attn_pos")
_K_LEAF = re.compile(r"((?:attn|cross)_)?k(\d*)")


def alloc_cache(cfg, leaves: dict, batch: int, device) -> dict:
    """A decode cache from ``leaves`` (name -> (global shape, dtype, fill
    value)) of global batch ``batch``: whole without a mesh; under a live
    mesh each rank's block as ``launch.specs.cache_pspecs`` places it, and
    for every key leaf whose slots are split (over ``model``, over the
    data-parallel axes where the batch does not divide over them, or over
    both) its global slot count and the axes of the split (``_K_LEAF``).
    Raises under ``fsdp`` on a ``model`` axis above 1
    (``sharding.check_decode``)."""
    mesh = current_mesh()
    check_decode(mesh)
    if mesh is None or not hasattr(mesh, "get_group"):
        return {k: torch.full(shape, fill, dtype=dt, device=device)
                for k, (shape, dt, fill) in leaves.items()}
    from ..launch.specs import cache_pspecs, local_shape, seq_axes
    specs = cache_pspecs(cfg, {k: v[0] for k, v in leaves.items()}, mesh, batch)
    sizes = axis_sizes(mesh)
    out: dict[str, Any] = {}
    for k, (shape, dt, fill) in leaves.items():
        out[k] = torch.full(local_shape(shape, specs[k], mesh), fill, dtype=dt, device=device)
        axes = seq_axes(specs[k]) if len(shape) >= 3 and _KV_LEAF.fullmatch(k) else ()
        key = _K_LEAF.fullmatch(k)
        if key and math.prod(sizes[a] for a in axes) > 1:
            out[f"{key.group(1) or ''}slots{key.group(2)}"] = shape[2]
            out[f"{key.group(1) or ''}slot_axes{key.group(2)}"] = axes
    return out


def slot_split(cache: dict, key: str) -> tuple[int, tuple[str, ...]]:
    """(global slot count, mesh axes its slots are split over) of the key
    leaf ``key`` of a decode cache (layer-stacked); (its slot count, ())
    where each rank holds every slot."""
    m = _K_LEAF.fullmatch(key)
    pre, i = m.group(1) or "", m.group(2)
    return cache.get(f"{pre}slots{i}", cache[key].shape[2]), cache.get(f"{pre}slot_axes{i}", ())


def apply_layers(cfg, blocks, x: torch.Tensor, layer_fn: Callable, group: int = 1,
                 group_end: Optional[Callable] = None, seq_carry: bool = False) -> torch.Tensor:
    """x through every layer of ``blocks`` (a dict of stacked (L, ...)
    leaves): ``layer_fn(x, p, layer)`` gets the layer's parameters cast to
    the compute type, and ``group_end(x, g)``, where given, runs after each
    ``group`` consecutive layers (the hybrid's shared block). Sharded
    leaves are gathered right after the cast (``cast_params``). When the
    forward is recorded for a backward and ``cfg.remat`` is set, each group
    is recomputed in the backward (``torch.utils.checkpoint``, as the JAX
    package's ``jax.checkpoint`` of the scanned body), the casts and the
    gathers included.

    ``seq_carry``: the family's block output is the JAX package's
    ``("batch", "seq", None)``. Under ``tp_sp`` on a ``model`` axis above 1
    that divides the positions (``sharding.seq_parallel``), x is split to
    this rank's block of positions before the first group; each group
    all-gathers it first (``seq_gather``) and keeps this rank's block of its
    output last (``seq_split``), so a recomputed group saves only the block;
    the output is gathered whole again for the final norm. Elsewhere the
    carry stays whole."""
    cdt = compute_dtype(cfg)
    # recorded for a backward: grad mode on and a parameter that requires
    # grad (serving models have none)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in blocks.values())
    seq = seq_carry and seq_parallel(x.shape[1])
    per_layer = unbind_layers(blocks)
    shardings = layer_shardings(blocks)
    names = tuple(per_layer[0])
    if seq:
        x = seq_split(x)
    for g0 in range(0, len(per_layer), group):
        layers = per_layer[g0:g0 + group]

        def run(x, *leaves, g0=g0, n=len(layers)):
            if seq:
                x = seq_gather(x)
            for i in range(n):
                p = dict(zip(names, leaves[i * len(names):(i + 1) * len(names)]))
                x = layer_fn(x, cast_params(p, cdt, shardings), g0 + i)
            x = x if group_end is None else group_end(x, g0 // group)
            return seq_split(x) if seq else x

        leaves = [v for p in layers for v in p.values()]
        if remat:
            x = torch.utils.checkpoint.checkpoint(run, x, *leaves, use_reentrant=False)
        else:
            x = run(x, *leaves)
    return seq_gather(x) if seq else x


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


def _block_sharding(out: torch.Tensor, lead: int):
    """(the global shape of one trailing block of ``out``, the ``Sharding``
    of that block or None)."""
    sh = sharding_of(out)
    if sh is None:
        return tuple(out.shape[lead:]), None
    for _ in range(lead):
        sh = sh.per_layer()
    return sh.global_shape, sh


@torch.no_grad()
def dense_fill_(out: torch.Tensor, gen: torch.Generator, lead: int = 1, in_axis: int = 0,
                scale: float = 1.0) -> torch.Tensor:
    """Fills ``out`` with the JAX package's dense initialiser, N(0, 1) * scale
    / sqrt(fan_in) over the dims after its ``lead`` stacked axes (layers,
    experts), which do not count in the fan-in. Drawn in float32 one trailing
    block (a layer's or an expert's leaf) at a time and stored in ``out``'s
    type, so the float32 transient is one block, never the whole stack. A
    sharded ``out`` (``parallel.sharding.empty_blocks``) draws each global
    block and keeps this rank's: the draws are the unsharded model's."""
    shape, sh = _block_sharding(out, lead)
    s = scale / math.sqrt(shape[in_axis])
    for block in out.view(-1, *out.shape[lead:]):
        full = _normal(shape, gen, out.device).mul_(s)
        block.copy_(full if sh is None else sh.local(full))
    return out


@torch.no_grad()
def embed_fill_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    shape, sh = _block_sharding(out, 0)
    full = _normal(shape, gen, out.device).mul_(0.02)
    return out.copy_(full if sh is None else sh.local(full))


def loss_denominator(labels: torch.Tensor, weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """sum of valid * w over the batch (the count of valid labels without
    weights): the weighted mean's denominator, from labels and weights
    only, so a data-parallel step sums it over the ranks before its forward."""
    valid = labels >= 0
    if weights is not None:
        return torch.sum(valid * weights[:, None])
    return torch.sum(valid).float()


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token -log softmax(logits)[label] over the vocab blocks of the
    ``model`` group (this rank's (B, S, V / m) float32 block, first column
    ``tp_rank() x V / m``): the max by one all-reduce MAX, the sum of
    exponentials and the label's logit (a masked gather) by one all-reduce
    SUM each, every rank computing the same (B, S) result. The backward is
    the local softmax minus the local one-hot, times the incoming gradient
    (replicated, as the loss is)."""

    @staticmethod
    def forward(ctx, logits, labels):
        v = logits.shape[-1]
        mx = _tp_reduce_(logits.amax(dim=-1), dist.ReduceOp.MAX)
        e = torch.exp(logits - mx[..., None])
        se = _tp_reduce_(e.sum(dim=-1))
        idx = labels - tp_rank() * v
        inside = (idx >= 0) & (idx < v)
        idx = idx.clamp(0, v - 1)
        target = torch.gather(logits, -1, idx[..., None])[..., 0]
        target = _tp_reduce_(torch.where(inside, target, 0.0))
        ctx.save_for_backward(e.div_(se[..., None]), idx, inside)
        return torch.log(se) + mx - target

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax * g[..., None]
        grad.scatter_add_(-1, idx[..., None], torch.where(inside, -g, 0.0)[..., None])
        return grad, None


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           logit_softcap: float = 0.0,
                           denom: Optional[torch.Tensor] = None,
                           vocab_parallel: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in float32 with optional per-SAMPLE weights (the
    Cocktail |D_j| aggregation of eq. 15 folds into these weights). Returns
    (loss, n_tokens); labels < 0 are masked out. ``denom`` (a data-parallel
    rank's global ``loss_denominator``) replaces the batch's own, so the
    ranks' losses sum to the global weighted mean. ``vocab_parallel``:
    ``logits`` are this rank's vocab block (``vocab_logits`` within
    ``vocab_parallel()``) and the log-sum-exp runs over the ``model``
    group's blocks (``_VocabParallelNLL``)."""
    if logit_softcap > 0:
        logits = softcap(logits, logit_softcap)
    logits = logits.float()
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    if vocab_parallel:
        nll = _VocabParallelNLL.apply(logits, lab) * valid
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (lse - ll) * valid
    if weights is not None:
        nll = nll * weights[:, None]
    if denom is None:
        denom = loss_denominator(labels, weights)
    return torch.sum(nll) / torch.clamp(denom, min=1.0), denom
