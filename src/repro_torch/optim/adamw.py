"""AdamW with decoupled weight decay and global-norm clipping; counterpart of
``repro.optim.adamw``, with the same arithmetic in float32.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``). ``adamw_update_`` writes the
parameters and the moments in place, a leaf at a time and a chunk of each
leaf at a time, so the update holds no second copy of any leaf: at full
width the float32 master weights, both moments and the gradients are most
of the card's memory. Under a mesh the parameters are each rank's blocks
(``parallel.shard_params``), so the moments ``adamw_init`` makes beside
them are too (ZeRO), and the clipping norm is that of the global arrays.
``adamw_update`` is the functional form (new tensors,
inputs untouched) that the tests hold against the JAX function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional

import torch

from ..parallel.sharding import all_reduce_, model_axis, sharding_of

# Elements of a leaf updated at once: bounds the update's temporaries to
# two float32 chunks (512 MiB) whatever the leaf's size.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    m: dict  # name -> float32 first moment
    v: dict  # name -> float32 second moment


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if hasattr(params, "named_parameters") \
        else dict(params)


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 beside each parameter (a module or a name ->
    tensor mapping) and a step counter of 0."""
    named = _named(params)
    dev = next(iter(named.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
             for k, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                      v={k: torch.zeros_like(z) for k, z in zeros.items()})


# torch.dot takes at most 2**31 - 1 elements (a 32-bit BLAS count); a larger
# leaf (falcon-mamba-7b's in_proj stack: 32 x 4096 x 16384 = 2**31) sums
# its dots over pieces of at most this many, in order.
DOT_MAX = 2 ** 31 - 1


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1).float()
    if flat.numel() <= DOT_MAX:
        return torch.dot(flat, flat)
    return torch.stack([torch.dot(piece, piece) for piece in flat.split(DOT_MAX)]).sum()


def global_norm(grads: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (float32).

    Under a mesh (``shardings``: name -> each leaf's ``Sharding``), the
    norm of the global arrays: a leaf sharded over ``data`` counts the sum
    of its ranks' squares (one all-reduce over ``data`` for every leaf at
    once), a replicated leaf counts once; on a ``model`` axis above 1 the
    same over ``model`` (one more all-reduce), where the parts of a fused
    leaf that every rank holds whole (Mamba-2's B and C columns) count
    once. The leaves are then summed in the order of the unsharded norm."""
    sq = torch.stack([_sum_sq(g) for g in grads.values()])
    shardings = shardings or {}
    mesh = next((s.mesh for s in shardings.values() if s is not None), None)
    if mesh is not None:
        shs = [shardings.get(k) for k in grads]
        if model_axis(mesh) > 1:  # blocked parts on every model rank, whole ones on rank 0
            first = mesh.get_local_rank("model") == 0
            sq = torch.stack([_model_part(g, s, sq[i], first)
                              for i, (g, s) in enumerate(zip(grads.values(), shs))])
            sq = all_reduce_(sq, [mesh.get_group("model")])
        sharded = torch.tensor([s is not None and s.dim is not None for s in shs],
                               device=sq.device)
        first = mesh.get_local_rank("data") == 0
        sq = all_reduce_(torch.where(sharded | first, sq, 0.0), [mesh.get_group("data")])
    return torch.sqrt(sq.sum())


def _model_part(g: torch.Tensor, sh, sq: torch.Tensor, first: bool) -> torch.Tensor:
    """This ``model`` rank's share of a leaf's sum of squares ``sq``: all
    of a block's but the parts held whole on every rank, which rank 0
    alone counts."""
    if sh is None or sh.tp_dim is None:
        return sq if first else torch.zeros_like(sq)
    for lo, hi in ([] if first else sh.tp_whole()):
        part = g.narrow(sh.tp_dim, lo, hi - lo).float()
        sq = sq - torch.sum(part * part)
    return sq


@torch.no_grad()
def adamw_update_(params, grads: dict, state: AdamWState, cfg: AdamWConfig,
                  lr_scale: torch.Tensor | float = 1.0) -> tuple[AdamWState, dict]:
    """One AdamW step in place: clip ``grads`` by their global norm, update
    the moments of ``state`` and the parameters (a module or a name ->
    tensor mapping). Consumes ``grads``: each gradient is scaled in place
    and dropped from the dict once its leaf is updated. Returns (state with
    the next step count, {"grad_norm"})."""
    named = _named(params)
    gnorm = global_norm(grads, {k: sharding_of(named[k]) for k in grads})
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    sf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=sf.device)
    for name in list(grads):
        p, m, v = named[name], state.m[name], state.v[name]
        g = grads.pop(name)
        if g.dtype != torch.float32 or not g.is_contiguous():
            g = g.float().contiguous()
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"adamw_update_: parameter {name} must be contiguous float32 "
                             f"master weights, got {p.dtype}")
        for pc, mc, vc, gc in zip(*(t.view(-1).split(CHUNK) for t in (p, m, v, g))):
            gc.mul_(scale)
            mc.mul_(cfg.b1).add_(gc, alpha=1.0 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(gc, gc, value=1.0 - cfg.b2)
            delta = torch.div(mc, b1c)
            delta.div_(torch.div(vc, b2c).sqrt_().add_(cfg.eps))
            delta.add_(pc, alpha=cfg.weight_decay)
            pc.sub_(delta.mul_(lr))
        del g
    return AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm}


def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState, params,
                 cfg: AdamWConfig, lr_scale: torch.Tensor | float = 1.0):
    """Functional AdamW step (the JAX signature): returns (new_params,
    new_state, metrics) as new tensors and leaves the inputs as they were."""
    new_params = {k: p.detach().clone() for k, p in _named(params).items()}
    new_state = AdamWState(step=state.step.clone(),
                           m={k: t.clone() for k, t in state.m.items()},
                           v={k: t.clone() for k, t in state.v.items()})
    new_state, metrics = adamw_update_(
        new_params, {k: g.detach().clone() for k, g in grads.items()}, new_state, cfg, lr_scale)
    return new_params, new_state, metrics
