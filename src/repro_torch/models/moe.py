"""Mixture-of-experts FFN (Mixtral-style top-k) in PyTorch; counterpart of
``repro.models.moe``.

The JAX package's function is ported as it is, capacity-bounded: token t's
k-th choice goes to slot (expert e, rank) where the rank is its place among
e's assignments in (token, k) order, and assignments at rank >= C are
dropped (zero output). A dropless MoE computes another function. The rank
runs over the B x S tokens of a call: without a mesh all of them (the JAX
package's G = 1); under a mesh a data-parallel rank's own rows, which is the
JAX package's shard-local grouping with G = dp and the capacity computed
from a group's tokens (``parallel.sharding.local_rows`` raises where the
global batch does not divide into the ranks, where the JAX package would
fall back to G = 1). Dispatch is ``index_add`` into an (E C + 1, D)
buffer (the last row takes the dropped assignments), the expert products are
batched ``matmul`` over E, and the combine is a gather; the JAX package
computes these outside any Pallas kernel too. Under tensor parallelism the
router stays whole, so the dispatch is the same on every ``model`` rank;
``we_gate`` / ``we_up`` hold the rank's ffn columns and ``we_down`` its ffn
rows, and the combined output is summed over ``model`` once (g). Under
autograd the dispatched tokens and the gates pass through f (the gates
scale partial expert outputs), the router reading the tokens directly.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel.sharding import tp_all_reduce
from . import layers as L

# Where a list is set (``recording_routing``), each ``moe_ffn`` call appends
# its (expert ids (T, k), kept (T, k)): a check of the routing, not a path.
_routing_log: Optional[list] = None


def moe_shapes(cfg: ArchConfig, n_layers: int) -> dict[str, tuple[int, ...]]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (n_layers, d, e), "we_gate": (n_layers, e, d, ff),
            "we_up": (n_layers, e, d, ff), "we_down": (n_layers, e, ff, d)}


def init_draws(cfg: ArchConfig) -> dict[str, dict]:
    """name -> ``layers.dense_fill_`` keywords of the MoE leaves: the JAX
    package's scales, the fan-in taken after the layer and expert axes."""
    if cfg.family != "moe":
        return {}
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    return {"router": {}, "we_gate": {"lead": 2}, "we_up": {"lead": 2},
            "we_down": {"lead": 2, "scale": out_scale * math.sqrt(cfg.d_ff)}}


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots an expert: ceil(T k / E x capacity factor), rounded up to a
    multiple of 8 and at least 8."""
    c = math.ceil(n_tokens * cfg.n_experts_per_tok / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


@contextlib.contextmanager
def recording_routing() -> Iterator[list]:
    """Within the block, every ``moe_ffn`` call appends its (expert ids,
    kept) pair, each (T, k), to the list it yields."""
    global _routing_log
    prev, _routing_log = _routing_log, []
    try:
        yield _routing_log
    finally:
        _routing_log = prev


def route(cfg: ArchConfig, xf: torch.Tensor, router: torch.Tensor):
    """xf (T, D) -> (gates (T, k) float32, expert ids (T, k), slot (T k,),
    kept (T k,)): the router and its softmax in float32, top-k over the
    probabilities, gates renormalised, ranks in (token, k) order; a dropped
    assignment's slot is the spill row E C."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    c = capacity(cfg, t)
    probs = torch.softmax(torch.matmul(xf.float(), router.float()), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    flat_e = gate_idx.reshape(t * k)
    onehot = F.one_hot(flat_e, e)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, e * c)
    return gate_vals, gate_idx, slot, keep


def moe_ffn(cfg: ArchConfig, x: torch.Tensor, p: dict, tp_sharded: bool = False
            ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); ``tp_sharded``: the experts' ffn dim is
    this rank's block, so the combine is a partial sum, all-reduced."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.n_experts_per_tok
    c = capacity(cfg, t)
    xf = x.reshape(t, d)
    gate_vals, gate_idx, slot, keep = route(cfg, xf, p["router"])
    if _routing_log is not None:
        _routing_log.append((gate_idx, keep.reshape(t, k)))
    kept = keep[:, None].to(x.dtype)
    xr = L.column_input(xf, tp_sharded)[:, None, :].expand(t, k, d).reshape(t * k, d) * kept
    expert_in = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device).index_add(
        0, slot, xr)[:e * c].reshape(e, c, d)
    h = L.activate(L.matmul(expert_in, p["we_gate"]), cfg.act) * L.matmul(expert_in, p["we_up"])
    out = L.matmul(h, p["we_down"]).reshape(e * c, d)  # (E, C, D) -> (E C, D)
    out = torch.cat([out, out.new_zeros((1, d))])  # the spill row reads zeros
    # The gates scale partial expert outputs: f, so the router's gradient is whole.
    gates = L.column_input(gate_vals.reshape(t * k, 1).to(out.dtype), tp_sharded) * \
        kept.to(out.dtype)
    weighted = torch.index_select(out, 0, slot) * gates
    combined = weighted.reshape(t, k, d).sum(dim=1)
    if tp_sharded:
        combined = tp_all_reduce(combined)
    return combined.reshape(b, s, d).to(x.dtype)


def router_aux_loss(cfg: ArchConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """Switch-style load-balancing loss: E sum_e f_e P_e."""
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(torch.matmul(xf.float(), p["router"].float()), dim=-1)
    idx = torch.topk(probs, k, dim=-1).indices
    f = F.one_hot(idx, e).float().sum(dim=1).mean(dim=0)
    return e * torch.sum(f * probs.mean(dim=0))
