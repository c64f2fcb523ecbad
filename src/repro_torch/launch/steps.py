"""Step functions of the port; counterpart of ``repro.launch.steps``.

The Cocktail integration point is the ``weights`` field of the batch: the
scheduler's per-EC sample counts become per-sample weights, so the weighted
mean loss implements the parameter server's |D_j|-weighted aggregation
(paper eq. 15) exactly. Under a mesh (``parallel.mesh_context``) each
data-parallel rank holds one block of the global batch's rows (with as many
ECs as ranks, rank r holds EC r's rows) and its blocks of the sharded
parameters: the ranks' losses are divided by the global denominator, so
the sum of their gradients, which the gathers' reduce-scatters and the
replicated leaves' all-reduces form, is the gradient of the global weighted
mean.
"""
from __future__ import annotations

import torch

from ..models import ModelApi
from ..models.layers import loss_denominator
from ..optim import AdamWConfig, AdamWState, cosine_schedule
from ..optim.adamw import adamw_update_
from ..parallel.sharding import all_reduce_, batch_groups, current_mesh, gather_axes, sharding_of


def make_train_step(model: ModelApi, opt_cfg: AdamWConfig, total_steps: int = 10_000,
                    warmup_steps: int = -1):
    """(params, opt_state, batch) -> (params, opt_state, metrics{loss,
    tokens, grad_norm}); ``params`` is the model (float32 master weights)
    and is updated in place, as are the moments of ``opt_state``.

    The loss is differentiated with respect to the compute-type cast of the
    parameters (the cast is per layer, inside the forward), so the gradient
    is that of the JAX step's ``bf16_comms`` default, taken to float32 by
    the cast's backward; the JAX package's bf16 scatter into the embedding
    gradient accumulates in float32 here. Turns on ``requires_grad`` of the
    parameters.

    Under a mesh, ``params`` holds this rank's parameter blocks
    (``parallel.shard_params``) and ``batch`` this rank's rows: the loss
    denominator sum(valid * w) is summed over the batch axes before the
    forward and divides each rank's sum(w * nll); a sharded leaf's gradient
    is reduce-scattered over its own axes by its gather's backward
    (``sharding.gather_axes``: ``data``; ``data`` and ``model`` under
    ``fsdp``) and summed over the other batch axes, a replicated leaf's is
    summed over every batch axis; the reported loss is the global one. On
    a ``model`` axis above 1 in the ``tp``, ``tp_sp`` and ``serve`` styles
    each ``model`` rank computes the same loss from the same rows: a leaf
    blocked on ``model`` gets its block's gradient, and a replicated one
    its whole gradient, equal on every ``model`` rank, by the f / g pair in
    the forward (``parallel.sharding``), so nothing is reduced over
    ``model``; the cross-entropy runs over the vocab blocks. Under
    ``fsdp`` ``model`` is a batch axis like ``data``."""
    if warmup_steps < 0:
        warmup_steps = max(min(100, total_steps // 10), 1)

    def train_step(params, opt_state: AdamWState, batch):
        mesh = current_mesh()
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        if mesh is not None:
            denom = loss_denominator(batch["labels"], batch.get("weights"))
            batch = {**batch, "denom": all_reduce_(denom, batch_groups(mesh))}
        loss, aux = model.loss(params, batch)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        loss = loss.detach()
        if mesh is not None:
            for k, g in grads.items():
                g = grads[k] = g.contiguous()
                all_reduce_(g, batch_groups(mesh, skip=gather_axes(sharding_of(named[k]))))
            all_reduce_(loss, batch_groups(mesh))
        lr_scale = cosine_schedule(opt_state.step, total_steps, warmup_steps)
        opt_state, om = adamw_update_(named, grads, opt_state, opt_cfg, lr_scale)
        return params, opt_state, {"loss": loss, "tokens": aux["tokens"], **om}

    return train_step


def make_serve_step(model: ModelApi):
    """(params, cache, tokens (B, 1)) -> (greedy next tokens (B, 1) int32,
    cache). The argmax runs over the whole vocab (gathered under tensor
    parallelism), so ties go to the first index as in the unsharded step."""
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_prefill_step(model: ModelApi):
    """(params, batch) -> logits (B, S, V) of the whole prompt."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.forward(params, batch)

    return prefill_step
