"""Step functions of the port; counterpart of ``repro.launch.steps``.

The Cocktail integration point is the ``weights`` field of the batch: the
scheduler's per-EC sample counts become per-sample weights, so the weighted
mean loss implements the parameter server's |D_j|-weighted aggregation
(paper eq. 15) exactly. One card is one data-parallel group: no mesh.
"""
from __future__ import annotations

import torch

from ..models import ModelApi
from ..optim import AdamWConfig, AdamWState, cosine_schedule
from ..optim.adamw import adamw_update_


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
    parameters."""
    if warmup_steps < 0:
        warmup_steps = max(min(100, total_steps // 10), 1)

    def train_step(params, opt_state: AdamWState, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        loss, aux = model.loss(params, batch)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        lr_scale = cosine_schedule(opt_state.step, total_steps, warmup_steps)
        opt_state, om = adamw_update_(named, grads, opt_state, opt_cfg, lr_scale)
        return params, opt_state, {"loss": loss.detach(), "tokens": aux["tokens"], **om}

    return train_step


def make_serve_step(model: ModelApi):
    """(params, cache, tokens (B, 1)) -> (greedy next tokens (B, 1) int32,
    cache)."""
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
