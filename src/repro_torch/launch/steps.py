"""Step builders of the serving path; counterpart of the serve and prefill
halves of ``repro.launch.steps`` (training comes later, ROADMAP.md)."""
from __future__ import annotations

import torch

from ..models import ModelApi


def make_serve_step(model: ModelApi):
    """(params, cache, tokens (B, 1)) -> (greedy next tokens (B, 1) int32,
    cache)."""
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_prefill_step(model: ModelApi):
    """(params, batch) -> logits (B, S, V) of the whole prompt."""
    def prefill_step(params, batch):
        return model.forward(params, batch)

    return prefill_step
