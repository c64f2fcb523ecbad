"""PaliGemma-style VLM in PyTorch: stubbed SigLIP patch embeddings and the
gemma decoder; counterpart of ``repro.models.vlm``.

The vision tower is a stub, as in the JAX package: precomputed patch
embeddings (B, n_img_tokens, D) are prepended to the text embeddings and
seen by every query (prefix-LM), the PaliGemma setup of the text backbone.
Decode is plain causal: the image prefix is expected in the cache already.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import transformer

DenseLM = transformer.DenseLM
init_params = transformer.init_params
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def forward(cfg: ArchConfig, model: DenseLM, tokens: torch.Tensor, patches: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """tokens (B, S_text), patches (B, P, D) -> logits (B, P + S_text, V)."""
    return transformer.forward(cfg, model, tokens, extra_embeds=patches,
                               prefix_len=cfg.n_img_tokens, impl=impl)
