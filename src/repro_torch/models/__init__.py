"""Model facade of the port: ``build_model(cfg, impl, device)`` returns one
API for every architecture family (counterpart of ``repro.models``).

Families: ``dense`` and ``moe`` (``transformer.DenseLM``), ``ssm``
(``ssm.MambaLM``, Mamba-1), ``hybrid`` (``hybrid.HybridLM``, Mamba-2 + a
shared attention block), ``encdec`` (``encdec.EncDecLM``) and ``vlm``
(``vlm``: the dense backbone with an image prefix). Entry points run on the
CUDA card unless the caller names another device.

Batch dict convention:
  tokens  (B, S) integer token ids      always
  labels  (B, S) integer, -1 = masked   training (``loss``)
  weights (B,) float32                  optional Cocktail per-sample weights
                                        (the |D_j| aggregation of eq. 15)
  denom   () float32                    optional global loss denominator
                                        (a data-parallel rank's batch)
  patches (B, P, D) float               vlm only (stub frontend)
  frames  (B, enc_ctx, D) float         encdec only (stub frontend)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..parallel.sharding import check_decode, current_mesh, empty_blocks
from . import encdec, hybrid, ssm, transformer, vlm
from .layers import vocab_parallel, weighted_cross_entropy

# family -> (module with init_params / forward / init_cache / decode_step, model class)
_FAMILIES = {
    "dense": (transformer, transformer.DenseLM), "moe": (transformer, transformer.DenseLM),
    "ssm": (ssm, ssm.MambaLM), "hybrid": (hybrid, hybrid.HybridLM),
    "encdec": (encdec, encdec.EncDecLM), "vlm": (vlm, vlm.DenseLM),
}
# The stub frontends' inputs that a family's forward takes besides the tokens.
_EXTRA_INPUT = {"encdec": "frames", "vlm": "patches"}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., nn.Module]  # (seed, dtype=None, mesh=None) -> model with drawn weights
    forward: Callable[..., torch.Tensor]  # (model, batch) -> logits (B, S, V)
    loss: Callable[..., tuple]  # (model, batch) -> (loss, {"ce", "tokens"})
    init_cache: Callable[..., Any]  # (batch_size, max_len) -> cache
    decode_step: Callable[..., tuple]  # (model, cache, tokens (B, 1)) -> (logits, cache)


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device; without a card only an
    explicit non-CUDA device (``device="cpu"``) is accepted."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def _family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; known: {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def new_model(cfg: ArchConfig, device, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The family's module with uninitialised parameters on ``device``."""
    return _family(cfg)[1](cfg, device=device, dtype=dtype)


def _lm_loss(cfg: ArchConfig, fwd):
    """(model, batch) -> (weighted mean CE, {"ce", "tokens"}): the
    counterpart of the JAX package's ``_lm_loss``; the VLM's image prefix
    positions get label -1. ``batch["denom"]``, where set, is the global
    denominator of a data-parallel rank's rows (``launch/steps.py``). A
    vocab-sharded head's logits stay each rank's block (the vocab-parallel
    cross-entropy)."""
    def loss_fn(model, batch):
        with vocab_parallel():
            logits = fwd(model, batch)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # vlm: image prefix positions
            pad = labels.new_full((labels.shape[0], logits.shape[1] - labels.shape[1]), -1)
            labels = torch.cat([pad, labels], dim=1)
        loss, denom = weighted_cross_entropy(logits, labels, batch.get("weights"),
                                             denom=batch.get("denom"),
                                             vocab_parallel=logits.shape[-1] < cfg.vocab_size)
        return loss, {"ce": loss, "tokens": denom}
    return loss_fn


def build_model(cfg: ArchConfig, impl: str = "auto", device=None) -> ModelApi:
    """The model API of ``cfg`` on ``device`` (CUDA by default). ``impl``
    picks the attention / scan path (``auto``: the CUDA kernels on the card,
    the plain versions on the CPU)."""
    mod = _family(cfg)[0]
    dev = resolve_device(device)

    def init(seed: int = 0, dtype: Optional[torch.dtype] = None, mesh=None) -> nn.Module:
        """Weights drawn on the device from a generator seeded with ``seed``
        (float32 draws, stored in ``dtype``, default ``cfg.param_dtype``;
        serving passes the compute dtype so the cast is done once). Under
        ``mesh`` each rank keeps its block of every leaf as it is drawn
        (``parallel.sharding.empty_blocks``): the draws are the unsharded
        model's, layer by layer, and no rank holds more than one whole
        layer leaf."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if mesh is None:
            return mod.init_params(cfg, new_model(cfg, dev, dtype), gen)
        return mod.init_params(cfg, empty_blocks(new_model(cfg, "meta", dtype), mesh, dev), gen)

    extra = _EXTRA_INPUT.get(cfg.family)

    def forward(model, batch):
        if extra is None:
            return mod.forward(cfg, model, batch["tokens"], impl=impl)
        return mod.forward(cfg, model, batch["tokens"], batch[extra], impl=impl)

    def decode_step(model, cache, tokens):
        check_decode(current_mesh())
        return mod.decode_step(cfg, model, cache, tokens, impl=impl)

    return ModelApi(
        cfg=cfg, device=dev, init=init, forward=forward, loss=_lm_loss(cfg, forward),
        init_cache=lambda bs, max_len, **kw: mod.init_cache(cfg, bs, max_len, device=dev, **kw),
        decode_step=decode_step,
    )


__all__ = ["ModelApi", "build_model", "new_model", "resolve_device"]
