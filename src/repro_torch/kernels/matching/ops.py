"""Dispatch layer for the three greedy matching primitives.

The scheduler's entry points for its per-slot matchers:

  * ``greedy_collection`` -- skew-aware P1' (``datasche._collect_skew``)
  * ``greedy_assignment`` -- plain P1 (``datasche._collect_plain``: NO-SDC and
    the L-DS virtual step)
  * ``greedy_pairing``    -- Thm.-2 EC pairing (``datasche._train_generic``)

``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``"kernel"`` and ``"ref"`` force one (the
kernel raises on a CPU tensor). There is no fallback: a kernel that fails on
a CUDA tensor raises.

Optional ``cu_mask`` (..., N) / ``ec_mask`` (..., M) entity masks force the
weight of any pair touching a padded entity to ``MASKED_WEIGHT`` here, once,
before dispatch, so kernel and plain version stay mask-free. Leading batch
axes are flattened into one axis (one CUDA block per problem; pairing one
warp per problem).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.types import MASKED_WEIGHT, mask_pairs
from . import kernel
from .ref import (greedy_assignment_ref, greedy_collection_ref,
                  greedy_pairing_values, pairing_value_matrix, penalty_table)


def _resolve_impl(impl: str, t: torch.Tensor) -> str:
    if impl == "auto":
        return "kernel" if t.is_cuda else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown matching impl {impl!r}; "
                         "expected 'auto', 'kernel' or 'ref'")
    return impl


def _entity_masked(w, cu_mask, ec_mask):
    if cu_mask is None and ec_mask is None:
        return w
    cu = cu_mask if cu_mask is not None else torch.ones_like(w[..., :, 0])
    ec = ec_mask if ec_mask is not None else torch.ones_like(w[..., 0, :])
    return mask_pairs(w, cu, ec)


def _flat(w: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> contiguous float32 (K, R, C)."""
    return w.reshape(-1, *w.shape[-2:]).to(torch.float32).contiguous()


def greedy_assignment(w: torch.Tensor, cu_mask: Optional[torch.Tensor] = None,
                      ec_mask: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> torch.Tensor:
    """Plain-P1 assignment: w (..., N, M) -> alpha (..., N, M) in {0,1} with
    at most one EC per CU and one CU per EC, by descending weight."""
    w = _entity_masked(w, cu_mask, ec_mask)
    if _resolve_impl(impl, w) == "ref":
        return greedy_assignment_ref(w)
    return kernel.greedy_assignment_cuda(_flat(w)).reshape(w.shape)


def greedy_collection(logw: torch.Tensor, cu_mask: Optional[torch.Tensor] = None,
                      ec_mask: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Skew-aware P1' collection: logw (..., N, M) -> (alpha, theta), both
    (..., N, M); theta = alpha / max(n_j, 1) on the selected connections."""
    logw = _entity_masked(logw, cu_mask, ec_mask)
    if _resolve_impl(impl, logw) == "ref":
        return greedy_collection_ref(logw)
    pen = penalty_table(logw.shape[-2], logw.device)
    alpha = kernel.greedy_collection_cuda(_flat(logw), pen).reshape(logw.shape)
    count = torch.sum(alpha, dim=-2, keepdim=True)
    return alpha, alpha / torch.clamp(count, min=1.0)


def greedy_pairing(solo: torch.Tensor, pair: torch.Tensor,
                   ec_mask: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Thm.-2 EC pairing: solo (..., M) and pair (..., M, M) values -> the
    symmetric match matrix (..., M, M); match[j,j]=1 solo, match[j,k]=1
    paired. A masked EC gets MASKED_WEIGHT solo and pair values."""
    if ec_mask is not None:
        solo = torch.where(ec_mask > 0, solo, torch.full_like(solo, MASKED_WEIGHT))
        pair = mask_pairs(pair, ec_mask, ec_mask)
    w = pairing_value_matrix(solo, pair)
    if _resolve_impl(impl, w) == "ref":
        return greedy_pairing_values(w)
    return kernel.greedy_pairing_cuda(_flat(w)).reshape(w.shape)
