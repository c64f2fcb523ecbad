"""Matching primitives for the two per-slot subproblems -- re-export shim;
counterpart of ``repro.core.matching``.

The plain PyTorch versions live in ``repro_torch.kernels.matching.ref`` (the
CUDA kernels are held bit for bit against them). This module keeps the
``core.matching`` names importable. Production call sites go through the
dispatch layer ``repro_torch.kernels.matching.ops`` (the CUDA kernels on the
card, these versions on the CPU); exact oracles for the Thm.-1 / Thm.-2
graph constructions live in ``repro_torch.core.oracle``.
"""
from __future__ import annotations

from ..kernels.matching.ref import (  # noqa: F401
    _marginal_penalty,
    greedy_assignment_ref as greedy_assignment,
    greedy_collection_ref as greedy_collection,
    greedy_pairing_ref as greedy_pairing,
)

_NEG = -1e30

__all__ = ["greedy_collection", "greedy_assignment", "greedy_pairing"]
