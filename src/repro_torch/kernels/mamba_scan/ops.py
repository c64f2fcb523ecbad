"""Mamba-1 selective scan: the plain chunked version and the dispatch that
the models call; counterpart of ``repro.kernels.mamba_scan.ops`` (Mamba-1
only: the Mamba-2 scan comes with the hybrid models, ROADMAP.md).

``mamba1_scan(..., impl="auto")`` launches the CUDA kernel (``kernel.py``)
for CUDA tensors -- prefill and decode (S = 1, with h0) alike, as the JAX
package runs its Pallas kernel on a TPU -- and ``mamba1_scan_chunked`` for
CPU tensors. ``"kernel"``, ``"chunked"`` and ``"ref"`` force one path; the
kernel raises on a CPU tensor. There is no fallback.

Gradients: the kernel has no backward (nor has the Pallas scan), so the
kernel route raises when autograd records the call; it never falls back to
the chunked version unasked. The plain versions are differentiated by
autograd, as JAX differentiates ``mamba1_scan_chunked`` off the TPU.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import mamba1_scan_ref

IMPLS = ("auto", "kernel", "chunked", "ref")


def _pick_chunk(s: int, chunk: int) -> int:
    c = min(chunk, s)
    while s % c:
        c //= 2
    return max(c, 1)


def _inclusive_scan(da: torch.Tensor, dbx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the affine maps h -> da * h + dbx
    (log-depth doubling), composed left to right: returns (A, B) with
    A[t] = da[t] ... da[0] and B[t] the state at t from a zero state."""
    s = da.shape[1]
    off = 1
    while off < s:
        a_prev = torch.ones_like(da)
        b_prev = torch.zeros_like(dbx)
        a_prev[:, off:] = da[:, :-off]
        b_prev[:, off:] = dbx[:, :-off]
        da, dbx = da * a_prev, da * b_prev + dbx
        off *= 2
    return da, dbx


def mamba1_scan_chunked(x, dt, a, b, c, h0=None, chunk: int = 256):
    """Chunked scan: a parallel (log-depth) scan within each chunk of the
    sequence, a sequential carry of the (B, DI, N) state across chunks. Same
    contract as ``mamba1_scan_ref``."""
    bsz, s, di = x.shape
    n = a.shape[1]
    cs = _pick_chunk(s, chunk)
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = a.float()
    y = torch.empty_like(x)
    for t0 in range(0, s, cs):
        xc = x[:, t0:t0 + cs].float()
        dtc = dt[:, t0:t0 + cs].float()
        da = torch.exp(dtc[..., None] * a[None, None])  # (B, cs, DI, N)
        dbx = (dtc * xc)[..., None] * b[:, t0:t0 + cs, None, :].float()
        a_cum, b_cum = _inclusive_scan(da, dbx)
        hs = a_cum * h[:, None] + b_cum  # (B, cs, DI, N)
        y[:, t0:t0 + cs] = torch.einsum("bsdn,bsn->bsd", hs, c[:, t0:t0 + cs].float()).to(x.dtype)
        h = hs[:, -1]
    return y, h


def mamba1_scan(x, dt, a, b, c, h0=None, chunk: int = 256, impl: str = "auto"):
    """Mamba-1 scan entry point of the models: (y, h_final), see ref.py.
    impl: auto | kernel | chunked | ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown scan impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "chunked"
    if impl == "kernel":
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, dt, a, b, c, h0)):
            raise NotImplementedError(
                "mamba1_scan: the CUDA kernel has no backward yet, so the scan cannot be "
                "trained on the card (see ROADMAP.md, Queue 2); pass impl='chunked' to "
                "differentiate the plain version")
        return kernel.mamba1_scan_cuda(x, dt, a, b, c, h0)
    if impl == "chunked":
        return mamba1_scan_chunked(x, dt, a, b, c, h0, chunk)
    return mamba1_scan_ref(x, dt, a, b, c, h0)
