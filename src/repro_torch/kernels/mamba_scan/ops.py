"""Selective scans: the plain chunked versions and the dispatch that the
models call; counterpart of ``repro.kernels.mamba_scan.ops``.

``mamba1_scan(..., impl="auto")`` launches the CUDA kernel (``kernel.py``)
for CUDA tensors -- prefill and decode (S = 1, with h0) alike, as the JAX
package runs its Pallas kernel on a TPU -- and ``mamba1_scan_chunked`` for
CPU tensors. ``"kernel"``, ``"chunked"`` and ``"ref"`` force one path; the
kernel raises on a CPU tensor. There is no fallback.

Gradients: when autograd records a call, the kernel route goes through
``KernelScan``, whose forward launches the forward kernel and whose backward
launches the backward kernel (``csrc/mamba1_scan_bwd.cu``; the Pallas scan
has none, JAX differentiates ``mamba1_scan_chunked`` off the TPU). A call
that is not recorded (serving, decode) launches the forward kernel alone.
It never falls back to the chunked version unasked. The plain versions are
differentiated by autograd, as JAX differentiates ``mamba1_scan_chunked``.

``mamba2_scan`` has no kernel, as the JAX package has no Pallas kernel for
it: its ``auto`` route is the SSD chunked matmul form on every device.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import mamba1_scan_ref, mamba2_scan_ref

IMPLS = ("auto", "kernel", "chunked", "ref")
MAMBA2_IMPLS = ("auto", "chunked", "ref")


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


class KernelScan(torch.autograd.Function):
    """The Mamba-1 scan on the CUDA kernels, differentiable: the forward
    kernel, and the backward kernel on the saved inputs (x, dt, a, b, c,
    h0; the states are recomputed by the kernel, not saved). A gradient of
    the final state that autograd does not give is zero."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        return kernel.mamba1_scan_cuda(x, dt, a, b, c, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        x, dt, a, b, c, h0 = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        grads = kernel.mamba1_scan_bwd_cuda(x, dt, a, b, c, h0, gy, gh)
        return tuple(g.to(t.dtype) if need else None
                     for g, t, need in zip(grads, (x, dt, a, b, c, h0), ctx.needs_input_grad))


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
            return KernelScan.apply(x, dt, a, b, c, h0)
        return kernel.mamba1_scan_cuda(x, dt, a, b, c, h0)
    if impl == "chunked":
        return mamba1_scan_chunked(x, dt, a, b, c, h0, chunk)
    return mamba1_scan_ref(x, dt, a, b, c, h0)


def mamba2_scan_chunked(x, dt, a, b, c, h0=None, chunk: int = 128):
    """The SSD chunked matmul form (Dao & Gu): within a chunk an
    attention-like C B^T masked by the decay kernel, across chunks a carried
    (B, H, N, P) state. Same contract as ``mamba2_scan_ref``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    cs = _pick_chunk(s, chunk)
    hst = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    a = a.float()
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=x.device))
    ys = []
    for t0 in range(0, s, cs):
        xc, dtc = x[:, t0:t0 + cs].float(), dt[:, t0:t0 + cs].float()
        bc, cc = b[:, t0:t0 + cs].float(), c[:, t0:t0 + cs].float()
        cum = torch.cumsum(dtc * a, dim=1)  # (B, cs, H), decreasing
        # decay kernel L[i, j] = exp(cum_i - cum_j) for i >= j, else 0 (the
        # exponent is masked first, so no inf reaches a gradient)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, H)
        lmat = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
        w = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * lmat  # (B, i, j, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, dtc[..., None] * xc)
        y_inter = torch.einsum("bin,bhnp,bih->bihp", cc, hst, torch.exp(cum))
        total = cum[:, -1]  # (B, H)
        decay_j = torch.exp(total[:, None, :] - cum)  # (B, cs, H)
        s_new = torch.einsum("bjn,bjh,bjhp->bhnp", bc, decay_j * dtc, xc)
        hst = torch.exp(total)[..., None, None] * hst + s_new
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).to(x.dtype), hst


def mamba2_scan(x, dt, a, b, c, h0=None, chunk: int = 128, impl: str = "auto"):
    """Mamba-2 scan entry point of the models: (y, h_final), see ref.py.
    impl: auto (= chunked) | chunked | ref."""
    if impl not in MAMBA2_IMPLS:
        raise ValueError(f"Mamba-2 scan impl {impl!r}: expected one of {MAMBA2_IMPLS} "
                         f"(Mamba-2 has no kernel)")
    if impl == "ref":
        return mamba2_scan_ref(x, dt, a, b, c, h0)
    return mamba2_scan_chunked(x, dt, a, b, c, h0, chunk)
