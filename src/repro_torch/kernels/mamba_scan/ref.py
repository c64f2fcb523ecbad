"""Sequential (exact) Mamba-1 and Mamba-2 scans in plain PyTorch;
counterpart of ``repro.kernels.mamba_scan.ref``."""
from __future__ import annotations

import torch


def mamba1_scan_ref(x, dt, a, b, c, h0=None):
    """Mamba-1 selective scan, one step per token.

    x:  (B, S, DI)   input sequence (after the conv and activation)
    dt: (B, S, DI)   positive step sizes (after softplus)
    a:  (DI, N)      negative state matrix (A = -exp(a_log))
    b:  (B, S, N)    input projection
    c:  (B, S, N)    output projection
    h0: (B, DI, N)   optional initial state
    Returns (y (B, S, DI) in x.dtype, h_final (B, DI, N) float32).
    """
    bsz, s, di = x.shape
    n = a.shape[1]
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a = a.float()
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a[None])  # (B, DI, N)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba2_scan_ref(x, dt, a, b, c, h0=None):
    """Mamba-2 (SSD) scan, one step per token; a scalar decay per head.

    x:  (B, S, H, P)  head-split inputs
    dt: (B, S, H)     positive step sizes
    a:  (H,)          negative per-head rate (A = -exp(a_log))
    b:  (B, S, N)     input projection, shared by the heads
    c:  (B, S, N)     output projection, shared by the heads
    h0: (B, H, N, P)  optional initial state
    Returns (y (B, S, H, P) in x.dtype, h_final (B, H, N, P) float32).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    hst = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a = a.float()
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * a[None])  # (B, H)
        upd = torch.einsum("bn,bhp->bhnp", bf[:, t], dtf[:, t, :, None] * xf[:, t])
        hst = da[..., None, None] * hst + upd
        ys.append(torch.einsum("bhnp,bn->bhp", hst, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), hst
