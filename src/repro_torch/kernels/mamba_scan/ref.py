"""Sequential (exact) Mamba-1 selective scan in plain PyTorch; counterpart
of ``repro.kernels.mamba_scan.ref.mamba1_scan_ref``."""
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
