"""Sequential (exact) Mamba-1 and Mamba-2 scans in plain PyTorch;
counterpart of ``repro.kernels.mamba_scan.ref``; and the Mamba-1 scan's
gradient (``mamba1_scan_bwd_ref``), the plain version of the backward
kernel, with the same gradient by the kernel's schedule for tests
(``mamba1_scan_bwd_schedule_reference``). The Mamba-1 functions compute in
float32, or in float64 for float64 inputs."""
from __future__ import annotations

import torch


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


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
    acc = _acc_dtype(x)
    h = (torch.zeros((bsz, di, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    xf, dtf, bf, cf, a = (t.to(acc) for t in (x, dt, b, c, a))
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a[None])  # (B, DI, N)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba1_scan_bwd_ref(x, dt, a, b, c, h0, gy, gh):
    """Gradient of ``mamba1_scan_ref`` given gy (B, S, DI), the gradient of
    y, and gh (B, DI, N), that of the final state (None: zero; gy None:
    zero). A forward sweep keeps every state, then the adjoint
    lam_t = dL/dh_t walks back in time:

        lam_{S-1} = gh + C_{S-1} gy_{S-1},  lam_t = C_t gy_t + alpha_{t+1} lam_{t+1}
        gC_t[n] = sum_d gy_t[d] h_t[d, n]     gB_t[n] = sum_d lam_t dt_t x_t
        gx_t    = dt_t sum_n lam_t B_t[n]     gdt_t = sum_n lam_t (a_n alpha_t h_{t-1} + x_t B_t[n])
        ga[d, n] = sum_{b, t} lam_t dt_t alpha_t h_{t-1}     gh0 = alpha_0 lam_0

    with alpha_t = exp(dt_t a). Returns (gx, gdt, ga, gb, gc, gh0) in the
    types of x, dt, a, b, c and h0 (gh0 float32 without h0)."""
    bsz, s, di = x.shape
    n = a.shape[1]
    acc = _acc_dtype(x)
    xf, dtf, af, bf, cf = (t.to(acc) for t in (x, dt, a, b, c))
    gyf = torch.zeros_like(xf) if gy is None else gy.to(acc)
    h = (torch.zeros((bsz, di, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    states, alphas = [h], []
    for t in range(s):
        alpha = torch.exp(dtf[:, t, :, None] * af)  # (B, DI, N)
        h = alpha * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        states.append(h)
        alphas.append(alpha)
    carry = torch.zeros_like(h) if gh is None else gh.to(acc)  # alpha_{t+1} lam_{t+1}
    gx, gdt = torch.empty_like(xf), torch.empty_like(xf)
    gb, gc = torch.empty_like(bf), torch.empty_like(cf)
    ga = torch.zeros_like(af)
    for t in reversed(range(s)):
        lam = cf[:, t, None, :] * gyf[:, t, :, None] + carry
        gc[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], gyf[:, t])
        gb[:, t] = torch.einsum("bdn,bd->bn", lam, dtf[:, t] * xf[:, t])
        lam_b = torch.einsum("bdn,bn->bd", lam, bf[:, t])
        gx[:, t] = dtf[:, t] * lam_b
        w = lam * alphas[t] * states[t]  # lam_t alpha_t h_{t-1}
        gdt[:, t] = torch.einsum("bdn,dn->bd", w, af) + xf[:, t] * lam_b
        ga += torch.einsum("bdn,bd->dn", w, dtf[:, t])
        carry = alphas[t] * lam
    return (gx.to(x.dtype), gdt.to(dt.dtype), ga.to(a.dtype), gb.to(b.dtype), gc.to(c.dtype),
            carry.to(torch.float32 if h0 is None else h0.dtype))


def mamba1_scan_bwd_schedule_reference(x, dt, a, b, c, h0, gy, gh, chunk: int):
    """``mamba1_scan_bwd_ref``'s gradients by the backward kernel's schedule
    and algebra (``csrc/mamba1_scan_bwd.cu``), for tests only: the sequence
    zero-padded to whole chunks of ``chunk`` steps (a padded step has alpha
    1 and adds nothing); a forward sweep keeping the state at the start of
    every chunk; then, chunk by chunk from the last, the chunk
    recomputed from its checkpoint, keeping alpha_t and u_t = alpha_t
    h_{t-1} and summing gC_t = sum_d gy_t h_t, and walked back:

        lam_t = C_t gy_t + r,  w = lam_t u_t,  r <- alpha_t lam_t
        gB_t = sum_d lam_t dt_t x_t      gx_t = dt_t sum_n lam_t B_t
        gdt_t = sum_n w a + x_t sum_n lam_t B_t      ga += sum_b w dt_t

    Same arguments and results as ``mamba1_scan_bwd_ref``."""
    bsz, s, di = x.shape
    n = a.shape[1]
    acc = _acc_dtype(x)
    pad = -s % chunk
    xf, dtf, bf, cf = (torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad)) for t in (x, dt, b, c))
    gyf = (torch.zeros_like(xf) if gy is None
           else torch.nn.functional.pad(gy.to(acc), (0, 0, 0, pad)))
    af = a.to(acc)
    dx = dtf * xf  # (B, S', DI)
    n_chunks = (s + pad) // chunk
    h = (torch.zeros((bsz, di, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    checkpoints = []
    for j in range(n_chunks - 1):  # pass 1
        checkpoints.append(h)
        for t in range(j * chunk, (j + 1) * chunk):
            h = torch.exp(dtf[:, t, :, None] * af) * h + dx[:, t, :, None] * bf[:, t, None, :]
    checkpoints.append(h)
    r = torch.zeros_like(h) if gh is None else gh.to(acc)
    gx, gdt = torch.empty_like(xf), torch.empty_like(xf)
    gb, gc = torch.empty_like(bf), torch.empty_like(cf)
    ga = torch.zeros_like(af)
    for j in reversed(range(n_chunks)):  # pass 2
        h, alphas, us = checkpoints[j], {}, {}
        steps = range(j * chunk, (j + 1) * chunk)
        for t in steps:  # the recompute
            alphas[t] = torch.exp(dtf[:, t, :, None] * af)
            us[t] = alphas[t] * h
            h = us[t] + dx[:, t, :, None] * bf[:, t, None, :]
            gc[:, t] = torch.einsum("bdn,bd->bn", h, gyf[:, t])
        for t in reversed(steps):  # the walk back
            lam = cf[:, t, None, :] * gyf[:, t, :, None] + r
            w = lam * us[t]
            gb[:, t] = torch.einsum("bdn,bd->bn", lam, dx[:, t])
            lam_b = torch.einsum("bdn,bn->bd", lam, bf[:, t])
            gx[:, t] = dtf[:, t] * lam_b
            gdt[:, t] = torch.einsum("bdn,dn->bd", w, af) + xf[:, t] * lam_b
            ga += torch.einsum("bdn,bd->dn", w, dtf[:, t])
            r = alphas[t] * lam
    return (gx[:, :s].to(x.dtype), gdt[:, :s].to(dt.dtype), ga.to(a.dtype), gb[:, :s].to(b.dtype),
            gc[:, :s].to(c.dtype), r.to(torch.float32 if h0 is None else h0.dtype))


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
