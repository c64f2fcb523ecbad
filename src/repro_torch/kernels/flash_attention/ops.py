"""Attention front end: the dispatch that models call, and the plain
online-softmax version; counterpart of ``repro.kernels.flash_attention.ops``.

``flash_attention(..., impl="auto")`` launches a CUDA kernel (``kernel.py``)
for CUDA tensors, in prefill and in decode alike, as the JAX package runs its
Pallas kernel on a TPU: ``kernel.variant`` sends decode (Sq = 1, hd a
multiple of 8) to the decode kernel, bf16 prefill (hd 64 or 128, Sq >= 64)
to the wgmma kernel and every other call to the SIMT kernel. For
CPU tensors it runs ``attention_chunked``, and for one query row
(``Sq == 1``, decode) the exact grouped ``attention_ref``, as the JAX
package does off the TPU. ``"kernel"``, ``"chunked"`` and
``"ref"`` force one path; the kernel raises on a CPU tensor. There is no
fallback: on a CUDA tensor the kernel launches or raises.

``return_lse=True`` (one query row) also returns each row's float32
log-sum-exp (B, 1, H): the decode kernel's ``lse`` output on a CUDA
tensor, ``ref.attention_lse_ref`` on the CPU; a tensor-parallel decode
whose cache slots are split over ranks merges the ranks' outputs with it.
It has no backward.

Types promote as the JAX package's attention does: q, k and v of different
types (a float32 query over a bf16 cache, a bf16 query over float32 keys)
are taken to their promoted type, and the output is in q's type.

Gradients: the kernel route is a ``torch.autograd.Function``
(``KernelAttention``), the counterpart of the ``custom_vjp`` of
``repro.kernels.flash_attention.kernel.flash_attention_pallas``: the
forward launches the kernel, the backward recomputes through
``attention_chunked`` and differentiates that (the JAX package has no
backward kernel either). The kernel route takes the Function only when
autograd records the call; otherwise it launches the kernel directly, so
serving's launches are those of the kernel alone. The plain versions are
differentiated by autograd as they stand.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import NEG, AttnSpec, attention_lse_ref, attention_mask, attention_ref

IMPLS = ("auto", "kernel", "chunked", "ref")


def _chunk_sizes(sq: int, skv: int, q_chunk: int, kv_chunk: int) -> tuple[int, int]:
    """The largest chunks of at most ``q_chunk`` / ``kv_chunk`` that divide
    ``sq`` / ``skv``. (The JAX package halves the cap until it divides, which
    its compiled scan runs at any trip count; run eagerly, whisper's 1,500
    frames would halve to chunks of 4, a 375 x 375 loop of small calls.)"""
    def largest(n: int, cap: int) -> int:
        return next(c for c in range(min(cap, n), 0, -1) if n % c == 0)
    return largest(sq, q_chunk), largest(skv, kv_chunk)


def attention_chunked(q, k, v, q_pos, kv_pos, spec: AttnSpec, kv_valid=None,
                      scale: Optional[float] = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention, chunked over q (outer loop) and kv (inner
    loop), with (m, l, acc) in float32: the plain version of the kernel.
    Same signature and semantics as ``attention_ref``.

    A causal sliding window with no prefix reads only a window-sized kv span
    per q chunk, located by index (the layout of a prefill, where positions
    are the indices)."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = hd ** -0.5 if scale is None else scale
    qc, kc = _chunk_sizes(sq, skv, q_chunk, kv_chunk)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    windowed = spec.window > 0 and spec.prefix_len == 0 and spec.causal
    span = min(skv, -(-(spec.window + qc) // kc) * kc + kc) if windowed else skv
    out = torch.empty_like(q)
    for q0 in range(0, sq, qc):
        qb = q[:, q0:q0 + qc].float().transpose(1, 2)  # (B, H, qc, hd)
        qp = q_pos[:, q0:q0 + qc]
        lo = min(max(q0 + qc - span, 0), skv - span) if windowed else 0
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, qc), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=q.device)
        for k0 in range(lo, lo + span, kc):
            ks = k[:, k0:k0 + kc].float()
            vs = v[:, k0:k0 + kc].float()
            if group > 1:
                ks = ks.repeat_interleave(group, dim=2)
                vs = vs.repeat_interleave(group, dim=2)
            logits = torch.einsum("bhqd,bkhd->bhqk", qb, ks) * scale
            if spec.softcap > 0:
                logits = spec.softcap * torch.tanh(logits / spec.softcap)
            mask = attention_mask(qp, kv_pos[:, k0:k0 + kc], spec, kv_valid[:, k0:k0 + kc])
            logits = torch.where(mask[:, None], logits, NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vs)
            m = m_new
        res = acc / torch.clamp(l[..., None], min=1e-30)
        res = torch.where((m > NEG / 2)[..., None], res, 0.0)  # rows that see no key
        out[:, q0:q0 + qc] = res.transpose(1, 2).to(q.dtype)
    return out


class KernelAttention(torch.autograd.Function):
    """Attention on the CUDA kernel, differentiable: the backward recomputes
    the forward through ``attention_chunked`` with autograd and returns its
    dq, dk and dv (bit-equal to autograd through ``attention_chunked`` on the
    same inputs), none for the positions and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, spec, scale):
        ctx.spec, ctx.scale = spec, scale
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid)
        return kernel.flash_attention_cuda(q, k, v, q_pos, kv_pos, spec,
                                           kv_valid=kv_valid, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos, kv_valid = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_chunked(q, k, v, q_pos, kv_pos, ctx.spec, kv_valid, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, spec: AttnSpec, kv_valid=None,
                    scale: Optional[float] = None, impl: str = "auto",
                    q_chunk: int = 1024, kv_chunk: int = 1024, return_lse: bool = False):
    """Attention entry point of the models: q (B, Sq, H, hd), k/v
    (B, Skv, Hkv, hd), q_pos (B, Sq), kv_pos (B, Skv), kv_valid (B, Skv) or
    None -> (B, Sq, H, hd) in q.dtype, and with ``return_lse`` (Sq = 1)
    also the rows' float32 log-sum-exp (B, 1, H). impl: auto | kernel |
    chunked | ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")
    if not q.dtype == k.dtype == v.dtype:
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        out = flash_attention(q.to(dt), k.to(dt), v.to(dt), q_pos, kv_pos, spec, kv_valid,
                              scale, impl, q_chunk, kv_chunk, return_lse)
        return (out[0].to(q.dtype), out[1]) if return_lse else out.to(q.dtype)
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "chunked"
    if return_lse:
        if q.shape[1] != 1:
            raise ValueError(f"return_lse takes one query row (decode), got {q.shape[1]}")
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError("the log-sum-exp output has no backward")
        if impl == "kernel":
            return kernel.flash_attention_cuda(q, k, v, q_pos, kv_pos, spec, kv_valid=kv_valid,
                                               scale=scale, return_lse=True)
        return attention_lse_ref(q, k, v, q_pos, kv_pos, spec, kv_valid, scale)
    if impl == "kernel":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return KernelAttention.apply(q, k, v, q_pos, kv_pos, kv_valid, spec, scale)
        return kernel.flash_attention_cuda(q, k, v, q_pos, kv_pos, spec,
                                           kv_valid=kv_valid, scale=scale)
    if impl == "chunked" and q.shape[1] == 1:
        return attention_ref(q, k, v, q_pos, kv_pos, spec, kv_valid, scale, gqa="group")
    if impl == "chunked":
        return attention_chunked(q, k, v, q_pos, kv_pos, spec, kv_valid, scale,
                                 q_chunk, kv_chunk)
    return attention_ref(q, k, v, q_pos, kv_pos, spec, kv_valid, scale)
