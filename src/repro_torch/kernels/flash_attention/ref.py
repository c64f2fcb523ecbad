"""Exact attention (plain PyTorch) and the mask / spec types of every
attention path; counterpart of ``repro.kernels.flash_attention.ref``.

``attention_ref`` is the O(S^2)-memory reference that the online-softmax
paths are held against. It supports GQA, causal / sliding-window / prefix-LM
masks, tanh soft-capping of the logits and padded-KV validity (decode
caches). Positions are absolute and read from ``q_pos`` / ``kv_pos``, never
from indices. ``decode_split_reference`` repeats the decode kernel's
split-and-merge arithmetic (``csrc/flash_decode_sm90.cu``) for the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG = -1e30  # finite mask value: a row with no visible key yet stays finite
DECODE_TILE = 32  # keys a tile of the decode kernel; its splits are whole tiles


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int = 0  # 0 = unlimited; >0: q attends kv with q_pos - kv_pos < window
    softcap: float = 0.0  # attention-logit tanh cap
    prefix_len: int = 0  # prefix-LM: kv_pos < prefix_len visible to all


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask from absolute positions (B, Sq), (B, Skv)."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    if spec.causal:
        ok = k <= q
    else:
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                        device=q_pos.device)
    if spec.window > 0:
        ok = ok & (q - k < spec.window)
    if spec.prefix_len > 0:
        ok = ok | (k < spec.prefix_len)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :].bool()
    return ok


def _capped(logits: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    if spec.softcap > 0:
        return spec.softcap * torch.tanh(logits / spec.softcap)
    return logits


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                  kv_valid: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None, gqa: str = "repeat") -> torch.Tensor:
    """Exact grouped-query attention with a float32 softmax.

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd) in q.dtype.
    ``gqa="repeat"`` replicates the kv heads; ``gqa="group"`` reshapes q into
    (Hkv, group) instead (the decode path). Rows that see no key are 0.
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    group = h // hkv
    scale = hd ** -0.5 if scale is None else scale
    mask = attention_mask(q_pos, kv_pos, spec, kv_valid)
    qf, kf, vf = q.float(), k.float(), v.float()
    if group > 1 and gqa == "group":
        qg = qf.reshape(b, sq, hkv, group, hd)
        logits = _capped(torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale, spec)
        logits = torch.where(mask[:, None, None], logits, NEG)
        probs = torch.softmax(logits, dim=-1)
        probs = probs * mask.any(dim=-1)[:, None, None, :, None]
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
        return out.reshape(b, sq, h, hd).to(q.dtype)
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    logits = _capped(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, spec)
    logits = torch.where(mask[:, None], logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(dim=-1)[:, None, :, None]
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def decode_split_bounds(skv: int, n_split: int) -> list[tuple[int, int]]:
    """Key ranges of the decode kernel's splits: ``DECODE_TILE``-key tiles cut
    into ``n_split`` equal runs of whole tiles (the last may be shorter;
    fewer runs when there are fewer tiles)."""
    tiles = -(-skv // DECODE_TILE)
    per = -(-tiles // max(1, min(n_split, tiles))) * DECODE_TILE
    return [(s, min(s + per, skv)) for s in range(0, skv, per)]


def decode_split_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                           kv_valid: Optional[torch.Tensor] = None, n_split: int = 1,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention (Sq = 1) the way the decode kernel does it: the keys
    cut as ``decode_split_bounds`` says, each split's float32 (m, l, acc)
    for the q heads of each kv head with masked logits at -1e30, then merged
    with factors exp(m_s - M). A split that sees no key has m_s = -1e30 and
    merges away; a row that sees no key in any split is written as 0. Same
    signature and result as ``attention_ref`` (up to rounding)."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"decode_split_reference takes one query row, got {sq}")
    skv, hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    mask = attention_mask(q_pos, kv_pos, spec, kv_valid)[:, 0]  # (B, Skv)
    qg = q.float().reshape(b, hkv, h // hkv, hd)
    ms, ls, accs = [], [], []
    for lo, hi in decode_split_bounds(skv, n_split):
        logits = _capped(torch.einsum("bhgd,bkhd->bhgk", qg, k[:, lo:hi].float()) * scale, spec)
        logits = torch.where(mask[:, None, None, lo:hi], logits, NEG)
        m = logits.amax(dim=-1)  # (B, Hkv, G)
        p = torch.exp(logits - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, v[:, lo:hi].float()))
    m_all = torch.stack(ms)  # (S, B, Hkv, G)
    m_max = m_all.amax(dim=0)
    factor = torch.exp(m_all - m_max)
    l_sum = (torch.stack(ls) * factor).sum(dim=0)
    acc = (torch.stack(accs) * factor[..., None]).sum(dim=0)
    out = acc / torch.clamp(l_sum[..., None], min=1e-30)
    out = torch.where((m_max > NEG / 2)[..., None], out, 0.0)
    return out.reshape(b, 1, h, hd).to(q.dtype)
