"""Exact attention (plain PyTorch) and the mask / spec types of every
attention path; counterpart of ``repro.kernels.flash_attention.ref``.

``attention_ref`` is the O(S^2)-memory reference that the online-softmax
paths are held against. It supports GQA, causal / sliding-window / prefix-LM
masks, tanh soft-capping of the logits and padded-KV validity (decode
caches). Positions are absolute and read from ``q_pos`` / ``kv_pos``, never
from indices. ``attention_lse_ref`` also returns each row's log-sum-exp,
the plain version of the decode kernel's ``lse`` output.
``decode_split_reference`` repeats the decode kernel's split-and-merge
arithmetic (``csrc/flash_decode_sm90.cu``) for the tests, and
``simt_tile_reference`` the SIMT kernel's packed row tiles
(``csrc/flash_attention.cu``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

NEG = -1e30  # finite mask value: a row with no visible key yet stays finite
DECODE_TILE = 32  # keys a tile of the decode kernel; its splits are whole tiles
SIMT_KEY_TILE = 32  # keys a tile of the SIMT kernel (64 at 128 rows a block)


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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                      kv_valid: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref(..., gqa="group")`` and the float32 log-sum-exp of
    each row's visible (scaled, soft-capped) logits, (B, Sq, H), -1e30 for a
    row that sees no key: what the decode kernel returns with ``lse``.
    Disjoint key sets' (out, lse) merge into the attention over their union
    (``models.transformer.merge_partials``)."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    group = h // hkv
    scale = hd ** -0.5 if scale is None else scale
    mask = attention_mask(q_pos, kv_pos, spec, kv_valid)  # (B, Sq, Skv)
    seen = mask.any(dim=-1)  # (B, Sq)
    qg = q.float().reshape(b, sq, hkv, group, hd)
    logits = _capped(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale, spec)
    logits = torch.where(mask[:, None, None], logits, NEG)
    lse = torch.logsumexp(logits, dim=-1)  # (B, Hkv, G, Sq)
    probs = torch.exp(logits - lse[..., None]) * seen[:, None, None, :, None]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float()).reshape(b, sq, h, hd)
    lse = torch.where(seen[:, None, None], lse, NEG).permute(0, 3, 1, 2).reshape(b, sq, h)
    return out.to(q.dtype), lse


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


def simt_tile_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                        kv_valid: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None, rows: int = 64) -> torch.Tensor:
    """Attention the way the SIMT kernel (``csrc/flash_attention.cu``) tiles
    it. The rows of kv head h are its G = H / Hkv q heads at each query
    position in (position, g) order, flat row f = position G + g; a block
    takes ``rows`` consecutive flat rows and walks the keys in
    ``SIMT_KEY_TILE``-key tiles (twice that at 128 rows). A tile is skipped
    when none of its valid
    keys passes the mask against the block's least and greatest row position
    (causal: key <= greatest; window: least - key < window; or the prefix);
    the others take per-entry masks, masked logits -1e30, and the online
    softmax in float32 in the log2 domain (logits times scale log2(e), after
    the soft-cap), exponentiated by exp2. A row that never sees a key is
    written as 0. Same signature and result as ``attention_ref`` (up to
    rounding), plus ``rows``."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = hd ** -0.5 if scale is None else scale
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    kv_valid = kv_valid.bool()
    n_rows = sq * group
    # (B, Hkv, flat rows, hd); the position of each flat row.
    qf = q.float().reshape(b, sq, hkv, group, hd).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, n_rows, hd)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B, Hkv, Skv, hd)
    flat_pos = q_pos.repeat_interleave(group, dim=1)  # (B, flat rows)
    log2e = math.log2(math.e)
    tile = SIMT_KEY_TILE * (2 if rows == 128 else 1)
    out = torch.empty_like(qf)
    for f0 in range(0, n_rows, rows):
        qt, qp = qf[:, :, f0:f0 + rows], flat_pos[:, f0:f0 + rows]
        lo, hi = qp.amin(dim=1, keepdim=True), qp.amax(dim=1, keepdim=True)  # (B, 1)
        m = torch.full(qt.shape[:3], NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, skv, tile):
            kp, ok = kv_pos[:, k0:k0 + tile], kv_valid[:, k0:k0 + tile]
            near = torch.ones_like(ok)
            if spec.causal:
                near = near & (kp <= hi)
            if spec.window > 0:
                near = near & (lo - kp < spec.window)
            if spec.prefix_len > 0:
                near = near | (kp < spec.prefix_len)
            loaded = (ok & near).any(dim=1)  # (B,): the tile is loaded for this batch row
            if not bool(loaded.any()):
                continue
            logits = torch.einsum("bhrd,bhkd->bhrk", qt, kf[:, :, k0:k0 + tile]) * scale
            if spec.softcap > 0:
                logits = spec.softcap * torch.tanh(logits / spec.softcap)
            mask = attention_mask(qp, kp, spec, ok)  # (B, rows, keys)
            logits = torch.where(mask[:, None], logits * log2e, NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(logits - m_new[..., None])
            l_new = l * corr + p.sum(dim=-1)
            acc_new = acc * corr[..., None] + torch.einsum(
                "bhrk,bhkd->bhrd", p, vf[:, :, k0:k0 + tile])
            keep = loaded[:, None, None]
            m, l = torch.where(keep, m_new, m), torch.where(keep, l_new, l)
            acc = torch.where(keep[..., None], acc_new, acc)
        res = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, :, f0:f0 + rows] = torch.where((m > NEG / 2)[..., None], res, 0.0)
    return out.reshape(b, hkv, sq, group, hd).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, hd).to(q.dtype)
