"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs a CUDA card: it is marked ``cuda`` and
skips without one. This file imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import network  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import AttnSpec, attention_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as sops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba1_scan_ref  # noqa: E402
from repro_torch.kernels.matching import kernel as mkernel  # noqa: E402
from repro_torch.kernels.matching import ops as mops  # noqa: E402

pytestmark = pytest.mark.cuda

# (B, Sq, Skv, H, Hkv, hd, spec), tests/test_torch_flash_attention.py's
# cases plus a ragged length and a head dim of 128.
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, AttnSpec(causal=True)),
    (1, 256, 256, 8, 8, 32, AttnSpec(causal=True, window=64)),
    (2, 128, 128, 4, 1, 64, AttnSpec(causal=True, softcap=30.0)),
    (1, 64, 192, 4, 2, 32, AttnSpec(causal=False)),
    (1, 128, 128, 2, 2, 16, AttnSpec(causal=True, prefix_len=32)),
    (1, 128, 128, 8, 2, 32, AttnSpec(causal=True)),
    (1, 64, 64, 2, 1, 80, AttnSpec(causal=True)),
    (2, 100, 173, 8, 2, 128, AttnSpec(causal=True)),
]
# Kernel and plain version both sum in float32 but in other orders; the
# bfloat16 output is one rounding of that.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_matches_plain_version(card, case, dtype):
    b, sq, skv, h, hkv, hd, spec = case
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=card).to(dtype)
               for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    qp = torch.arange(skv - sq, skv, dtype=torch.int32, device=card).expand(b, sq)
    kp = torch.arange(skv, dtype=torch.int32, device=card).expand(b, skv)
    before = fkernel.launches["flash_attention"]
    got = fops.flash_attention(q, k, v, qp, kp, spec)
    assert fkernel.launches["flash_attention"] == before + 1
    assert got.dtype == dtype
    _close(got, fops.attention_chunked(q, k, v, qp, kp, spec), TOL[dtype])


# bf16 cases of the wgmma kernel at both of its head dims, Hkv 1, 2 and 8:
# (B, Sq, Skv, H, Hkv, spec, a batch row with no valid key).
WGMMA_CASES = [
    (2, 256, 256, 8, 1, AttnSpec(softcap=50.0), False),
    (2, 256, 256, 8, 2, AttnSpec(prefix_len=100), False),
    (2, 128, 128, 8, 8, AttnSpec(window=64), True),
    (2, 100, 173, 8, 2, AttnSpec(), False),
    (1, 333, 555, 4, 2, AttnSpec(window=256), False),
    (2, 64, 777, 8, 1, AttnSpec(causal=False), True),
    (1, 128, 8192, 4, 2, AttnSpec(causal=False), False),
    # P is rounded to bf16 before P V: 32,768 keys feeding every row (the
    # JAX package's prefill_32k length).
    (1, 256, 32768, 8, 2, AttnSpec(causal=False), False),
]
BF16_TOL_OF_SCALE = 8e-3  # two bf16 roundings of the value, as chip_smoke.py


@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_matches_plain_version(card, case, hd):
    """bf16 prefill takes the wgmma kernel (and only it); rows that see no
    key are exactly 0."""
    b, sq, skv, h, hkv, spec, masked_row = case
    rng = np.random.default_rng(11)
    shapes = ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=card)
               .to(torch.bfloat16) for s in shapes)
    qp = torch.arange(skv - sq, skv, dtype=torch.int32, device=card).expand(b, sq)
    kp = torch.arange(skv, dtype=torch.int32, device=card).expand(b, skv)
    valid = None
    if masked_row:
        valid = torch.ones((b, skv), dtype=torch.bool, device=card)
        valid[-1] = False
        valid[0, 10:40] = False
    assert fkernel.variant(torch.bfloat16, hd, sq) == "wgmma"
    before = dict(fkernel.launches)
    got = fops.flash_attention(q, k, v, qp, kp, spec, kv_valid=valid, impl="kernel")
    assert fkernel.launches["flash_attention_wgmma"] == before["flash_attention_wgmma"] + 1
    assert fkernel.launches["flash_attention"] == before["flash_attention"] + 1
    want = fops.attention_chunked(q, k, v, qp, kp, spec, kv_valid=valid)
    err = float((got.float() - want.float()).abs().max())
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert err <= BF16_TOL_OF_SCALE * float(want.float().abs().max())
    unseen = ~fref.attention_mask(qp, kp, spec, valid).any(dim=-1)
    assert bool((got[unseen] == 0).all())
    if masked_row:
        assert int(unseen.sum()) >= sq


def test_flash_attention_decode_ring_buffer(card):
    """Sq = 1 over permuted positions with empty slots; the last row sees
    no key and must be exactly 0."""
    b, skv, h, hkv, hd = 3, 48, 8, 2, 128
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=card)
               for s in ((b, 1, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)])
    kp[0, rng.random(skv) < 0.25] = -1
    kp[1, :10] = -1
    kp = torch.as_tensor(kp.astype(np.int32), device=card)
    qp = torch.as_tensor([[140], [130], [20]], dtype=torch.int32, device=card)
    for spec in (AttnSpec(), AttnSpec(window=16), AttnSpec(softcap=20.0)):
        got = fops.flash_attention(q, k, v, qp, kp, spec, kv_valid=kp >= 0)
        _close(got, attention_ref(q, k, v, qp, kp, spec, kv_valid=kp >= 0, gqa="group"), 2e-5)
        assert bool((got[2] == 0).all()) and bool((got[:2] != 0).any())


def _decode_inputs(card, b, skv, h, hkv, hd, dtype, kind, seed):
    """One query row a batch row over a cache of ``kind``: "filled" (keys at
    positions 0 .. Skv - 1, the query at Skv), "ring" (permuted positions,
    a fifth of the slots empty at -1, the last of several batch rows' query
    before every key: it sees none) or "half" (the slots of a ring buffer that is
    half full: the first half at positions 0 .. Skv / 2 - 1, the rest -1).
    k and v are drawn on the card from a seeded generator."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, 1, h, hd), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device=card, dtype=dtype)
            for _ in range(2))
    rng = np.random.default_rng(seed)
    if kind == "filled":
        kp = np.broadcast_to(np.arange(skv), (b, skv))
        qp = np.full((b, 1), skv)
    elif kind == "ring":
        kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)])
        kp[rng.random(kp.shape) < 0.2] = -1
        qp = np.full((b, 1), 100 + skv)
        if b > 1:
            qp[-1] = 50
    else:
        kp = np.where(np.arange(skv) < skv // 2, np.arange(skv), -1)[None].repeat(b, 0)
        qp = np.full((b, 1), skv // 2 - 1)
    kp = torch.as_tensor(np.ascontiguousarray(kp).astype(np.int32), device=card)
    qp = torch.as_tensor(qp.astype(np.int32), device=card)
    return q, k, v, qp, kp, kp >= 0


def _decode_plain(q, k, v, qp, kp, spec, valid, n_split, rows_at_once=None):
    """The plain split-and-merge version, over batch slices of ``rows_at_once``
    rows (float32 copies of a large cache do not fit beside it)."""
    step = rows_at_once or q.shape[0]
    return torch.cat([fref.decode_split_reference(q[i:i + step], k[i:i + step], v[i:i + step],
                                                  qp[i:i + step], kp[i:i + step], spec,
                                                  valid[i:i + step], n_split)
                      for i in range(0, q.shape[0], step)])


def _check_decode(got, want, spec, qp, kp, valid):
    """bf16 within 8e-3 of scale (one rounding of the output), float32
    within 2e-5; rows that see no key exactly 0."""
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        _close(got, want, 2e-5)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= BF16_TOL_OF_SCALE * float(want.float().abs().max())
    unseen = ~fref.attention_mask(qp, kp, spec, valid)[:, 0].any(dim=-1)  # (B,)
    assert bool((got[unseen] == 0).all())
    return int(unseen.sum())


# (B, Skv, H, Hkv, hd, spec, cache kind, forced split count): the serve run's
# shape, a half-full ring buffer with a window, fewer keys than a tile, Skv
# not a multiple of a tile, G = 1 / 3 / 4 / 8 / 20 (20: three row groups),
# hd 64 / 80 / 128 / 256, one split over 4096 keys and seven forced splits.
DECODE_CASES = [
    (4, 48, 32, 8, 128, AttnSpec(), "ring", None),
    (4, 48, 32, 8, 128, AttnSpec(window=16), "half", None),
    (2, 20, 8, 2, 64, AttnSpec(), "ring", None),
    (3, 1000, 12, 4, 80, AttnSpec(softcap=30.0), "ring", None),
    (2, 333, 8, 1, 256, AttnSpec(prefix_len=150), "ring", None),
    (2, 4096, 8, 8, 64, AttnSpec(), "filled", 1),
    (2, 4000, 16, 2, 128, AttnSpec(window=1500), "filled", 7),
    (1, 5000, 20, 1, 128, AttnSpec(), "ring", None),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_decode_matches_plain_version(card, case, dtype):
    """Sq = 1 takes the decode kernel, one launch a call, against the plain
    split-and-merge version with the same splits and the exact grouped
    reference; a repeated call gives the same bits."""
    b, skv, h, hkv, hd, spec, kind, n_split = case
    q, k, v, qp, kp, valid = _decode_inputs(card, b, skv, h, hkv, hd, dtype, kind, 5)
    assert fkernel.variant(dtype, hd, 1) == "decode"
    splits, _ = (fkernel.split_plan(skv, n_split) if n_split else fkernel.decode_plan(
        b, skv, hkv, h // hkv, fkernel.decode_slots(q.device, dtype, hd, h // hkv)))
    before = dict(fkernel.launches)
    got = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, n_split=n_split)
    assert fkernel.launches == {**before,
                                "flash_attention": before["flash_attention"] + 1,
                                "flash_attention_decode": before["flash_attention_decode"] + 1}
    unseen = _check_decode(got, _decode_plain(q, k, v, qp, kp, spec, valid, splits),
                           spec, qp, kp, valid)
    _check_decode(got, attention_ref(q, k, v, qp, kp, spec, valid, gqa="group"),
                  spec, qp, kp, valid)
    if kind == "ring" and spec.prefix_len == 0 and b > 1:
        assert unseen >= 1
    again = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, n_split=n_split)
    assert torch.equal(again, got)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_decode_lse_matches_plain_version(card, case, dtype):
    """``return_lse``: the same output bits as the call without it, and each
    row's float32 log-sum-exp within 1e-5 relative of ``attention_lse_ref``
    (both from the same float32 logits), -1e30 where a row sees no key; one
    more launch counted as the lse variant."""
    b, skv, h, hkv, hd, spec, kind, n_split = case
    q, k, v, qp, kp, valid = _decode_inputs(card, b, skv, h, hkv, hd, dtype, kind, 6)
    plain = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, n_split=n_split)
    before = dict(fkernel.launches)
    got, lse = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid,
                                             n_split=n_split, return_lse=True)
    assert fkernel.launches == {**before, **{
        n: before[n] + 1 for n in ("flash_attention", "flash_attention_decode",
                                   "flash_attention_decode_lse")}}
    assert torch.equal(got, plain) and lse.shape == (b, 1, h) and lse.dtype == torch.float32
    o_ref, lse_ref = fref.attention_lse_ref(q, k, v, qp, kp, spec, valid)
    _check_decode(got, o_ref, spec, qp, kp, valid)
    seen = fref.attention_mask(qp, kp, spec, valid).any(dim=-1)  # (B, 1)
    rel = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1e-30))[seen]
    assert float(rel.max()) <= 1e-5
    assert bool((lse[~seen] == fref.NEG).all())


@pytest.mark.parametrize("ranks", [2, 4])
def test_flash_decode_lse_merges_split_slots(card, ranks):
    """A cache's slots cut into ``ranks`` blocks, each through the kernel with
    ``return_lse``, merged by ``transformer.merge_partials``: the kernel over
    the whole cache within 2e-5 (float32), as a tensor-parallel decode over
    a slot-split cache computes it."""
    from repro_torch.models.transformer import merge_partials
    q, k, v, qp, kp, valid = _decode_inputs(card, 4, 96, 48, 1, 128, torch.float32, "ring", 8)
    spec = AttnSpec(window=40)
    want = fkernel.flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid)
    n = 96 // ranks
    parts = [fkernel.flash_attention_cuda(q, k[:, i:i + n], v[:, i:i + n], qp, kp[:, i:i + n],
                                          spec, kv_valid=valid[:, i:i + n], return_lse=True)
             for i in range(0, 96, n)]
    got = merge_partials(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("n_split", [1, 2, 7, 32, 128])
def test_flash_decode_split_counts(card, n_split):
    """One split to one split a tile over 4096 keys, bf16 at minitron-4b's
    heads: keys 1024 .. 2047 are empty, so some splits see no key and merge
    away, and the last batch row sees none at all."""
    q, k, v, qp, kp, valid = _decode_inputs(card, 3, 4096, 32, 8, 128, torch.bfloat16,
                                            "filled", 9)
    kp[:, 1024:2048] = -1
    qp[-1] = -5
    valid = kp >= 0
    spec = AttnSpec()
    got = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, n_split=n_split)
    assert fkernel.split_plan(4096, n_split)[0] == n_split
    _check_decode(got, _decode_plain(q, k, v, qp, kp, spec, valid, n_split), spec, qp, kp, valid)
    assert bool((got[-1] == 0).all()) and bool((got[:-1] != 0).any())


@pytest.mark.parametrize("b", [4, 128])
def test_flash_decode_long_cache(card, b):
    """The JAX package's decode_32k length, 32,768 filled slots, bf16 at
    minitron-4b's heads, as the wrapper splits it; at B 128 the plain version
    runs over batch slices (one layer's cache is 17.2 GB)."""
    q, k, v, qp, kp, valid = _decode_inputs(card, b, 32768, 32, 8, 128, torch.bfloat16,
                                            "filled", 13)
    spec = AttnSpec()
    splits, _ = fkernel.decode_plan(b, 32768, 8, 4,
                                    fkernel.decode_slots(q.device, torch.bfloat16, 128, 4))
    assert splits > 1
    before = fkernel.launches["flash_attention_decode"]
    got = fops.flash_attention(q, k, v, qp, kp, spec, kv_valid=valid)
    assert fkernel.launches["flash_attention_decode"] == before + 1
    _check_decode(got, _decode_plain(q, k, v, qp, kp, spec, valid, splits, rows_at_once=8),
                  spec, qp, kp, valid)


def test_flash_decode_workspace_reuse(card):
    """Calls of two shapes that both split, in turns, share one workspace:
    each stays right, and the merge counters are back at zero after each."""
    shapes = [(4, 8192, 32, 8, 128), (2, 20000, 16, 2, 64)]
    inputs = [_decode_inputs(card, *s, torch.bfloat16, "ring", 21 + i)
              for i, s in enumerate(shapes)]
    spec = AttnSpec()
    for q, k, v, qp, kp, valid in inputs + inputs:
        b, skv, hkv, h = q.shape[0], k.shape[1], k.shape[2], q.shape[2]
        splits, _ = fkernel.decode_plan(b, skv, hkv, h // hkv, fkernel.decode_slots(
            q.device, torch.bfloat16, q.shape[3], h // hkv))
        assert splits > 1
        got = fkernel.flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid)
        _check_decode(got, _decode_plain(q, k, v, qp, kp, spec, valid, splits),
                      spec, qp, kp, valid)
        stream = torch.cuda.current_stream(card).cuda_stream
        _, counters = fkernel._workspaces[(q.device, stream)]
        assert int(counters.abs().sum()) == 0
    assert all(int(c.abs().sum()) == 0 for _, c in fkernel._retired)


def test_flash_decode_odd_head_dim_takes_the_simt_kernel(card):
    """A head dim that is not a multiple of 8 stays on flash_attention.cu at
    Sq = 1 (variant says so); it is right there too."""
    q, k, v, qp, kp, valid = _decode_inputs(card, 2, 100, 8, 2, 36, torch.float32, "ring", 3)
    assert fkernel.variant(torch.float32, 36, 1) == "simt"
    before = dict(fkernel.launches)
    got = fops.flash_attention(q, k, v, qp, kp, AttnSpec(), kv_valid=valid)
    assert fkernel.launches == {**before, "flash_attention": before["flash_attention"] + 1}
    _close(got, attention_ref(q, k, v, qp, kp, AttnSpec(), valid, gqa="group"), 2e-5)


def test_flash_decode_forced_simt_matches_decode_kernel(card):
    """force_simt takes flash_attention.cu at Sq = 1 (chip_smoke.py times the
    two on the same inputs); both agree with the plain version."""
    q, k, v, qp, kp, valid = _decode_inputs(card, 4, 48, 32, 8, 128, torch.bfloat16, "ring", 4)
    before = dict(fkernel.launches)
    simt = fkernel.flash_attention_cuda(q, k, v, qp, kp, AttnSpec(), kv_valid=valid,
                                        force_simt=True)
    assert fkernel.launches == {**before, "flash_attention": before["flash_attention"] + 1}
    want = attention_ref(q, k, v, qp, kp, AttnSpec(), valid, gqa="group")
    _check_decode(simt, want, AttnSpec(), qp, kp, valid)
    with pytest.raises(ValueError, match="n_split"):
        fkernel._flash_attention_cuda(q, k, v, qp, kp, AttnSpec(), kv_valid=valid,
                                      force_simt=True, n_split=2)


# The SIMT kernel (flash_attention.cu): (B, Sq, Skv, Hkv, G, hd, dtype, spec,
# inputs). bf16 prompts under 64 tokens at hd 64 / 128 (Sq 2, 15, 16, 17,
# 63; minitron-4b's 16-token forward first); float32 at Sq 16, 65 and 300;
# hd 32, 36, 80, 128 and 256 (bf16 hd 36: 72-byte rows, the element path;
# float32 hd 17); G 1, 3, 4 and 8; causal, window, prefix-LM, soft-cap and
# non-causal masks with and without kv_valid; a chunk at positions
# 100 .. 100 + Sq - 1 over keys 0 .. Skv - 1.
BF16, F32 = torch.bfloat16, torch.float32
SIMT_CASES = [
    (4, 16, 16, 8, 4, 128, BF16, AttnSpec(), "prefill"),
    (2, 2, 40, 2, 3, 64, BF16, AttnSpec(window=8), "prefill"),
    (2, 15, 15, 2, 8, 128, BF16, AttnSpec(softcap=30.0), "prefill"),
    (2, 17, 128, 2, 4, 64, BF16, AttnSpec(), "chunk"),
    (1, 63, 63, 4, 1, 128, BF16, AttnSpec(prefix_len=20), "prefill"),
    (3, 16, 48, 2, 4, 128, BF16, AttnSpec(), "ring"),
    (2, 17, 100, 1, 8, 64, BF16, AttnSpec(causal=False), "masked"),
    (2, 16, 16, 2, 4, 32, F32, AttnSpec(), "prefill"),
    (2, 65, 65, 2, 3, 36, F32, AttnSpec(window=16), "prefill"),
    (1, 300, 300, 2, 4, 80, F32, AttnSpec(softcap=50.0), "prefill"),
    (2, 65, 200, 1, 8, 128, F32, AttnSpec(prefix_len=50), "ring"),
    (2, 300, 300, 1, 1, 256, F32, AttnSpec(), "masked"),
    (1, 16, 128, 2, 4, 256, F32, AttnSpec(window=64), "chunk"),
    (2, 65, 70, 2, 3, 17, F32, AttnSpec(), "prefill"),
    (2, 300, 300, 4, 1, 80, BF16, AttnSpec(), "prefill"),
    (1, 200, 200, 1, 8, 256, BF16, AttnSpec(prefix_len=64), "prefill"),
    (2, 17, 60, 2, 3, 36, BF16, AttnSpec(), "ring"),
]


def _simt_inputs(card, case, seed):
    """q, k, v from a numpy seed and positions of the case's kind:
    "prefill" (the indices, queries last), "chunk" (queries at 100 ..),
    "ring" (permuted key positions, a fifth of the slots empty at -1; the
    last batch row's queries lie before every key) or "masked" (the last
    batch row has no valid key, the first some invalid ones)."""
    b, sq, skv, hkv, group, hd, dtype, _, kind = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=card).to(dtype)
               for s in ((b, sq, hkv * group, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    kp = np.broadcast_to(np.arange(skv), (b, skv))
    qp = np.broadcast_to(np.arange(100 if kind == "chunk" else skv - sq,
                                   (100 if kind == "chunk" else skv - sq) + sq), (b, sq))
    valid = None
    if kind == "ring":
        kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)])
        kp[rng.random(kp.shape) < 0.2] = -1
        qp = np.broadcast_to(np.arange(100 + skv - sq + 1, 100 + skv + 1), (b, sq)).copy()
        qp[-1] = 50 - np.arange(sq)
        valid = torch.as_tensor(kp >= 0, device=card)
    elif kind == "masked":
        valid = torch.ones((b, skv), dtype=torch.bool, device=card)
        valid[-1] = False
        valid[0, 3:9] = False
    kp, qp = (torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=card)
              for a in (kp, qp))
    return q, k, v, qp, kp, valid


@pytest.mark.parametrize("rows", [None, 16, 32, 64, 128])
@pytest.mark.parametrize("case", SIMT_CASES, ids=str)
def test_flash_simt_matches_plain_version(card, case, rows):
    """Calls that variant sends to flash_attention.cu, at the row tile the
    wrapper picks and at each of 16, 32, 64 and 128 rows a block (128 is
    refused above hd 128): one SIMT launch a call, within 2e-5 (float32) or
    8e-3 (bf16) of scale of the plain version and of the kernel's tiling
    plain version, rows that see no key exactly 0, the same bits on a
    second call."""
    b, sq, skv, hkv, group, hd, dtype, spec, kind = case
    q, k, v, qp, kp, valid = _simt_inputs(card, case, 23)
    assert fkernel.variant(dtype, hd, sq) == "simt"
    if rows == 128 and hd > 128:
        with pytest.raises(ValueError, match="rows"):
            fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, rows=rows)
        return
    before = dict(fkernel.launches)
    got = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, rows=rows)
    assert fkernel.launches == {**before, "flash_attention": before["flash_attention"] + 1}
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = 2e-5 if dtype == torch.float32 else BF16_TOL_OF_SCALE
    tiled = fref.simt_tile_reference(q, k, v, qp, kp, spec, valid, rows=rows or 64)
    for want in (fops.attention_chunked(q, k, v, qp, kp, spec, kv_valid=valid), tiled):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())
    unseen = ~fref.attention_mask(qp, kp, spec, valid).any(dim=-1)
    assert bool((got[unseen] == 0).all()) and bool((got[~unseen] != 0).any())
    if kind in ("ring", "masked"):
        assert bool(unseen.any())
    again = fkernel._flash_attention_cuda(q, k, v, qp, kp, spec, kv_valid=valid, rows=rows)
    assert torch.equal(again, got)


def test_flash_simt_rows_refused_elsewhere(card):
    """rows is for the SIMT kernel: refused for the decode and wgmma routes
    and for a size the kernel has no instance of."""
    case = SIMT_CASES[0]
    q, k, v, qp, kp, valid = _simt_inputs(card, case, 1)
    with pytest.raises(ValueError, match="rows"):
        fkernel._flash_attention_cuda(q, k, v, qp, kp, AttnSpec(), rows=48)
    with pytest.raises(ValueError, match="rows"):
        fkernel._flash_attention_cuda(q[:, :1], k, v, qp[:, :1], kp, AttnSpec(), rows=16)
    occ = fkernel.simt_occupancy(torch.float32, 128, 64)
    assert occ["threads"] == 128 and occ["blocks_per_sm"] >= 1
    assert fkernel.simt_occupancy(torch.bfloat16, 128, 128)["threads"] == 256


@pytest.mark.parametrize("shape", [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 300, 4),
                                   (2, 1, 32, 16), (1, 40, 64, 24)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mamba1_scan_matches_plain_version(card, shape, dtype):
    b, s, di, n = shape
    rng = np.random.default_rng(3)
    f = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=card)  # noqa: E731
    x, bm, cm, h0 = f(b, s, di), f(b, s, n), f(b, s, n), f(b, di, n)
    dt = torch.as_tensor(rng.uniform(0.001, 0.1, (b, s, di)).astype(np.float32), device=card)
    a = -torch.as_tensor(rng.uniform(0.5, 2.0, (di, n)).astype(np.float32), device=card)
    x, dt = x.to(dtype), dt.to(dtype)
    for init in (None, h0):
        y, h = sops.mamba1_scan(x, dt, a, bm, cm, h0=init)
        y_want, h_want = mamba1_scan_ref(x, dt, a, bm, cm, h0=init)
        assert y.dtype == dtype and h.dtype == torch.float32
        _close(y, y_want, 2e-4 if dtype == torch.float32 else 2e-2)
        _close(h, h_want, 2e-4)


# (B, S, DI, N, x type, b / c type, with h0): b and c as strided slices of
# one (B, S, 256 + 2N) tensor, as the models pass the x_proj product; N up
# to 32; decode (S = 1) from h0; DI not a multiple of the kernel's 32
# channels a block, bf16 rows that are not 16-byte aligned (DI 300), states
# that are not a multiple of 4 (N 5, 24).
SCAN_STRIDED_CASES = [
    (4, 1, 1024, 16, torch.bfloat16, torch.bfloat16, True),
    (2, 70, 1000, 16, torch.bfloat16, torch.bfloat16, True),
    (2, 70, 1000, 16, torch.float32, torch.float32, False),
    (2, 300, 512, 32, torch.float32, torch.float32, True),
    (1, 33, 96, 32, torch.bfloat16, torch.bfloat16, True),
    (2, 45, 300, 5, torch.bfloat16, torch.bfloat16, True),
    (2, 1, 77, 24, torch.float32, torch.bfloat16, True),
    (1, 100, 64, 8, torch.bfloat16, torch.float32, False),
]


@pytest.mark.parametrize("case", SCAN_STRIDED_CASES, ids=str)
def test_mamba1_scan_strided_bc_matches_plain_version(card, case):
    b, s, di, n, dtype, bc_dtype, with_h0 = case
    rng = np.random.default_rng(11)
    f = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=card)  # noqa: E731
    x = f(b, s, di).to(dtype)
    dt = torch.as_tensor(rng.uniform(0.001, 0.1, (b, s, di)).astype(np.float32),
                         device=card).to(dtype)
    a = -torch.as_tensor(np.exp(rng.uniform(0.0, np.log(16.0), (di, n))).astype(np.float32),
                         device=card)
    _, bm, cm = f(b, s, 256 + 2 * n).to(bc_dtype).split([256, n, n], dim=-1)
    assert not bm.is_contiguous() and bm.stride(-1) == 1
    h0 = f(b, di, n) if with_h0 else None
    y, h = sops.mamba1_scan(x, dt, a, bm, cm, h0=h0)
    y_want, h_want = mamba1_scan_ref(x, dt, a, bm, cm, h0=h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y, y_want, 2e-4 if dtype == torch.float32 else 2e-2)
    _close(h, h_want, 2e-4)


def collection_logw(rng, shape, case):
    """Log-weights of the skew-aware collection: log(U(1, 1e6)) with -inf
    holes (the main path's range), small integers (ties), NaN / inf, or
    near ties: each EC column holds weights in [12, 16) at most 7 ulps
    apart, so after the growing penalties pen[count] (up to about 4.5)
    weights one ulp apart round to the same gain under round-half-even."""
    n, m = shape
    lead = (4,) if case == "batched" else ()
    if case == "ties":
        return rng.integers(-2, 12, (n, m)).astype(np.float32)
    if case == "near_tie":
        base = rng.uniform(12.0, 15.9, m).astype(np.float32).view(np.int32)
        return (base[None, :] + rng.integers(0, 8, (n, m)).astype(np.int32)).view(np.float32)
    w = np.log(rng.uniform(1.0, 1e6, (*lead, n, m))).astype(np.float32)
    w[rng.random(w.shape) < 0.2] = -np.inf
    if case == "nan":
        w[rng.random(w.shape) < 0.01] = np.nan
        w[rng.random(w.shape) < 0.01] = np.inf
    return w


@pytest.mark.parametrize("case", ["dense", "masked", "ties", "nan", "batched", "near_tie"])
@pytest.mark.parametrize("shape", [(1024, 32), (4096, 64), (333, 7)], ids=str)
def test_greedy_collection_matches_plain_version(card, shape, case):
    """The collection kernel (cached column maxima) against its plain
    version on the card, bit for bit: alpha and theta, one launch a call."""
    rng = np.random.default_rng(sum(shape) + len(case))
    logw = torch.as_tensor(collection_logw(rng, shape, case), device=card)
    masks = {}
    if case == "masked":
        cu = (rng.random(shape[0]) > 0.3).astype(np.float32)
        ec = (rng.random(shape[1]) > 0.3).astype(np.float32)
        cu[0] = ec[0] = 1.0
        masks = {"cu_mask": torch.as_tensor(cu, device=card),
                 "ec_mask": torch.as_tensor(ec, device=card)}
    before = mkernel.launches["greedy_collection"]
    alpha, theta = mops.greedy_collection(logw, impl="kernel", **masks)
    assert mkernel.launches["greedy_collection"] == before + 1
    want_alpha, want_theta = mops.greedy_collection(logw, impl="ref", **masks)
    assert torch.equal(alpha, want_alpha) and torch.equal(theta, want_theta)
    assert float(alpha.sum()) > 0
    assert mkernel.tile_in_smem["greedy_collection"] == (shape != (4096, 64))


MATCHER_CASES = ["dense", "masked", "ties", "nan_inf", "batched", "row_dominated",
                 "non_positive"]


def assignment_weights(rng, shape, case):
    """Plain-P1 weights: d (mu - eta - c) of both signs (the main path's
    range), small integers (ties), NaN / +-inf (+inf entries tie), K = 8
    problems, all non-positive, or row-dominated: w_ij = a_i b_ij with a_i
    spread over three decades, so every column ranks the same rows first."""
    n, m = shape
    lead = (8,) if case == "batched" else ()
    if case == "ties":
        return rng.integers(-2, 4, (n, m)).astype(np.float32)
    if case == "row_dominated":
        a = 10.0 ** rng.uniform(0.0, 3.0, (n, 1))
        return (a * rng.uniform(0.5, 1.5, (n, m))).astype(np.float32)
    if case == "non_positive":
        return -rng.uniform(0.0, 1e6, (n, m)).astype(np.float32)
    w = rng.uniform(-5e5, 1e6, (*lead, n, m)).astype(np.float32)
    if case == "nan_inf":
        w[rng.random(w.shape) < 0.02] = np.nan
        w[rng.random(w.shape) < 0.02] = np.inf
        w[rng.random(w.shape) < 0.02] = -np.inf
    return w


def _entity_masks(rng, card, n, m, pairing=False):
    cu = (rng.random(n) > 0.3).astype(np.float32)
    ec = (rng.random(m) > 0.3).astype(np.float32)
    cu[0] = ec[0] = 1.0
    masks = {"ec_mask": torch.as_tensor(ec, device=card)}
    if not pairing:
        masks["cu_mask"] = torch.as_tensor(cu, device=card)
    return masks


@pytest.mark.parametrize("case", MATCHER_CASES)
@pytest.mark.parametrize("shape", [(1024, 32), (4096, 64), (333, 7), (7, 40)], ids=str)
def test_greedy_assignment_matches_plain_version(card, shape, case):
    """The assignment kernel (candidate lists, a warp-only chain) against its
    plain version on the card, bit for bit, one launch a call; at (7, 40)
    the chain ends when the 7 rows are taken."""
    n, m = shape
    rng = np.random.default_rng(n + 3 * m + len(case))
    w = torch.as_tensor(assignment_weights(rng, shape, case), device=card)
    masks = _entity_masks(rng, card, n, m) if case == "masked" else {}
    before = mkernel.launches["greedy_assignment"]
    got = mops.greedy_assignment(w, impl="kernel", **masks)
    assert mkernel.launches["greedy_assignment"] == before + 1
    assert torch.equal(got, mops.greedy_assignment(w, impl="ref", **masks))
    taken = got.sum(dim=(-2, -1))
    if case == "non_positive":
        assert float(taken.max()) == 0.0
    else:
        assert float(taken.min()) > 0 and float(taken.max()) <= min(n, m)
    assert mkernel.variant["greedy_assignment"] == "candidate_lists"
    assert mkernel.tile_in_smem["greedy_assignment"] == (shape != (4096, 64))


def pairing_values(rng, m, case):
    """(solo, pair) of the Thm.-2 pairing: objectives of both signs, small
    integers (ties; asymmetric_ties leaves pair unsymmetrised, so ties fall
    to the lower flat index j M + k), NaN / +-inf, K = 8 problems, all
    non-positive, or row-dominated: pair_jk = a_j a_k b_jk with a spread over
    three decades, so every row's best column is the same few ECs."""
    lead = (8,) if case == "batched" else ()
    if case in ("ties", "asymmetric_ties"):
        solo = rng.integers(-2, 6, (m,)).astype(np.float32)
        pair = rng.integers(-2, 8, (m, m)).astype(np.float32)
        if case == "ties":
            pair = np.maximum(pair, pair.T)
        return solo, pair
    if case == "row_dominated":
        a = 10.0 ** rng.uniform(0.0, 3.0, m)
        b = rng.uniform(0.5, 1.5, (m, m))
        return ((a * a) * np.diag(b) * 0.5).astype(np.float32), \
            (a[:, None] * a[None, :] * (b + b.T) / 2).astype(np.float32)
    if case == "non_positive":
        return -rng.uniform(0, 1e3, (m,)).astype(np.float32), \
            -rng.uniform(0, 1e3, (m, m)).astype(np.float32)
    solo = rng.uniform(-1e3, 1e4, (*lead, m)).astype(np.float32)
    pair = rng.uniform(-2e3, 2e4, (*lead, m, m)).astype(np.float32)
    pair = np.maximum(pair, np.swapaxes(pair, -1, -2))
    if case == "nan_inf":
        pair[..., m // 3, m // 2] = pair[..., m // 2, m // 3] = np.nan
        pair[..., 0, m - 1] = pair[..., m - 1, 0] = np.inf  # apart from the NaN at every M
    return solo, pair


@pytest.mark.parametrize("case", MATCHER_CASES + ["asymmetric_ties"])
@pytest.mark.parametrize("m", [5, 32, 64, 100])
def test_greedy_pairing_matches_plain_version(card, m, case):
    """The pairing kernel (one warp a problem) against its plain version on
    the card, bit for bit, one launch a call: the register variant up to
    M = 64, the wide one at M = 100. A NaN among the free entries stops the
    loop before anything is taken."""
    rng = np.random.default_rng(7 * m + len(case))
    solo, pair = (torch.as_tensor(a, device=card) for a in pairing_values(rng, m, case))
    masks = _entity_masks(rng, card, 1, m, pairing=True) if case == "masked" else {}
    before = mkernel.launches["greedy_pairing"]
    got = mops.greedy_pairing(solo, pair, impl="kernel", **masks)
    assert mkernel.launches["greedy_pairing"] == before + 1
    assert torch.equal(got, mops.greedy_pairing(solo, pair, impl="ref", **masks))
    if case in ("non_positive", "nan_inf"):
        assert float(got.sum()) == 0.0
    else:
        assert float(got.sum()) > 0
    assert torch.equal(got, got.transpose(-1, -2))
    # Up to M = 64 each lane holds its rows in registers; the wide variant
    # keeps the tile in shared memory.
    assert mkernel.variant["greedy_pairing"] == ("warp" if m <= 64 else "wide")
    assert mkernel.tile_in_smem["greedy_pairing"] == (m > 64)


def test_greedy_assignment_refuses_more_than_64_ecs(card):
    w = torch.ones(4, 65, device=card)
    with pytest.raises(ValueError, match="M <= 64"):
        mops.greedy_assignment(w, impl="kernel")


def test_sampler_draws_the_same_bits_on_card_and_cpu(card):
    """The keyed sampler's 32-bit words, its uniforms and the heterogeneity
    are bit-identical on the card and on the CPU, at the main path's
    1024 x 32 slot."""
    draws = network.slot_draws(1024, 32)
    seed, t = 123456789012345, 17
    bits_c = network.uniform_bits(torch.tensor(seed, device=card), t, draws)
    assert torch.equal(bits_c.cpu(), network.uniform_bits(seed, t, draws, device="cpu"))
    for a, b in zip(network.uniforms(seed, t, draws, device=card),
                    network.uniforms(seed, t, draws, device="cpu")):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(network.heterogeneity(7, 1024, 32, device=card),
                    network.heterogeneity(7, 1024, 32, device="cpu")):
        assert torch.equal(a.cpu(), b)


def _fleet_matcher_inputs(rng, card, op):
    """A fleet's K = 8 distinct problems at the main path's shape (pairing:
    32 ECs), each slice with its own entity masks (a ragged fleet's)."""
    k, n, m = 8, 1024, 32
    cu = (rng.random((k, n)) > 0.1).astype(np.float32)
    ec = (rng.random((k, m)) > 0.1).astype(np.float32)
    cu[:, 0] = ec[:, 0] = 1.0
    masks = {"cu_mask": torch.as_tensor(cu, device=card),
             "ec_mask": torch.as_tensor(ec, device=card)}
    if op == "collection":
        w = np.log(rng.uniform(1.0, 1e6, (k, n, m))).astype(np.float32)
        w[rng.random(w.shape) < 0.2] = -np.inf
        return (torch.as_tensor(w, device=card),), masks
    if op == "assignment":
        w = rng.uniform(-5e5, 1e6, (k, n, m)).astype(np.float32)
        return (torch.as_tensor(w, device=card),), masks
    solo = rng.uniform(-1e3, 1e4, (k, m)).astype(np.float32)
    pair = rng.uniform(-2e3, 2e4, (k, m, m)).astype(np.float32)
    pair = np.maximum(pair, np.swapaxes(pair, -1, -2))
    return (torch.as_tensor(solo, device=card), torch.as_tensor(pair, device=card)), \
        {"ec_mask": masks["ec_mask"]}


@pytest.mark.parametrize("op", ["collection", "assignment", "pairing"])
def test_fleet_batched_matchers_match_plain_version(card, op):
    """A fleet's one matcher call over K = 8 distinct, differently masked
    problems: one launch, bit-equal to the plain version, and slice k
    bit-equal to the kernel on problem k alone (so a fleet slice matches
    as its own single-slice run does)."""
    fn = getattr(mops, f"greedy_{op}")
    args, masks = _fleet_matcher_inputs(np.random.default_rng(len(op)), card, op)
    before = mkernel.launches[f"greedy_{op}"]
    got = fn(*args, impl="kernel", **masks)
    assert mkernel.launches[f"greedy_{op}"] == before + 1
    want = fn(*args, impl="ref", **masks)
    got, want = (got, want) if op == "collection" else ((got,), (want,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k in range(8):
        one = fn(*(a[k] for a in args), impl="kernel", **{n: v[k] for n, v in masks.items()})
        one = one if op == "collection" else (one,)
        for a, b in zip(got, one):
            assert torch.equal(a[k], b)
    assert float(got[0].sum(dim=(-2, -1)).min()) > 0


@pytest.mark.parametrize("fleet", ["l-ds", "mixed"])
def test_fleet_slot_on_card_matches_cpu(card, fleet):
    """One fleet slot at 256 x 16 on the card (kernels) and on the CPU
    (plain versions) from the same state and networks: decisions equal,
    floats within 1e-5 of each slice's scale (the two devices sum in other
    orders), one matcher launch per policy group."""
    from repro_torch import bridge
    from repro_torch.core import (LDS, SWITCHED, CocktailConfig, FleetEngine, SliceJob,
                                  slot_network)
    from repro_torch.core.datasche import ALL_SPECS

    base = CocktailConfig(n_cu=256, n_ec=16, eps=0.2, delta=1e-4, pair_iters=40)
    names = (["l-ds"] * 8 if fleet == "l-ds" else
             ["ds", "l-ds", "no-sdc", "no-slt", "no-lsa", "greedy", "ecself", "cufull"])
    jobs = [SliceJob(dataclasses.replace(base, seed=s, zeta=400.0 + 50 * s), ALL_SPECS[n])
            for s, n in enumerate(names)]
    eng_c = FleetEngine.from_jobs(jobs, device=card)
    eng_p = FleetEngine.from_jobs(jobs, device="cpu")
    assert eng_c.spec == (LDS if fleet == "l-ds" else SWITCHED)
    state, _ = eng_c.run(3)  # a state with backlogs and trained data
    net = slot_network(eng_c.shape, state, eng_c.params)
    mkernel.reset_launch_counts()
    new_c, rec_c, dec_c = eng_c.step(state, net)
    want = ({"greedy_collection": 1, "greedy_assignment": 1, "greedy_pairing": 2}
            if fleet == "l-ds" else
            {"greedy_collection": 1, "greedy_assignment": 2, "greedy_pairing": 3})
    assert dict(mkernel.launches) == want
    new_p, rec_p, dec_p = eng_p.step(bridge.from_numpy(bridge.to_numpy(state), "cpu"),
                                     bridge.from_numpy(bridge.to_numpy(net), "cpu"))
    for f in ("alpha", "theta", "z"):
        assert torch.equal(getattr(dec_c, f).cpu(), getattr(dec_p, f)), f
    pairs = [(f"dec.{f}", getattr(dec_c, f), getattr(dec_p, f)) for f in ("x", "y")]
    pairs += [(f"rec.{f}", getattr(rec_c, f), getattr(rec_p, f)) for f in rec_c._fields]
    for grp in ("queues", "mults", "emp_mults"):
        pairs += [(f"{grp}.{f}", getattr(getattr(new_c, grp), f), getattr(getattr(new_p, grp), f))
                  for f in getattr(new_c, grp)._fields]
    for name, a, b in pairs:
        for k in range(len(jobs)):
            scale = float(b[k].abs().max()) or 1.0
            err = float((a[k].double().cpu() - b[k].double()).abs().max()) / scale
            assert err <= 1e-5, f"{name} slice {k}: {err:.3e} of scale"
    assert float(dec_p.alpha.sum()) > 0


# The attention Function (the kernel route under autograd) at train-like
# shapes: bf16 on the wgmma kernel, float32 on the SIMT kernel.
TRAIN_ATTN_CASES = [
    (2, 128, 8, 2, 128, torch.bfloat16, AttnSpec(causal=True)),
    (2, 64, 4, 1, 64, torch.bfloat16, AttnSpec(causal=True, window=32)),
    (2, 32, 4, 2, 16, torch.float32, AttnSpec(causal=True)),
]


@pytest.mark.parametrize("case", TRAIN_ATTN_CASES, ids=str)
def test_attention_function_forward_is_the_kernel_and_grads_the_recompute(card, case):
    """Under autograd the kernel route launches the kernel once (its output
    bit-equal to the kernel called directly) and its dq, dk, dv are
    bit-equal to autograd through ``attention_chunked``."""
    b, s, h, hkv, hd, dtype, spec = case
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=card).to(dtype)
                  for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd)))
    pos = torch.arange(s, dtype=torch.int32, device=card).expand(b, s).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fkernel.launches["flash_attention"]
    out = fops.flash_attention(*leaves, pos, pos, spec)
    assert fkernel.launches["flash_attention"] == before + 1 and out.requires_grad
    assert torch.equal(out.detach(), fkernel.flash_attention_cuda(q, k, v, pos, pos, spec))
    grads = torch.autograd.grad(out, leaves, g)
    plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fops.attention_chunked(*plain_leaves, pos, pos, spec),
                               plain_leaves, g)
    assert fkernel.launches["flash_attention"] == before + 2  # the direct call only
    for a, c in zip(grads, want):
        assert torch.equal(a, c)


# The scan's backward kernel: (B, S, DI, N), type, with h0 and a gradient
# of the final state, b / c as strided slices of one x_proj-shaped product.
# The train shape of falcon-mamba-7b, B 2 x 2048, N 8 and 32, odd S and DI;
# then the edges of the kernel's 8-step chunk (S 7, 8, 9) and DI 65 (one
# channel in a second block, rows not 16-byte aligned) at N 1 and 32. S 300
# and 2048 keep more checkpoints than shared memory holds.
SCAN_BWD_CASES = [
    ((16, 128, 8192, 16), torch.bfloat16, False, True),
    ((2, 2048, 1024, 16), torch.float32, True, False),
    ((2, 2048, 1024, 16), torch.bfloat16, True, True),
    ((3, 77, 1000, 8), torch.float32, True, False),
    ((2, 300, 512, 32), torch.float32, True, False),
    ((2, 99, 513, 16), torch.bfloat16, True, True),
    ((1, 5, 3, 4), torch.float32, False, False),
    ((2, 7, 256, 16), torch.bfloat16, True, True),
    ((2, 8, 256, 16), torch.float32, True, False),
    ((2, 9, 256, 16), torch.bfloat16, False, True),
    ((2, 33, 65, 1), torch.float32, True, False),
    ((2, 33, 65, 32), torch.bfloat16, True, True),
]
# Of each gradient's scale: float32 sums in other orders (and ex2.approx
# for exp); bf16 gradients are one rounding of float32 sums.
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _scan_bwd_inputs(card, shape, dtype, with_h0, strided, seed=5):
    b, s, di, n = shape
    rng = np.random.default_rng(seed)

    def t(size, lo=None, hi=None):
        v = rng.normal(size=size) if lo is None else rng.uniform(lo, hi, size)
        return torch.as_tensor(v.astype(np.float32), device=card)

    x, dt = t((b, s, di)).to(dtype), t((b, s, di), 0.001, 0.1).to(dtype)
    a = -torch.exp(t((di, n), 0.0, float(np.log(16.0))))
    if strided:
        _, bm, cm = t((b, s, 256 + 2 * n)).to(dtype).split([256, n, n], dim=-1)
    else:
        bm, cm = t((b, s, n)).to(dtype), t((b, s, n)).to(dtype)
    h0, gh = (t((b, di, n)), t((b, di, n))) if with_h0 else (None, None)
    return x, dt, a, bm, cm, h0, t((b, s, di)).to(dtype), gh


def _of_scale(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=str)
def test_scan_backward_kernel_matches_plain_version(card, case):
    """Every gradient (x, dt, a, b, c, h0) of the backward kernel against
    ``mamba1_scan_bwd_ref`` on the same inputs, one launch a call."""
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.kernels.mamba_scan.ref import mamba1_scan_bwd_ref
    shape, dtype, with_h0, strided = case
    args = _scan_bwd_inputs(card, shape, dtype, with_h0, strided)
    before = skernel.launches["mamba1_scan_bwd"]
    got = skernel.mamba1_scan_bwd_cuda(*args)
    assert skernel.launches["mamba1_scan_bwd"] == before + 1
    want = mamba1_scan_bwd_ref(*args)
    for name, g, w in zip(("x", "dt", "a", "b", "c", "h0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _of_scale(g, w) <= SCAN_BWD_TOL[dtype], (name, _of_scale(g, w))


@pytest.mark.parametrize("case", SCAN_BWD_CASES[:3], ids=str)
def test_scan_backward_kernel_is_deterministic(card, case):
    """The cross-block sums go through a workspace summed in a fixed order
    (no atomics): two calls give the same bits."""
    from repro_torch.kernels.mamba_scan import kernel as skernel
    args = _scan_bwd_inputs(card, *case)
    first = skernel.mamba1_scan_bwd_cuda(*args)
    second = skernel.mamba1_scan_bwd_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_scan_route_under_autograd_launches_both_kernels(card):
    """Under autograd the kernel route goes through ``KernelScan``: the
    forward kernel once (its outputs bit-equal to the kernel called
    directly), the backward kernel once in the backward, gradients within
    1e-4 of scale of autograd through ``mamba1_scan_chunked``; never the
    plain scan."""
    from repro_torch.kernels.mamba_scan import kernel as skernel
    x, dt, a, bm, cm, h0, gy, gh = _scan_bwd_inputs(card, (2, 64, 256, 16), torch.float32,
                                                    True, False)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, h0)]
    before = dict(skernel.launches)
    y, h = sops.mamba1_scan(*leaves[:5], h0=leaves[5])
    assert type(y.grad_fn).__name__ == "KernelScanBackward"
    direct = skernel.mamba1_scan_cuda(x, dt, a, bm, cm, h0)
    assert torch.equal(y.detach(), direct[0]) and torch.equal(h.detach(), direct[1])
    got = torch.autograd.grad((y, h), leaves, (gy, gh))
    assert {k: skernel.launches[k] - before[k] for k in before} == {
        "mamba1_scan": 2, "mamba1_scan_bwd": 1}
    plain = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, h0)]
    yp, hp = sops.mamba1_scan(*plain[:5], h0=plain[5], impl="chunked")
    want = torch.autograd.grad((yp, hp), plain, (gy, gh))
    for g, w in zip(got, want):
        assert _of_scale(g, w) <= 1e-4


@pytest.mark.parametrize("arch", ["minitron-4b", "falcon-mamba-7b"])
def test_serving_launches_unchanged_with_trainable_weights(card, arch):
    """A reduced model on the card: the prefill step and a decode step launch
    one kernel a layer (attention or scan) whether or not the weights
    require grad; a recorded forward launches the attention or scan kernel
    once a layer, and its remat backward once more (the scan's backward
    kernel once a layer besides)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    cfg = reduced(get_config(arch))
    api = build_model(cfg, device=card)
    name = "flash_attention" if cfg.family == "dense" else "mamba1_scan"
    counts = fkernel.launches if cfg.family == "dense" else skernel.launches
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=card)
    for trainable in (False, True):
        model = api.init(0).requires_grad_(trainable)
        before = counts[name]
        logits = make_prefill_step(api)(model, {"tokens": tokens})
        assert counts[name] == before + cfg.n_layers and not logits.requires_grad
        cache = api.init_cache(2, 4)
        before = counts[name]
        make_serve_step(api)(model, cache, tokens[:, :1])
        assert counts[name] == before + cfg.n_layers
    cfg = dataclasses.replace(cfg, remat=True)
    api = build_model(cfg, device=card)
    model = api.init(0).requires_grad_(True)
    before = dict(counts)
    loss, _ = api.loss(model, {"tokens": tokens, "labels": tokens.long()})
    assert counts[name] == before[name] + cfg.n_layers
    torch.autograd.grad(loss, list(model.parameters()))
    assert counts[name] == before[name] + 2 * cfg.n_layers
    if cfg.family == "ssm":  # and the backward kernel once a layer
        assert counts["mamba1_scan_bwd"] == before["mamba1_scan_bwd"] + cfg.n_layers
