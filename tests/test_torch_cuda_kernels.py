"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs a CUDA card: it is marked ``cuda`` and
skips without one. This file imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
from __future__ import annotations

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
