"""The port's Mamba-1 selective scan (``repro_torch.kernels.mamba_scan``)
against the JAX package's sequential ``mamba1_scan_ref`` and its Pallas
kernel in interpret mode, on the same numpy-seeded inputs, with and without
an initial state and at S = 1 (decode). Tolerance 2e-4, the JAX package's
own (``tests/test_kernels.py``). The CUDA kernel is held against these
plain versions on the card by ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan.kernel import mamba1_scan_pallas  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba1_scan_ref as j_scan_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as tkernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba1_scan_ref  # noqa: E402

TOL = 2e-4
# (B, S, DI, N)
SHAPES = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4), (2, 1, 32, 16)]


def _inputs(shape, seed, with_h0):
    b, s, di, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, s, di)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(di, n)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if with_h0 else None
    return x, dt, a, bm, cm, h0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
def test_ref_and_chunked_match_jax_and_pallas(shape, with_h0):
    arrays = _inputs(shape, 17, with_h0)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    targs = [None if a is None else torch.as_tensor(a) for a in arrays]
    y_want, h_want = j_scan_ref(*jargs[:5], h0=jargs[5])
    y_pal, h_pal = mamba1_scan_pallas(*jargs[:5], h0=jargs[5], chunk=32, block_d=16,
                                      interpret=True)
    for y, h in (mamba1_scan_ref(*targs[:5], h0=targs[5]),
                 tops.mamba1_scan_chunked(*targs[:5], h0=targs[5], chunk=32),
                 tops.mamba1_scan(*targs[:5], h0=targs[5], chunk=32)):
        assert y.shape == targs[0].shape and h.dtype == torch.float32
        for got, want in ((y, y_want), (h, h_want), (y, y_pal), (h, h_pal)):
            _close(got, want)


def test_decode_steps_continue_the_prefill():
    """S = 1 steps from the carried state reproduce the full scan."""
    x, dt, a, bm, cm, _ = (torch.as_tensor(v) if v is not None else None
                           for v in _inputs((2, 12, 32, 16), 5, False))
    y_full, h_full = tops.mamba1_scan(x, dt, a, bm, cm)
    y_pre, h = tops.mamba1_scan(x[:, :4], dt[:, :4], a, bm[:, :4], cm[:, :4])
    ys = [y_pre]
    for t in range(4, 12):
        y, h = tops.mamba1_scan(x[:, t:t + 1], dt[:, t:t + 1], a, bm[:, t:t + 1],
                                cm[:, t:t + 1], h0=h)
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_full)
    _close(h, h_full)


def test_bfloat16_inputs_keep_their_type():
    x, dt, a, bm, cm, h0 = _inputs((1, 32, 16, 8), 9, True)
    tb = [torch.as_tensor(v).to(torch.bfloat16) for v in (x, dt)]
    y, h = tops.mamba1_scan_chunked(*tb, torch.as_tensor(a), torch.as_tensor(bm).bfloat16(),
                                    torch.as_tensor(cm).bfloat16(), torch.as_tensor(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_want, h_want = j_scan_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt, jnp.bfloat16),
                                jnp.asarray(a), jnp.asarray(bm, jnp.bfloat16),
                                jnp.asarray(cm, jnp.bfloat16), h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32),
                               rtol=2e-2, atol=2e-2)
    _close(h, h_want)


def test_dispatch_and_refusals():
    x, dt, a, bm, cm, _ = (torch.as_tensor(v) if v is not None else None
                           for v in _inputs((1, 8, 16, 4), 2, False))
    with pytest.raises(ValueError, match="impl"):
        tops.mamba1_scan(x, dt, a, bm, cm, impl="pallas")
    before = dict(tkernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tops.mamba1_scan(x, dt, a, bm, cm, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.mamba1_scan_cuda(x, dt, a, bm, cm)
    assert tkernel.launches == before


# (B, S, DI, N): b and c as strided slices of one (B, S, r + 2N) tensor, as
# models/ssm.py passes the x_proj product to the scan, prefill and decode.
STRIDED_SHAPES = [(2, 64, 32, 16), (1, 40, 24, 8), (2, 1, 32, 16)]


@pytest.mark.parametrize("shape", STRIDED_SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=str)
def test_strided_bfloat16_bc_match_jax(shape, x_dtype):
    """b / c as strided bf16 slices (r = 12) through ``ops.mamba1_scan``
    (chunked and ref) against the JAX ``mamba1_scan_ref`` on the same bf16
    values. y within 2e-4 (2e-2 where x and dt are bf16, as
    ``test_bfloat16_inputs_keep_their_type``), the float32 state within 2e-4."""
    b, s, di, n = shape
    x, dt, a, _, _, h0 = _inputs(shape, 23, s == 1)
    proj = np.random.default_rng(29).normal(size=(b, s, 12 + 2 * n)).astype(np.float32)
    tproj = torch.as_tensor(proj).bfloat16()
    _, tb, tc = tproj.split([12, n, n], dim=-1)
    assert not tb.is_contiguous() and tb.stride() == (s * (12 + 2 * n), 12 + 2 * n, 1)
    tx, tdt = (torch.as_tensor(v).to(x_dtype) for v in (x, dt))
    th0 = torch.as_tensor(h0) if h0 is not None else None
    jx, jdt = (jnp.asarray(v, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
               for v in (x, dt))
    jproj = jnp.asarray(proj, jnp.bfloat16)
    y_want, h_want = j_scan_ref(jx, jdt, jnp.asarray(a), jproj[..., 12:12 + n],
                                jproj[..., 12 + n:], h0=None if h0 is None else jnp.asarray(h0))
    tol_y = TOL if x_dtype == torch.float32 else 2e-2
    for impl in ("chunked", "ref"):
        y, h = tops.mamba1_scan(tx, tdt, torch.as_tensor(a), tb, tc, h0=th0, chunk=16,
                                impl=impl)
        assert y.dtype == x_dtype and h.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32),
                                   rtol=tol_y, atol=tol_y)
        _close(h, h_want)


def test_kernel_wrapper_refuses_what_it_cannot_read():
    """The kernel reads b and c in their own type with their own B and S
    strides, but needs float32 or bfloat16, one type for both and a unit
    stride along N; anything else raises before a launch (no copy, no
    fallback), as a CPU tensor does."""
    x, dt, a, bm, cm, _ = (torch.as_tensor(v) if v is not None else None
                           for v in _inputs((1, 8, 16, 4), 2, False))
    before = dict(tkernel.launches)
    with pytest.raises(TypeError, match="b and c"):
        tkernel.mamba1_scan_cuda(x, dt, a, bm.half(), cm.half())
    with pytest.raises(TypeError, match="b and c"):
        tkernel.mamba1_scan_cuda(x, dt, a, bm.bfloat16(), cm)
    wide = torch.as_tensor(np.random.default_rng(3).normal(size=(1, 8, 4, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="unit stride along N"):
        tkernel.mamba1_scan_cuda(x, dt, a, wide[..., 0], cm)
    with pytest.raises(ValueError, match="CUDA"):  # strided bf16 slices pass the checks
        proj = torch.zeros((1, 8, 3 + 8), dtype=torch.bfloat16)
        tkernel.mamba1_scan_cuda(x, dt, a, proj[..., 3:7], proj[..., 7:])
    assert tkernel.launches == before


def test_kernel_source_and_build_flags():
    """The Hopper design the kernel source commits to: one MUFU.EX2 per
    exponential (ex2.approx.ftz, not expf), x / dt through cp.async, y
    summed over a lane group with shuffles, b / c read in their own type with
    their own strides; built with ptxas's report and nvcc's default
    contraction (never --fmad=false), keyed by source and flags."""
    from repro_torch.kernels import _build
    text = tkernel.SOURCES[0].read_text()
    for needle in ("int mamba1_scan_launch(", "ex2.approx.ftz.f32", "cp.async.cg.shared.global",
                   "__shfl_xor_sync", "long long b_sb, long long b_ss", "int bc_dtype"):
        assert needle in text, needle
    assert "expf(" not in text
    assert "-v" in tkernel.EXTRA_FLAGS and "--fmad=false" not in tkernel.EXTRA_FLAGS
    assert tkernel.library_path() == _build.library_path("mamba1_scan", tkernel.SOURCES,
                                                         tkernel.EXTRA_FLAGS)
    assert tkernel.library_path() != _build.library_path("mamba1_scan", tkernel.SOURCES)
