"""The port's attention (``repro_torch.kernels.flash_attention``) against the
JAX package's: the exact reference, the plain online-softmax version and
the grouped decode path against ``repro``'s ``attention_ref`` and its Pallas
kernel in interpret mode, on the same numpy-seeded inputs.

Tolerances are the JAX package's own (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16. Rows that see no key must be exactly 0. The CUDA
kernel is held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import AttnSpec as JSpec  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import AttnSpec, attention_ref  # noqa: E402

# (B, Sq, Skv, H, Hkv, hd, spec): tests/test_kernels.py's cases, then GQA 4:1
# and a head dim of 80.
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, AttnSpec(causal=True)),
    (1, 256, 256, 8, 8, 32, AttnSpec(causal=True, window=64)),
    (2, 128, 128, 4, 1, 64, AttnSpec(causal=True, softcap=30.0)),
    (1, 64, 192, 4, 2, 32, AttnSpec(causal=False)),
    (1, 128, 128, 2, 2, 16, AttnSpec(causal=True, prefix_len=32)),
    (1, 128, 128, 8, 2, 32, AttnSpec(causal=True)),
    (1, 64, 64, 2, 1, 80, AttnSpec(causal=True)),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _jspec(spec: AttnSpec) -> JSpec:
    return JSpec(causal=spec.causal, window=spec.window, softcap=spec.softcap,
                 prefix_len=spec.prefix_len)


def _inputs(case, seed):
    b, sq, skv, h, hkv, hd, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    return q, k, v, qp, kp


def _both(arrays, tdt, jdt):
    """The same numpy arrays as port tensors and as JAX arrays (floats in the
    given type, positions int32, validity bool)."""
    def conv(a):
        if a is None:
            return None, None
        if a.dtype == np.float32:
            return torch.as_tensor(a).to(tdt), jnp.asarray(a, jdt)
        return torch.as_tensor(a), jnp.asarray(a)
    pairs = [conv(a) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_and_chunked_match_jax_and_pallas(case, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    spec = case[-1]
    (q, k, v, qp, kp), jargs = _both(_inputs(case, 7), tdt, jdt)
    want = j_attention_ref(*jargs, _jspec(spec))
    pallas = flash_attention_pallas(*jargs, _jspec(spec), interpret=True,
                                    block_q=64, block_kv=64)
    ref = attention_ref(q, k, v, qp, kp, spec)
    chunked = tops.attention_chunked(q, k, v, qp, kp, spec, q_chunk=32, kv_chunk=32)
    for got in (ref, chunked):
        assert got.dtype == tdt and got.shape == q.shape
        _close(got, want, tol)
        _close(got, pallas, tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_group_path_matches_jax(case):
    spec = case[-1]
    (q, k, v, qp, kp), jargs = _both(_inputs(case, 11), torch.float32, jnp.float32)
    want = j_attention_ref(*jargs, _jspec(spec), gqa="group")
    _close(attention_ref(q, k, v, qp, kp, spec, gqa="group"), want, 2e-5)


def _decode_inputs(seed: int = 3):
    """One query row over a 48-slot ring buffer per batch row: slots hold
    permuted absolute positions, some slots are empty (position -1, invalid)
    and the last batch row's visible slots all lie after its query (a row
    that sees no key)."""
    b, skv, h, hkv, hd = 3, 48, 8, 2, 32
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)]).astype(np.int32)
    kp[0, rng.random(skv) < 0.25] = -1
    kp[1, :10] = -1
    qp = np.array([[140], [130], [20]], np.int32)
    valid = kp >= 0
    return q, k, v, qp, kp, valid


@pytest.mark.parametrize("spec", [AttnSpec(causal=True), AttnSpec(causal=True, window=16),
                                  AttnSpec(causal=True, softcap=20.0)], ids=str)
def test_decode_ring_buffer_matches_jax(spec):
    (q, k, v, qp, kp, valid), jargs = _both(_decode_inputs(), torch.float32, jnp.float32)
    jq, jk, jv, jqp, jkp, jvalid = jargs
    want = j_attention_ref(jq, jk, jv, jqp, jkp, _jspec(spec), kv_valid=jvalid)
    pallas = flash_attention_pallas(jq, jk, jv, jqp, jkp, _jspec(spec), kv_valid=jvalid,
                                    interpret=True, block_q=64, block_kv=16)
    outs = [
        tops.flash_attention(q, k, v, qp, kp, spec, kv_valid=valid),  # CPU: grouped ref
        tops.attention_chunked(q, k, v, qp, kp, spec, kv_valid=valid, kv_chunk=16),
        attention_ref(q, k, v, qp, kp, spec, kv_valid=valid),
    ]
    for got in outs:
        _close(got, want, 2e-5)
        _close(got, pallas, 2e-5)
        assert torch.equal(got[2], torch.zeros_like(got[2]))  # sees no key: exactly 0
        assert bool(got[:2].abs().sum(dim=(1, 2, 3)).gt(0).all())
    assert np.all(np.asarray(want[2]) == 0)


def test_fully_masked_rows_are_exactly_zero():
    """Query rows whose keys are all invalid, in a tile where other rows see
    keys: -1e30 masking keeps them finite, and they are written as 0."""
    case = (2, 64, 64, 4, 2, 16, AttnSpec(causal=False))
    q, k, v, qp, kp = _inputs(case, 5)
    valid = np.ones((2, 64), bool)
    valid[1] = False
    (tq, tk, tv, tqp, tkp, tvalid), jargs = _both((q, k, v, qp, kp, valid),
                                                  torch.float32, jnp.float32)
    want = j_attention_ref(*jargs[:5], _jspec(case[-1]), kv_valid=jargs[5])
    for got in (attention_ref(tq, tk, tv, tqp, tkp, case[-1], tvalid),
                tops.attention_chunked(tq, tk, tv, tqp, tkp, case[-1], tvalid, kv_chunk=16)):
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        assert bool(torch.isfinite(got).all())
        _close(got, want, 2e-5)


def test_dispatch_and_refusals():
    case = ATTN_CASES[0]
    q, k, v, qp, kp = (torch.as_tensor(a) for a in _inputs(case, 1))
    spec = case[-1]
    torch.testing.assert_close(tops.flash_attention(q, k, v, qp, kp, spec),
                               tops.attention_chunked(q, k, v, qp, kp, spec), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, qp, kp, spec, impl="pallas")
    before = dict(tkernel.launches)
    assert set(before) == {"flash_attention", "flash_attention_wgmma"}
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, qp, kp, spec, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_cuda(q, k, v, qp, kp, spec)
    with pytest.raises(ValueError, match="CUDA"):  # the forced kernel refuses them as well
        tkernel.flash_attention_cuda(q, k, v, qp, kp, spec, force_simt=True)
    assert tkernel.launches == before
    tkernel.reset_launch_counts()
    assert tkernel.launches == {"flash_attention": 0, "flash_attention_wgmma": 0}


@pytest.mark.parametrize("sq", [1, 16, 63, 64, 333, 2048])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
def test_kernel_variant(dtype, hd, sq):
    """bf16 with hd 64 or 128 and at least 64 query rows takes the wgmma
    kernel; float32, other head dims and decode-sized calls the SIMT one."""
    wgmma = dtype == torch.bfloat16 and hd in (64, 128) and sq >= 64
    assert tkernel.variant(dtype, hd, sq) == ("wgmma" if wgmma else "simt")


def test_kernel_source_and_build_flags():
    """The library is keyed by its sources and flags, built for sm_90a with
    nvcc's default contraction (only the matchers pass --fmad=false), and the
    module imports without compiling anything."""
    from repro_torch.kernels.matching import kernel as mkernel
    from repro_torch.kernels.mamba_scan import kernel as skernel
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" not in _build.NVCC_FLAGS and "--fmad=false" in mkernel.EXTRA_FLAGS
    path = _build.library_path("flash_attention", tkernel.SOURCES)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert path != _build.library_path("flash_attention", tkernel.SOURCES, ("--fmad=false",))
    assert "int flash_attention_launch(" in tkernel.SOURCES[0].read_text()
    assert "int mamba1_scan_launch(" in skernel.SOURCES[0].read_text()
    # The wgmma kernel: its own entry in the same library, both products as
    # wgmma (bf16 in, float32 out), k / v through cp.async; built with
    # nvcc's default contraction and ptxas's report, never --fmad=false.
    sm90 = tkernel.SOURCES[1]
    assert sm90.name == "flash_attention_sm90.cu" and len(tkernel.SOURCES) == 2
    text = sm90.read_text()
    assert "int flash_attention_wgmma_launch(" in text
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in text
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in text
    assert "cp.async.cg.shared.global" in text
    assert "--fmad=false" not in tkernel.EXTRA_FLAGS and "-v" in tkernel.EXTRA_FLAGS
    assert tkernel.library_path() == _build.library_path("flash_attention", tkernel.SOURCES,
                                                         tkernel.EXTRA_FLAGS)
    assert tkernel.library_path() != path  # keyed by both sources and the flags
    code = ("import repro_torch.kernels.flash_attention.ops as o, "
            "repro_torch.kernels.mamba_scan.ops as s; "
            "assert o.kernel._lib is None and s.kernel._lib is None")
    env = {**os.environ, "PYTHONPATH": str(_build.REPO_ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
