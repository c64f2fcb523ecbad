"""The Mamba-1 scan's gradient in the port: the plain backward
(``ref.mamba1_scan_bwd_ref``, the backward kernel's plain version) against
``jax.vjp`` of the JAX package's ``mamba1_scan_ref`` and
``mamba1_scan_chunked``; ``ops.KernelScan`` (the kernel route under
autograd) with its two kernels replaced by their plain versions, which the
CPU can run: ``gradcheck`` in float64 and its launches under remat
(``tests/test_torch_train.py`` holds a reduced falcon-mamba-7b train step
through it against the JAX ``make_train_step``). The CUDA kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.

Tolerances (of each gradient's scale): float32 1e-5 (other summation
orders); bf16 x / dt and strided bf16 b / c 2e-2 (each side rounds its
gradients to bf16 once, from float32 sums in other orders).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba1_scan_chunked as j_scan_chunked  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba1_scan_ref as j_scan_ref  # noqa: E402
from repro_torch.configs import ArchConfig  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as skernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as sops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    mamba1_scan_bwd_ref, mamba1_scan_bwd_schedule_reference, mamba1_scan_ref)
from repro_torch.models import build_model  # noqa: E402
from test_torch_train import _within  # noqa: E402

NAMES = ("x", "dt", "a", "b", "c", "h0")
F32_TOL, BF16_TOL = 1e-5, 2e-2

# (B, S, DI, N), x / dt type (bf16: b / c as strided bf16 slices of one
# x_proj-shaped product), with h0, the final state's gradient nonzero, and
# the JAX chunked scan's chunk (S = 40 over 16 takes chunks of 8).
BWD_CASES = {
    "f32": ((2, 32, 16, 8), "float32", False, False, 16),
    "f32_h0_gh": ((2, 32, 16, 8), "float32", True, True, 16),
    "f32_gh": ((1, 24, 12, 4), "float32", False, True, 8),
    "f32_h0": ((2, 16, 20, 16), "float32", True, False, 8),
    "f32_s40_chunk16": ((2, 40, 16, 8), "float32", True, True, 16),
    "bf16_strided_h0_gh": ((2, 32, 16, 8), "bfloat16", True, True, 16),
    "bf16_strided": ((1, 24, 32, 16), "bfloat16", False, False, 8),
}


def _bwd_inputs(shape, dtype: str, with_h0: bool, with_gh: bool, seed: int = 0):
    """numpy inputs, then the port's tensors and JAX's arrays of the same
    values: bf16 where ``dtype`` is, b / c then as slices of one (B, S,
    r + 2N) bf16 product (r = 6)."""
    b, s, di, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, size=(b, s, di)).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, np.log(8.0), size=(di, n))).astype(np.float32)
    proj = rng.normal(size=(b, s, 6 + 2 * n)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if with_h0 else None
    gy = rng.normal(size=(b, s, di)).astype(np.float32)
    gh = rng.normal(size=(b, di, n)).astype(np.float32) if with_gh else None
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tproj = torch.as_tensor(proj).to(tdt)
    _, tb, tc = tproj.split([6, n, n], dim=-1)
    jproj = jnp.asarray(proj, jdt)
    port = dict(x=torch.as_tensor(x).to(tdt), dt=torch.as_tensor(dt).to(tdt),
                a=torch.as_tensor(a), b=tb, c=tc,
                h0=None if h0 is None else torch.as_tensor(h0),
                gy=torch.as_tensor(gy).to(tdt), gh=None if gh is None else torch.as_tensor(gh))
    jax_ = dict(x=jnp.asarray(x, jdt), dt=jnp.asarray(dt, jdt), a=jnp.asarray(a),
                b=jproj[..., 6:6 + n], c=jproj[..., 6 + n:],
                h0=None if h0 is None else jnp.asarray(h0), gy=jnp.asarray(gy, jdt),
                gh=jnp.zeros((b, di, n), jnp.float32) if gh is None else jnp.asarray(gh))
    return port, jax_


@pytest.mark.parametrize("target", ["ref", "chunked"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_ref_matches_jax_vjp(case, target):
    """``mamba1_scan_bwd_ref`` against ``jax.vjp`` of the JAX package's
    sequential scan and of its chunked scan (the function JAX differentiates
    off the TPU), with and without h0 and a gradient of the final state."""
    shape, dtype, with_h0, with_gh, chunk = BWD_CASES[case]
    port, jx = _bwd_inputs(shape, dtype, with_h0, with_gh)
    fn = j_scan_ref if target == "ref" else (
        lambda *args, h0=None: j_scan_chunked(*args, h0=h0, chunk=chunk))
    names = NAMES if with_h0 else NAMES[:5]

    def scan(*args):
        return fn(*args[:5], h0=args[5] if with_h0 else None)

    _, vjp = jax.vjp(scan, *(jx[k] for k in names))
    want = vjp((jx["gy"], jx["gh"]))
    got = mamba1_scan_bwd_ref(*(port[k] for k in NAMES), port["gy"], port["gh"])
    assert got[0].dtype == port["x"].dtype and got[3].dtype == port["b"].dtype
    assert got[2].dtype == got[5].dtype == torch.float32
    assert got[3].shape == port["b"].shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(names, got, want):
        _within(g.float().numpy(), np.asarray(w, np.float32), tol, name)


_JAX_CHUNKED_GRADS: dict = {}


def _jax_chunked_grads(case):
    """``jax.vjp`` of the JAX package's ``mamba1_scan_chunked`` at a case
    of BWD_CASES (its own chunk), once per case."""
    if case not in _JAX_CHUNKED_GRADS:
        shape, dtype, with_h0, with_gh, chunk = BWD_CASES[case]
        _, jx = _bwd_inputs(shape, dtype, with_h0, with_gh)
        names = NAMES if with_h0 else NAMES[:5]

        def scan(*args):
            return j_scan_chunked(*args[:5], h0=args[5] if with_h0 else None, chunk=chunk)

        _, vjp = jax.vjp(scan, *(jx[k] for k in names))
        _JAX_CHUNKED_GRADS[case] = [np.asarray(w, np.float32) for w in vjp((jx["gy"], jx["gh"]))]
    return _JAX_CHUNKED_GRADS[case]


@pytest.mark.parametrize("target", ["chunked", "plain"])
@pytest.mark.parametrize("chunk", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_schedule_reference(case, chunk, target):
    """The backward kernel's schedule and algebra in plain PyTorch
    (checkpoints every ``chunk`` steps, the chunk recomputed with alpha and
    u = alpha h_{t-1} kept, the sequence zero-padded to whole chunks: S 24,
    32 and 40 over chunks of 3, 16 and 32) against ``jax.vjp`` of the JAX
    package's chunked scan and against ``mamba1_scan_bwd_ref``."""
    shape, dtype, with_h0, with_gh, _ = BWD_CASES[case]
    port, _ = _bwd_inputs(shape, dtype, with_h0, with_gh)
    args = [port[k] for k in NAMES] + [port["gy"], port["gh"]]
    got = mamba1_scan_bwd_schedule_reference(*args, chunk=chunk)
    names = NAMES if with_h0 else NAMES[:5]
    if target == "chunked":
        want = _jax_chunked_grads(case)
    else:
        want = [w.float().numpy() for w in mamba1_scan_bwd_ref(*args)]
    assert got[0].dtype == port["x"].dtype and got[3].dtype == port["b"].dtype
    assert got[2].dtype == got[5].dtype == torch.float32 and got[3].shape == port["b"].shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(names, got, want):
        _within(g.float().numpy(), w, tol, name)


def plain_scan_kernels(monkeypatch) -> dict:
    """Replace the two CUDA kernels by their plain versions (the CPU cannot
    run them), counting the calls as the wrappers count launches."""
    calls = {"mamba1_scan": 0, "mamba1_scan_bwd": 0}

    def fwd(*args):
        calls["mamba1_scan"] += 1
        return mamba1_scan_ref(*args)

    def bwd(*args):
        calls["mamba1_scan_bwd"] += 1
        return mamba1_scan_bwd_ref(*args)

    monkeypatch.setattr(skernel, "mamba1_scan_cuda", fwd)
    monkeypatch.setattr(skernel, "mamba1_scan_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
def test_kernel_scan_gradcheck(with_h0, monkeypatch):
    """``KernelScan`` (forward kernel, backward kernel) with the kernels
    replaced by their plain versions: float64 gradcheck of both outputs,
    each output's gradient alone given (the other's None)."""
    calls = plain_scan_kernels(monkeypatch)
    rng = np.random.default_rng(4)
    b, s, di, n = 2, 5, 3, 4
    x = torch.as_tensor(rng.normal(size=(b, s, di)))
    dt = torch.as_tensor(rng.uniform(0.05, 0.5, size=(b, s, di)))
    a = -torch.as_tensor(rng.uniform(0.5, 2.0, size=(di, n)))
    bm, cm = (torch.as_tensor(rng.normal(size=(b, s, n))) for _ in range(2))
    h0 = torch.as_tensor(rng.normal(size=(b, di, n))) if with_h0 else None
    leaves = [t.requires_grad_() for t in (x, dt, a, bm, cm) + ((h0,) if with_h0 else ())]

    def fn(*args):
        return sops.KernelScan.apply(*args[:5], args[5] if with_h0 else None)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-7, rtol=1e-6)
    assert calls["mamba1_scan_bwd"] > 0
    y, h = fn(*leaves)  # only y's gradient, then only h's
    for out in (y, h):
        got = torch.autograd.grad(out.sum(), leaves, retain_graph=True)
        ref_y, ref_h = mamba1_scan_ref(*leaves[:5], h0=leaves[5] if with_h0 else None)
        want = torch.autograd.grad((ref_y if out is y else ref_h).sum(), leaves,
                                   allow_unused=True)  # c does not reach h
        for g, w in zip(got, want):
            assert torch.allclose(g, torch.zeros_like(g) if w is None else w,
                                  rtol=1e-10, atol=1e-12)


def test_scan_kernel_route_under_autograd_is_the_function(monkeypatch):
    """A recorded kernel-route call goes through ``KernelScan`` (one forward
    launch, one backward launch); an unrecorded one launches the forward
    kernel alone; with the real wrappers, a CPU tensor is refused by the
    wrapper's ValueError, recorded or not: no fallback to the plain scan."""
    x, dt = torch.zeros((1, 8, 16)), torch.full((1, 8, 16), 0.1)
    a, b, c = -torch.ones((16, 4)), torch.ones((1, 8, 4)), torch.ones((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        sops.mamba1_scan(x.clone().requires_grad_(), dt, a, b, c, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        sops.mamba1_scan(x, dt, a, b, c, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        skernel.mamba1_scan_bwd_cuda(x, dt, a, b, c, None, x)
    calls = plain_scan_kernels(monkeypatch)
    leaf = x.clone().requires_grad_()
    y, _ = sops.mamba1_scan(leaf, dt, a, b, c, impl="kernel")
    assert type(y.grad_fn).__name__ == "KernelScanBackward"
    y.sum().backward()
    assert calls == {"mamba1_scan": 1, "mamba1_scan_bwd": 1}
    with torch.no_grad():
        y, _ = sops.mamba1_scan(leaf, dt, a, b, c, impl="kernel")
    assert y.grad_fn is None and calls == {"mamba1_scan": 2, "mamba1_scan_bwd": 1}
    _, h = sops.mamba1_scan(leaf, dt, a, b, c, impl="kernel")  # only h's gradient
    _within(torch.autograd.grad(h.sum(), leaf)[0].numpy(),
            torch.autograd.grad(mamba1_scan_ref(leaf, dt, a, b, c)[1].sum(), leaf)[0].numpy(),
            F32_TOL)
    assert calls == {"mamba1_scan": 3, "mamba1_scan_bwd": 2}


def _reduced_falcon(**changes) -> ArchConfig:
    jcfg = dataclasses.replace(j_reduced(j_get_config("falcon-mamba-7b")), **changes)
    return ArchConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_kernel_route_grads_and_launches(remat, monkeypatch):
    """Reduced falcon-mamba-7b's loss gradients through ``KernelScan`` (the
    plain kernels) equal autograd through the chunked scan within 1e-5 of
    each leaf's scale; the forward kernel runs once a layer, twice under
    remat (the recompute), and the backward kernel once a layer."""
    cfg = _reduced_falcon(remat=remat)
    rng = np.random.default_rng(8)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens.long()}
    grads = {}
    for impl in ("chunked", "kernel"):
        calls = plain_scan_kernels(monkeypatch)
        api = build_model(cfg, impl=impl, device="cpu")
        model = api.init(0).requires_grad_(True)
        loss, _ = api.loss(model, batch)
        grads[impl] = torch.autograd.grad(loss, list(model.parameters()))
    assert calls == {"mamba1_scan": cfg.n_layers * (2 if remat else 1),
                     "mamba1_scan_bwd": cfg.n_layers}
    for g, w in zip(grads["kernel"], grads["chunked"]):
        _within(g.numpy(), w.numpy(), F32_TOL)


def test_bwd_kernel_source_and_library():
    """The backward kernel is the second source of the scan's library (built
    with it, keyed by both sources), uses the forward's exponential
    (ex2.approx.ftz, never expf) and reduces across blocks in a fixed order
    (a second kernel, no atomics); its wrapper is bound without building."""
    from repro_torch.kernels import _build
    fwd, bwd = skernel.SOURCES
    assert fwd.name == "mamba1_scan.cu" and bwd.name == "mamba1_scan_bwd.cu"
    text = bwd.read_text()
    for needle in ("int mamba1_scan_bwd_launch(", "long long mamba1_scan_bwd_workspace_floats(",
                   "ex2.approx.ftz.f32", "__shfl_xor_sync", "mamba1_scan_bwd_reduce_kernel",
                   "long long c_sb, long long c_ss"):
        assert needle in text, needle
    assert "expf(" not in text and "atomicAdd" not in text
    assert skernel.library_path() == _build.library_path("mamba1_scan", skernel.SOURCES,
                                                         skernel.EXTRA_FLAGS)
    assert skernel.launches.keys() == {"mamba1_scan", "mamba1_scan_bwd"}
