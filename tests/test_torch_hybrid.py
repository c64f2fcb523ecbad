"""The port's Mamba-2 scan (``kernels/mamba_scan/{ref,ops}.py``) and the
hybrid family (``models/hybrid.py``, zamba2 with Mamba-2 blocks from
``models/ssm.py``) against the JAX package's, at reduced sizes with bridged
weights: the scans within 2e-4 of scale at an S that is not a multiple of
the chunk, with and without an initial state; forward logits and six
teacher-forced decode steps within 1e-4 of scale; decode against forward;
the loss and its gradient; ``serve.main``."""
from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import ops as jops  # noqa: E402
from repro.kernels.mamba_scan import ref as jref  # noqa: E402
from repro_torch.kernels.mamba_scan import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_models import (B, S, _tokens, _within_scale, bridge_arch,  # noqa: E402
                               decode_reproduces_forward, loss_and_grad_against_jax,
                               teacher_forced_against_jax)

SCAN_TOL = 2e-4


def _scan_inputs(seed: int, b: int = 2, s: int = 13, h: int = 3, p: int = 8, n: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.fixture(scope="module")
def bridged():
    return bridge_arch("zamba2-2.7b")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("path", ["ref", "chunked"])
def test_mamba2_scan_matches_jax(path, with_h0):
    """S = 13 with a chunk of 4 (the chunked form halves it to 1, as the JAX
    package's ``_pick_chunk`` does) and S = 24 with a chunk of 16 (halved
    to 8: three chunks)."""
    for s, chunk in ((13, 4), (24, 16)):
        x, dt, a, bm, cm, h0 = _scan_inputs(seed=s, s=s)
        h0 = h0 if with_h0 else None
        args = (x, dt, a, bm, cm)
        if path == "ref":
            want = jref.mamba2_scan_ref(*map(jnp.asarray, args),
                                        None if h0 is None else jnp.asarray(h0))
            got = ref.mamba2_scan_ref(*map(torch.as_tensor, args),
                                      None if h0 is None else torch.as_tensor(h0))
        else:
            want = jops.mamba2_scan_chunked(*map(jnp.asarray, args),
                                            None if h0 is None else jnp.asarray(h0), chunk)
            got = ops.mamba2_scan_chunked(*map(torch.as_tensor, args),
                                          None if h0 is None else torch.as_tensor(h0), chunk)
        _within_scale(got[0], want[0], SCAN_TOL)
        _within_scale(got[1], want[1], SCAN_TOL)
        assert got[1].dtype == torch.float32


def test_mamba2_scan_routes():
    """``auto`` is the chunked form on every device (no kernel); the
    chunked form equals the sequential one; a kernel route is refused."""
    x, dt, a, bm, cm, h0 = map(torch.as_tensor, _scan_inputs(seed=3, s=16))
    y_auto, h_auto = ops.mamba2_scan(x, dt, a, bm, cm, h0, chunk=8)
    y_ch, h_ch = ops.mamba2_scan_chunked(x, dt, a, bm, cm, h0, 8)
    assert torch.equal(y_auto, y_ch) and torch.equal(h_auto, h_ch)
    y_ref, h_ref = ops.mamba2_scan(x, dt, a, bm, cm, h0, impl="ref")
    _within_scale(y_ch, y_ref, SCAN_TOL)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mamba2_scan(x, dt, a, bm, cm, h0, impl="kernel")


def test_mamba2_chunked_gradient_is_finite():
    """The decay kernel's masked exponent never reaches the gradient as inf
    (a long chunk's upper triangle overflows exp)."""
    x, dt, a, bm, cm, _ = map(torch.as_tensor, _scan_inputs(seed=4, s=64))
    dt = (dt * 40).requires_grad_()  # exp(cum_i - cum_j) overflows above the diagonal
    y, h = ops.mamba2_scan_chunked(x, dt, a, bm, cm, None, 64)
    (g,) = torch.autograd.grad(y.square().sum() + h.sum(), dt)
    assert bool(torch.isfinite(g).all())


def test_forward_matches_jax(bridged):
    jcfg, jmodel, jparams, cfg, api, model = bridged
    tok = _tokens(cfg.vocab_size)
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)})
    got = api.forward(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, S, cfg.vocab_size)
    _within_scale(got, want, 1e-4)


def test_teacher_forced_decode_matches_jax(bridged):
    teacher_forced_against_jax(bridged, 6, 1e-4)


def test_decode_reproduces_forward(bridged):
    *_, cfg, api, model = bridged
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=6))
    cache = api.init_cache(B, 8)
    assert cache["attn_k"].shape[0] == cfg.n_layers // cfg.hybrid_attn_every
    assert cache["h"].shape == (cfg.n_layers, B, cfg.d_inner // cfg.ssm_head_dim,
                                cfg.ssm_state, cfg.ssm_head_dim)
    decode_reproduces_forward(api, model, tok, cache, api.forward(model, {"tokens": tok}))


def test_loss_and_grad_match_jax(bridged):
    cfg = bridged[3]
    labels = np.where(np.arange(S) % 4 == 0, -1, _tokens(cfg.vocab_size, seed=7)).astype(np.int32)
    loss_and_grad_against_jax(bridged, {"tokens": _tokens(cfg.vocab_size, seed=6),
                                        "labels": labels})


def test_remat_recomputes_the_same_gradient(bridged):
    """Per-group recompute (remat on) gives the gradient of the plain
    recorded forward."""
    import dataclasses
    *_, cfg, api, model = bridged
    from repro_torch.models import build_model
    batch = {"tokens": torch.as_tensor(_tokens(cfg.vocab_size, seed=9)),
             "labels": torch.as_tensor(_tokens(cfg.vocab_size, seed=10))}
    grads = []
    for remat in (False, True):
        api_r = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        model.requires_grad_(True)
        try:
            loss, _ = api_r.loss(model, batch)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
        finally:
            model.requires_grad_(False)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_serve_main_prints_its_summary():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = serve.main(["--arch", "zamba2-2.7b", "--reduced", "--batch", "2",
                              "--prompt-len", "4", "--gen", "5", "--device", "cpu"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == summary
    assert summary["arch"] == "zamba2-2.7b" and len(summary["sample_tokens"]) == 5
