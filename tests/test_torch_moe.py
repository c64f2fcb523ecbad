"""The port's MoE family (``repro_torch.models.moe``, mixtral through
``transformer``) against the JAX package's, at reduced sizes with bridged
weights: the capacity-bounded ``moe_ffn`` on inputs whose router sends most
tokens to one expert (so that capacity drops assignments), the chosen
experts and dropped assignments, forward logits and ten teacher-forced
decode steps (the 8-slot sliding-window ring wraps) within 1e-4 of scale,
decode against forward, the loss and its gradient, and ``serve.main``."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_models import (B, S, _tokens, _within_scale, bridge_arch,  # noqa: E402
                               decode_reproduces_forward, loss_and_grad_against_jax,
                               teacher_forced_against_jax)

MOE = ["mixtral-8x7b", "mixtral-8x22b"]


@pytest.fixture(scope="module")
def bridged():
    return {arch: bridge_arch(arch) for arch in MOE}


def _skewed(seed: int = 0, b: int = 4, s: int = 8):
    """(JAX cfg, port cfg, x (B, S, D), params) of reduced mixtral whose
    router favours expert 0 for most tokens: 2 B S = 64 assignments over
    capacity 24, so expert 0 drops some."""
    jcfg = j_reduced(j_get_config("mixtral-8x7b"))
    cfg = reduced(get_config("mixtral-8x7b"))
    rng = np.random.default_rng(seed)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32) * 0.1
    router[:, 0] += 0.5 * np.sign(x.reshape(-1, d).mean(0))  # most tokens lean to expert 0
    p = {"router": router,
         "we_gate": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
         "we_up": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
         "we_down": rng.standard_normal((e, ff, d)).astype(np.float32) / np.sqrt(ff)}
    return jcfg, cfg, x, p


def _jax_routing(jcfg, x, router):
    """The JAX function's routing, step for step as ``repro.models.moe``
    computes it (G = 1): expert ids (T, k) and kept (T, k)."""
    t, k, e = x.shape[0] * x.shape[1], jcfg.n_experts_per_tok, jcfg.n_experts
    xf = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xf @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx.reshape(t * k), e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < jmoe.capacity(jcfg, t)).reshape(t, k)


def test_capacity_matches_jax():
    jcfg, cfg = j_reduced(j_get_config("mixtral-8x7b")), reduced(get_config("mixtral-8x7b"))
    for full in (False, True):
        a, b = (j_get_config("mixtral-8x7b"), get_config("mixtral-8x7b")) if full else (jcfg, cfg)
        for t in (1, 4, 12, 16, 64, 100, 8192):
            assert moe.capacity(b, t) == jmoe.capacity(a, t)


def test_moe_ffn_drops_as_jax():
    """Same experts chosen, the same assignments dropped (zero output), and
    the outputs within 1e-5 of scale."""
    jcfg, cfg, x, p = _skewed()
    want = jmoe.moe_ffn(jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    with moe.recording_routing() as log:
        got = moe.moe_ffn(cfg, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()})
    (idx, kept), = log
    jidx, jkept = _jax_routing(jcfg, x, p["router"])
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(kept.numpy(), jkept)
    assert 0 < (~jkept).sum() < jkept.size  # capacity dropped some, not all
    _within_scale(got, want, 1e-5)
    # a token with both assignments dropped gets exactly zero
    both = ~jkept.any(axis=1)
    flat = got.reshape(-1, cfg.d_model)
    assert torch.equal(flat[torch.as_tensor(both)], torch.zeros_like(flat[torch.as_tensor(both)]))


def test_router_aux_loss_matches_jax():
    jcfg, cfg, x, p = _skewed(seed=1)
    want = jmoe.router_aux_loss(jcfg, jnp.asarray(x), {"router": jnp.asarray(p["router"])})
    got = moe.router_aux_loss(cfg, torch.as_tensor(x), {"router": torch.as_tensor(p["router"])})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(bridged, arch):
    jcfg, jmodel, jparams, cfg, api, model = bridged[arch]
    tok = _tokens(cfg.vocab_size)
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)})
    got = api.forward(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, S, cfg.vocab_size)
    _within_scale(got, want, 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_teacher_forced_decode_matches_jax(bridged, arch):
    teacher_forced_against_jax(bridged[arch], 10, 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_decode_reproduces_forward(bridged, arch):
    """At B x S = 8 tokens no expert can hold more than 8 assignments, so the
    forward drops none (checked), and it computes the function decode does."""
    *_, cfg, api, model = bridged[arch]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=4))
    with moe.recording_routing() as log:
        full = api.forward(model, {"tokens": tok})
    assert all(bool(kept.all()) for _, kept in log) and len(log) == cfg.n_layers
    decode_reproduces_forward(api, model, tok, api.init_cache(B, 8), full)


@pytest.mark.parametrize("arch", MOE[:1])
def test_loss_and_grad_match_jax(bridged, arch):
    cfg = bridged[arch][3]
    labels = np.where(np.arange(S) % 4 == 0, -1, _tokens(cfg.vocab_size, seed=7)).astype(np.int32)
    loss_and_grad_against_jax(bridged[arch], {"tokens": _tokens(cfg.vocab_size, seed=6),
                                              "labels": labels})


def test_moe_params_bridge_and_draw_like_jax(bridged):
    """The JAX tree's ``blocks.router`` / ``we_*`` leaves land under the same
    names; drawn weights follow the JAX scales (fan-in after the expert
    axis)."""
    jparams = bridged["mixtral-8x7b"][2]
    model = bridged["mixtral-8x7b"][5]
    assert torch.equal(model.blocks["we_down"], torch.as_tensor(np.array(
        jparams["blocks"]["we_down"])))
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")), d_model=128, d_ff=256)
    from repro_torch.models import build_model
    drawn = build_model(cfg, device="cpu").init(0)
    for name, fan_in, scale in (("router", 128, 1.0), ("we_gate", 128, 1.0),
                                ("we_down", 256, 1 / np.sqrt(2 * cfg.n_layers) * np.sqrt(256))):
        want = scale / np.sqrt(fan_in)
        assert abs(float(drawn.blocks[name].std()) / want - 1) < 0.05, name


@pytest.mark.parametrize("arch", MOE)
def test_serve_main_prints_its_summary(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
                              "--gen", "5", "--device", "cpu"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == summary
    assert summary["arch"] == arch and len(summary["sample_tokens"]) == 5


def test_serve_decode_example_runs_reduced_mixtral():
    from repro_torch.examples import serve_decode
    with contextlib.redirect_stdout(io.StringIO()):
        summary = serve_decode.main(["--batch", "2", "--gen", "3", "--device", "cpu"])
    assert summary["arch"] == "mixtral-8x7b" and summary["generated"] == 3


def test_serve_main_keeps_the_first_layers():
    with contextlib.redirect_stdout(io.StringIO()):
        summary = serve.main(["--arch", "mixtral-8x7b", "--reduced", "--layers", "1", "--batch",
                              "1", "--prompt-len", "2", "--gen", "2", "--device", "cpu"])
    assert reduced(get_config("mixtral-8x7b")).n_layers > 1
    assert summary["n_layers"] == 1 and summary["decode_s"] > 0
