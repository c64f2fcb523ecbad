"""The port's encoder-decoder (``models/encdec.py``, whisper) and VLM
(``models/vlm.py``, paligemma) families against the JAX package's, at
reduced sizes with bridged weights: forward logits and six teacher-forced
decode steps within 1e-4 of scale (whisper's after ``prefill_cross`` on
both sides), decode against forward, the loss (the VLM's labels padded over
the image prefix) and its gradient, whisper in bf16 against the JAX
package's type promotion, and ``serve.main``."""
from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro.models.layers import sinusoidal_embedding as j_sinusoidal  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec, layers, transformer  # noqa: E402
from test_torch_models import (B, S, _tokens, _within_scale, bridge_arch,  # noqa: E402
                               decode_reproduces_forward, loss_and_grad_against_jax,
                               teacher_forced_against_jax)

ARCHS = ["whisper-base", "paligemma-3b"]


@pytest.fixture(scope="module")
def bridged():
    return {arch: bridge_arch(arch) for arch in ARCHS}


def _stub(cfg, seed: int = 8) -> dict:
    """The stub frontend's input of the family: frames or patches."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}


def _prefill(bridged_arch, frames):
    """Both caches' cross-attention keys and values from the same frames."""
    jcfg, _, jparams, cfg, _, model = bridged_arch

    def fill(jcache, cache):
        return (jencdec.prefill_cross(jcfg, jparams, jnp.asarray(frames), jcache),
                encdec.prefill_cross(cfg, model, torch.as_tensor(frames), cache))
    return fill


def test_sinusoidal_embedding_is_the_jax_packages():
    np.testing.assert_array_equal(layers.sinusoidal_embedding(1500, 512),
                                  j_sinusoidal(1500, 512))


def test_layer_norm_matches_jax():
    from repro.models.layers import layer_norm as j_layer_norm
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 16), (16,), (16,)))
    want = j_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = layers.layer_norm(*map(torch.as_tensor, (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(bridged, arch):
    jcfg, jmodel, jparams, cfg, api, model = bridged[arch]
    batch = {"tokens": _tokens(cfg.vocab_size), **_stub(cfg)}
    want = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = api.forward(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.shape == (B, S + cfg.n_img_tokens, cfg.vocab_size)
    _within_scale(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(bridged, arch):
    cfg = bridged[arch][3]
    fill = _prefill(bridged[arch], _stub(cfg)["frames"]) if cfg.family == "encdec" else None
    teacher_forced_against_jax(bridged[arch], 6, 1e-4, prefill=fill)


def test_whisper_decode_reproduces_forward(bridged):
    *_, cfg, api, model = bridged["whisper-base"]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=6))
    frames = torch.as_tensor(_stub(cfg)["frames"])
    cache = encdec.prefill_cross(cfg, model, frames, api.init_cache(B, 8))
    decode_reproduces_forward(api, model, tok, cache,
                              api.forward(model, {"tokens": tok, "frames": frames}))


def test_vlm_decode_reproduces_its_backbone(bridged):
    """The VLM's decode is plain causal over its cache (the JAX package's):
    it reproduces the text backbone's forward without an image prefix."""
    *_, cfg, api, model = bridged["paligemma-3b"]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=6))
    decode_reproduces_forward(api, model, tok, api.init_cache(B, 8),
                              transformer.forward(cfg, model, tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax(bridged, arch):
    cfg = bridged[arch][3]
    labels = np.where(np.arange(S) % 4 == 0, -1, _tokens(cfg.vocab_size, seed=7)).astype(np.int32)
    loss_and_grad_against_jax(bridged[arch], {"tokens": _tokens(cfg.vocab_size, seed=6),
                                              "labels": labels, **_stub(cfg)})


def test_whisper_bf16_promotes_as_jax():
    """In bf16 compute the JAX package runs the encoder in float32 (its
    position table is float32) and keeps the decoder in bf16: the forward's
    cross-attention meets float32 keys with a bf16 query (attention
    promotes and returns bf16), decode reads the bf16 cache. Forward and 4
    teacher-forced decode steps within 2e-2 of scale."""
    bridged_arch = bridge_arch("whisper-base", compute_dtype="bfloat16")
    jcfg, jmodel, jparams, cfg, api, model = bridged_arch
    batch = {"tokens": _tokens(cfg.vocab_size), **_stub(cfg)}
    want = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = api.forward(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert encdec.encode(cfg, model, torch.as_tensor(batch["frames"])).dtype == torch.float32
    _within_scale(got, want, 2e-2)
    teacher_forced_against_jax(bridged_arch, 4, 2e-2,
                               prefill=_prefill(bridged_arch, batch["frames"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_prints_its_summary(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
                              "--gen", "5", "--device", "cpu"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == summary
    assert summary["arch"] == arch and len(summary["sample_tokens"]) == 5
