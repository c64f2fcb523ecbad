"""The port's LM serving path (``repro_torch.configs``, ``models``,
``launch``, ``bridge.lm_params_from_numpy``) against the JAX package, for
the dense and Mamba-1 families; the other families have their own files
(``test_torch_moe.py``, ``test_torch_hybrid.py``,
``test_torch_encdec_vlm.py``), which take their helpers from here.

Reduced configs (float32 compute) get the weights of ``repro``'s
``model.init(PRNGKey(0))``, bridged name for name. The port's forward
logits and six teacher-forced decode steps (ten where an 8-slot ring buffer
wraps) must be within 1e-4 of the JAX logits' scale; its own decode must
reproduce its forward at 2e-3, as ``tests/test_models_smoke.py`` holds the
JAX package. The bf16 compute type is held against the JAX package at 2e-2
of scale where the stream promotes to float32 (gemma2's and paligemma's
embedding scale)."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ALL_ARCHS = ["qwen2.5-32b", "minitron-4b", "granite-20b", "gemma2-27b", "mixtral-8x22b",
             "mixtral-8x7b", "zamba2-2.7b", "whisper-base", "falcon-mamba-7b", "paligemma-3b"]
DENSE = ["minitron-4b", "qwen2.5-32b", "granite-20b", "gemma2-27b"]
PORTED = ["minitron-4b", "falcon-mamba-7b"]
B, S = 2, 8


def bridge_arch(arch: str, **overrides):
    """(JAX cfg, JAX model, JAX params, port cfg, port api, port model) of
    the reduced ``arch`` (fields replaced by ``overrides`` on both sides),
    the port holding the JAX weights."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **overrides)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config(arch)), **overrides)
    api = build_model(cfg, device="cpu")
    model = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, api, model


@pytest.fixture(scope="module")
def bridged():
    """arch -> ``bridge_arch(arch)``."""
    return {arch: bridge_arch(arch) for arch in PORTED + DENSE[1:]}


def _tokens(vocab: int, seed: int = 1, s: int = S, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _f64(a) -> np.ndarray:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return a.astype(np.float64)


def _within_scale(got, want, rel: float) -> float:
    """Asserts max |got - want| <= rel x max |want|; returns that error over
    the scale."""
    got, want = _f64(got), _f64(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())
    return float(err / np.abs(want).max())


def teacher_forced_against_jax(bridged_arch, steps: int, rel: float, batch: dict = None,
                               prefill=None, b: int = B) -> float:
    """``steps`` decode steps on both sides, each from the same token (a
    JAX jitted step against the port's), every step's logits within
    ``rel`` of scale; ``prefill(jcache, cache)`` -> (jcache, cache) fills
    both caches first (whisper's cross-attention). Returns the worst error
    over the scale."""
    jcfg, jmodel, jparams, cfg, api, model = bridged_arch
    tok = _tokens(cfg.vocab_size, seed=2, s=steps, b=b)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(b, steps + 2), api.init_cache(b, steps + 2)
    if prefill is not None:
        jcache, cache = prefill(jcache, cache)
    worst = 0.0
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, jax.numpy.asarray(tok[:, t:t + 1]))
        got, cache = api.decode_step(model, cache, torch.as_tensor(tok[:, t:t + 1]))
        assert got.shape == (b, 1, cfg.vocab_size)
        worst = max(worst, _within_scale(got, want, rel))
    assert cache["pos"] == steps
    return worst


def decode_reproduces_forward(api, model, tokens: torch.Tensor, cache,
                              full: torch.Tensor) -> None:
    """Teacher-forced decode from ``cache`` against the forward logits
    ``full`` at 2e-3, as the JAX package's smoke tests hold it."""
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


def loss_and_grad_against_jax(bridged_arch, batch_np: dict) -> None:
    """``ModelApi.loss`` against JAX's ``model.loss`` at 1e-5, and a finite,
    non-zero ``torch.autograd.grad`` of it for every parameter that the
    loss reaches."""
    jcfg, jmodel, jparams, cfg, api, model = bridged_arch
    want, jaux = jmodel.loss(jparams, {k: jax.numpy.asarray(v) for k, v in batch_np.items()})
    model.requires_grad_(True)
    try:
        loss, aux = api.loss(model, {k: torch.as_tensor(v) for k, v in batch_np.items()})
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(aux["tokens"]) == float(jaux["tokens"])
    total = 0.0
    for name, g in zip(named, grads):
        assert g is not None, name
        assert bool(torch.isfinite(g).all()), name
        total += float(g.abs().sum())
    assert total > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(j_reduced(j_get_config(arch)))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert (cfg.n_params(), cfg.n_active_params()) == (jcfg.n_params(), jcfg.n_active_params())
    assert (cfg.padded_heads, cfg.resolved_head_dim, cfg.d_inner, cfg.resolved_dt_rank) == \
        (jcfg.padded_heads, jcfg.resolved_head_dim, jcfg.d_inner, jcfg.resolved_dt_rank)


def test_every_jax_arch_is_registered():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import all_configs as j_all_configs
    from repro_torch.configs import ARCH_IDS, all_configs
    assert ARCH_IDS == J_ARCH_IDS
    assert sorted(all_configs()) == sorted(j_all_configs()) == sorted(ALL_ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_built_model_holds_the_jax_parameter_tree(arch):
    """Every family builds on the CPU with the JAX tree's names and shapes,
    and its drawn weights are finite."""
    cfg = reduced(get_config(arch))
    jparams = jax.eval_shape(j_build_model(j_reduced(j_get_config(arch))).init,
                             jax.random.PRNGKey(0))
    flat = {name: tuple(leaf.shape) for name, leaf in bridge._flat_names(jparams).items()}
    model = build_model(cfg, device="cpu").init(0)
    ours = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert ours == flat
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.parametrize("arch", PORTED + DENSE[1:])
def test_forward_matches_jax(bridged, arch):
    jcfg, jmodel, jparams, cfg, api, model = bridged[arch]
    tok = _tokens(cfg.vocab_size)
    want = jmodel.forward(jparams, {"tokens": jax.numpy.asarray(tok)})
    got = make_prefill_step(api)(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(got).all())
    _within_scale(got, want, 1e-4)


@pytest.mark.parametrize("arch", PORTED + DENSE[1:])
def test_teacher_forced_decode_matches_jax(bridged, arch):
    """Six steps (ten for gemma2, whose 8-slot ring buffer then wraps), each
    from the same token on both sides."""
    steps = 10 if bridged[arch][3].sliding_window else 6
    teacher_forced_against_jax(bridged[arch], steps, 1e-4)


@pytest.mark.parametrize("arch", PORTED + DENSE[1:])
def test_decode_reproduces_forward(bridged, arch):
    *_, cfg, api, model = bridged[arch]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=6))
    decode_reproduces_forward(api, model, tok, api.init_cache(B, 8),
                              api.forward(model, {"tokens": tok}))


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma2-27b", "falcon-mamba-7b"])
def test_loss_and_grad_match_jax(bridged, arch):
    cfg = bridged[arch][3]
    tok = _tokens(cfg.vocab_size, seed=6)
    labels = np.where(np.arange(S) % 3 == 0, -1, _tokens(cfg.vocab_size, seed=7)).astype(np.int32)
    loss_and_grad_against_jax(bridged[arch], {"tokens": tok, "labels": labels,
                                              "weights": np.array([1.0, 3.0], np.float32)})


@pytest.mark.parametrize("arch", ["gemma2-27b", "paligemma-3b"])
def test_bf16_stream_promotes_as_jax(arch):
    """Gemma's embedding scale makes the stream float32 in the JAX package,
    so every product meets the bf16 weights in float32 and decode's float32
    q meets the bf16 cache in float32. Reduced configs in bf16 compute: the
    forward and 4 teacher-forced decode steps within 2e-2 of the JAX logits'
    scale (the parity ladder's bf16 limit). Before the repair the forward
    raised "expected m1 and m2 to have the same dtype"."""
    bridged_arch = bridge_arch(arch, compute_dtype="bfloat16")
    jcfg, jmodel, jparams, cfg, api, model = bridged_arch
    tok = _tokens(cfg.vocab_size, seed=1)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["patches"] = np.random.default_rng(8).standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    want = jmodel.forward(jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    got = api.forward(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _within_scale(got, want, 2e-2)
    teacher_forced_against_jax(bridged_arch, 4, 2e-2)


def test_serve_step_is_greedy(bridged):
    *_, cfg, api, model = bridged["minitron-4b"]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, s=1))
    logits, _ = api.decode_step(model, api.init_cache(B, 4), tok)
    nxt, cache = make_serve_step(api)(model, api.init_cache(B, 4), tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(dim=-1).to(torch.int32))
    assert cache["pos"] == 1


@pytest.mark.parametrize("arch", PORTED + DENSE[1:])
def test_serve_main_prints_its_summary(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
                              "--gen", "5", "--device", "cpu"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line == summary
    assert line["arch"] == arch and line["generated"] == 5 and line["tokens_per_s"] > 0
    assert len(line["sample_tokens"]) == 5 and line["device"] == "cpu"


def test_random_init_follows_the_jax_scales():
    """Weights drawn by the port have the JAX initialisers' spreads and
    zeroed padded-head rows of wo (different random numbers, same law)."""
    cfg = dataclasses.replace(reduced(get_config("minitron-4b")), n_heads=3,
                              head_pad_multiple=4)
    assert cfg.padded_heads == 4
    model = build_model(cfg, device="cpu").init(0)
    jparams = j_build_model(j_reduced(j_get_config("minitron-4b"))).init(jax.random.PRNGKey(0))
    assert torch.equal(model.blocks["wo"][:, 3:], torch.zeros_like(model.blocks["wo"][:, 3:]))
    for name in ("wq", "w_up", "w_down"):
        ours = float(model.blocks[name].std())
        theirs = float(np.asarray(jparams["blocks"][name]).std())
        assert abs(ours / theirs - 1) < 0.1, name
    assert abs(float(model.embed.std()) / 0.02 - 1) < 0.1
    m2 = build_model(reduced(get_config("falcon-mamba-7b")), device="cpu").init(0, torch.bfloat16)
    assert m2.blocks["in_proj"].dtype == torch.bfloat16
    assert torch.equal(m2.blocks["a_log"][0, 0].float(),
                       torch.log(torch.arange(1, 9, dtype=torch.float32)).bfloat16().float())


def test_bridge_checks_names_and_shapes(bridged):
    jparams = jax.tree.map(np.asarray, bridged["minitron-4b"][2])
    cfg = bridged["minitron-4b"][3]
    missing = {**jparams, "blocks": {k: v for k, v in jparams["blocks"].items() if k != "wq"}}
    with pytest.raises(KeyError, match="wq"):
        bridge.lm_params_from_numpy(cfg, missing, "cpu")
    wrong = {**jparams, "final_norm": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        bridge.lm_params_from_numpy(cfg, wrong, "cpu")


def test_unknown_archs_and_families_are_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")
    cfg = dataclasses.replace(reduced(get_config("minitron-4b")), family="diffusion")
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(cfg, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points default to it")
    cfg = reduced(get_config("minitron-4b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.configs\n"
        "import repro_torch.models, repro_torch.models.layers, repro_torch.models.ssm\n"
        "import repro_torch.models.transformer, repro_torch.launch.steps\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.mamba_scan.ops\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('minitron-4b', 'falcon-mamba-7b', 'mixtral-8x7b', 'zamba2-2.7b',\n"
        "             'whisper-base', 'paligemma-3b'):\n"
        "    serve.main(['--arch', arch, '--reduced', '--batch', '1', '--prompt-len', '2',\n"
        "                '--gen', '2', '--device', 'cpu'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, capture_output=True)
