"""The port's LM serving path (``repro_torch.configs``, ``models``,
``launch``, ``bridge.lm_params_from_numpy``) against the JAX package.

Reduced minitron-4b and falcon-mamba-7b (float32 compute) get the weights
of ``repro``'s ``model.init(PRNGKey(0))``, bridged name for name. The port's
forward logits and six teacher-forced decode steps must be within 1e-4 of
the JAX logits' scale; its own decode must reproduce its forward at 2e-3,
as ``tests/test_models_smoke.py`` holds the JAX package. Dense features that
minitron does not use (QKV bias, soft-caps, post-norms, embedding scaling,
alternating windowed layers with ring-buffer caches) are held on reduced
qwen2.5 and gemma2 configs built from the JAX package's."""
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
from repro_torch.configs import ArchConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

PORTED = ["minitron-4b", "falcon-mamba-7b"]
B, S = 2, 8


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def bridged():
    """arch -> (JAX cfg, JAX model, JAX params, port cfg, port api, port model)."""
    out = {}
    for arch in PORTED + ["qwen2.5-32b", "gemma2-27b"]:
        jcfg = j_reduced(j_get_config(arch))
        jmodel = j_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = reduced(get_config(arch)) if arch in PORTED else _port_cfg(jcfg)
        api = build_model(cfg, device="cpu")
        model = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
        out[arch] = (jcfg, jmodel, jparams, cfg, api, model)
    return out


def _tokens(vocab: int, seed: int = 1, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(np.int32)


def _within_scale(got, want, rel: float) -> None:
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("arch", PORTED)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(j_reduced(j_get_config(arch)))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert (cfg.padded_heads, cfg.resolved_head_dim, cfg.d_inner, cfg.resolved_dt_rank) == \
        (jcfg.padded_heads, jcfg.resolved_head_dim, jcfg.d_inner, jcfg.resolved_dt_rank)


@pytest.mark.parametrize("arch", PORTED + ["qwen2.5-32b", "gemma2-27b"])
def test_forward_matches_jax(bridged, arch):
    jcfg, jmodel, jparams, cfg, api, model = bridged[arch]
    tok = _tokens(cfg.vocab_size)
    want = jmodel.forward(jparams, {"tokens": jax.numpy.asarray(tok)})
    got = make_prefill_step(api)(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(got).all())
    _within_scale(got, want, 1e-4)


@pytest.mark.parametrize("arch", PORTED + ["gemma2-27b"])
def test_teacher_forced_decode_matches_jax(bridged, arch):
    """Six steps (ten for gemma2, whose 8-slot ring buffer then wraps), each
    from the same token on both sides."""
    jcfg, jmodel, jparams, cfg, api, model = bridged[arch]
    steps = 10 if cfg.sliding_window else 6
    tok = _tokens(cfg.vocab_size, seed=2, s=steps)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(B, steps + 2)
    cache = api.init_cache(B, steps + 2)
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, jax.numpy.asarray(tok[:, t:t + 1]))
        got, cache = api.decode_step(model, cache, torch.as_tensor(tok[:, t:t + 1]))
        assert got.shape == (B, 1, cfg.vocab_size)
        _within_scale(got, want, 1e-4)
    assert cache["pos"] == steps


@pytest.mark.parametrize("arch", PORTED)
def test_decode_reproduces_forward(bridged, arch):
    *_, cfg, api, model = bridged[arch]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, seed=3, s=6))
    full = api.forward(model, {"tokens": tok})
    cache = api.init_cache(B, 8)
    outs = []
    for t in range(6):
        logits, cache = api.decode_step(model, cache, tok[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


def test_serve_step_is_greedy(bridged):
    *_, cfg, api, model = bridged["minitron-4b"]
    tok = torch.as_tensor(_tokens(cfg.vocab_size, s=1))
    logits, _ = api.decode_step(model, api.init_cache(B, 4), tok)
    nxt, cache = make_serve_step(api)(model, api.init_cache(B, 4), tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(dim=-1).to(torch.int32))
    assert cache["pos"] == 1


@pytest.mark.parametrize("arch", PORTED)
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


def test_unported_archs_and_families_are_refused():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("qwen2.5-32b")
    for arch in ("mixtral-8x7b", "zamba2-2.7b", "whisper-base", "paligemma-3b"):
        cfg = _port_cfg(j_reduced(j_get_config(arch)))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
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
        "for arch in ('minitron-4b', 'falcon-mamba-7b'):\n"
        "    serve.main(['--arch', arch, '--reduced', '--batch', '1', '--prompt-len', '2',\n"
        "                '--gen', '2', '--device', 'cpu'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, capture_output=True)
