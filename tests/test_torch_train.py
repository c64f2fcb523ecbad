"""The port's LM training path (``models.layers.weighted_cross_entropy``,
``ModelApi.loss``, the attention's gradient, ``launch.steps.make_train_step``,
``launch.train.main``, ``bridge.adamw_state_from_numpy``) against the JAX
package, at reduced sizes on the CPU.

Tolerances:
  * the loss: 1e-6 of scale for the bare function, 1e-5 relative for a step;
  * attention gradients: 2e-5 of scale (float32) against ``jax.grad`` of the
    Pallas kernel in interpret mode, whose ``custom_vjp`` recomputes through
    ``attention_chunked``, as the port's differentiates its own;
  * one train step with bridged weights: gradients and the AdamW moments
    within 1e-4 of each leaf's scale in float32 (other summation orders),
    2e-2 with bf16 compute and remat (the full config's settings at reduced
    width: bf16 rounds at other places, and the port accumulates the
    embedding's gradient in float32 where JAX scatters in bf16); reduced
    falcon-mamba-7b also through the scan's kernel route (``KernelScan``,
    its kernels replaced by their plain versions). The second
    moment v is quadratic in the gradient, so it is held on the scale of
    its root, sqrt(v) = |g| sqrt(1 - b2) after one step. Updated
    parameters: AdamW's first step moves an element by about lr whatever
    |g| is, so parameters are compared (same tolerances) where |g| is above
    the gradient's tolerance, and a sign flip of an update is allowed only
    below it (counted, at most 2 % of a leaf).
Within the port: remat on and off give equal gradients, ``train.main``
lowers the loss, and a resumed run ends bit-equal to an uninterrupted one.
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
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import AttnSpec as JSpec  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.layers import cast_tree  # noqa: E402
from repro.models.layers import weighted_cross_entropy as j_wce  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ArchConfig  # noqa: E402
from repro_torch.examples import train_lm_cocktail  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import AttnSpec  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import weighted_cross_entropy  # noqa: E402
from repro_torch.optim import AdamWConfig, AdamWState  # noqa: E402


def _scale_err(got, want) -> tuple[float, float]:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float(max(np.abs(want).max(), 1e-30))


def _within(got, want, tol, what=""):
    err, scale = _scale_err(got, want)
    assert err <= tol * scale, (what, err, scale)


# --------------------------------------------------------------------------
# The loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_weighted_cross_entropy_matches_jax(weighted, softcap):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 6, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    labels[:, -1] = -1
    labels[2, 1] = -1
    weights = np.array([1.5, 0.0, 0.3, 2.0], np.float32) if weighted else None
    loss, denom = weighted_cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(labels),
        None if weights is None else torch.as_tensor(weights), logit_softcap=softcap)
    jloss, jdenom = j_wce(jnp.asarray(logits), jnp.asarray(labels),
                          None if weights is None else jnp.asarray(weights),
                          logit_softcap=softcap)
    _within(loss, jloss, 1e-6)
    _within(denom, jdenom, 1e-6)


def test_weighted_cross_entropy_all_masked_is_zero():
    loss, denom = weighted_cross_entropy(torch.ones((2, 3, 5)), torch.full((2, 3), -1),
                                         torch.ones(2))
    assert float(loss) == 0.0 and float(denom) == 0.0


# --------------------------------------------------------------------------
# The attention's gradient
# --------------------------------------------------------------------------

# (B, S, H, Hkv, hd, spec): GQA, causal, a window, no mask.
GRAD_CASES = [
    (2, 64, 4, 2, 16, AttnSpec(causal=True)),
    (1, 128, 4, 1, 32, AttnSpec(causal=True, window=32)),
    (2, 64, 2, 2, 16, AttnSpec(causal=False)),
]


def _attn_inputs(case, seed=0):
    b, s, h, hkv, hd, _ = case
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=sh).astype(np.float32)
                  for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, g, pos


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_attention_grads_match_jax_custom_vjp(case):
    spec = case[-1]
    q, k, v, g, pos = _attn_inputs(case)
    jspec = JSpec(causal=spec.causal, window=spec.window)

    def jloss(q_, k_, v_):
        out = flash_attention_pallas(q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), jspec,
                                     interpret=True, block_q=64, block_kv=64)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    tpos = torch.as_tensor(pos)
    out = fops.flash_attention(tq, tk, tv, tpos, tpos, spec)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    for name, a, b in zip("qkv", got, want):
        _within(a, b, 2e-5, f"d{name}")


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_kernel_function_backward_is_the_chunked_recompute(case, monkeypatch):
    """The kernel route's ``autograd.Function`` with the kernel replaced by
    its plain version (the CUDA kernel needs a card): the forward launches
    the kernel once, and dq, dk, dv are bit-equal to autograd through
    ``attention_chunked``."""
    spec = case[-1]
    q, k, v, g, pos = _attn_inputs(case, seed=1)
    calls = []

    def fake_kernel(q_, k_, v_, q_pos, kv_pos, spec_, kv_valid=None, scale=None):
        calls.append(q_.shape)
        return fops.attention_chunked(q_, k_, v_, q_pos, kv_pos, spec_, kv_valid, scale)

    monkeypatch.setattr(fkernel, "flash_attention_cuda", fake_kernel)
    tpos = torch.as_tensor(pos)
    grads = []
    for impl in ("kernel", "chunked"):
        tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
        out = fops.flash_attention(tq, tk, tv, tpos, tpos, spec, impl=impl)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g)))
    assert len(calls) == 1
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():  # not recorded: the kernel alone
        fops.flash_attention(tq, tk, tv, tpos, tpos, spec, impl="kernel")
    assert len(calls) == 2


# --------------------------------------------------------------------------
# One train step against the JAX package's
# --------------------------------------------------------------------------

# name -> (arch, config changes, tolerance, the models' impl). The "kernel"
# case runs the scan's kernel route under autograd (``ops.KernelScan``) with
# its two kernels replaced by their plain versions
# (``test_torch_mamba_scan_bwd.plain_scan_kernels``): the CPU cannot run them.
STEP_CASES = {
    "minitron-4b": ("minitron-4b", {}, 1e-4, "auto"),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}, 1e-4, "auto"),
    "falcon-mamba-7b-kernel-scan": ("falcon-mamba-7b", {}, 1e-4, "kernel"),
    "minitron-4b-bf16-remat": ("minitron-4b", {"compute_dtype": "bfloat16", "remat": True},
                               2e-2, "auto"),
}
B, S = 4, 8


def _batch(vocab: int, seed: int = 7) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, 3] = -1
    return {"tokens": tokens, "labels": labels,
            "weights": np.array([1.3, 0.0, 0.7, 2.0], np.float32)}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def stepped(request):
    """One step of both packages from the same weights and batch: the JAX
    step (outside a mesh) and its gradients, the port's gradients and its
    step from bridged weights and a bridged AdamW state."""
    arch, changes, tol, impl = STEP_CASES[request.param]
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **changes)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cdt = jnp.dtype(jcfg.compute_dtype)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(cast_tree(p, cdt), jbatch)[0])(jparams)
    jopt = j_adamw_init(jparams)
    jnew, jnew_opt, jmet = jax.jit(j_make_train_step(jmodel, JAdamWConfig(), total_steps=10))(
        jparams, jopt, jbatch)

    api = build_model(cfg, impl=impl, device="cpu")
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model = bridge.lm_params_from_numpy(cfg, host(jparams), "cpu")
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    with pytest.MonkeyPatch.context() as m:
        if impl == "kernel":
            from test_torch_mamba_scan_bwd import plain_scan_kernels
            plain_scan_kernels(m)
        loss, aux = api.loss(model, tbatch)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        opt = bridge.adamw_state_from_numpy(model, host(jopt), "cpu")
        model, new_opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(
            model, opt, tbatch)
    flat = bridge._flat_names
    return dict(
        tol=tol, loss=float(loss.detach()), jloss=float(jloss), met=met, jmet=jmet, aux=aux,
        grads={k: g.numpy() for k, g in grads.items()}, jgrads=flat(host(jgrads)),
        p0=flat(host(jparams)), params={k: p.detach().numpy() for k, p in named.items()},
        jparams=flat(host(jnew)), opt=new_opt, jm=flat(host(jnew_opt.m)),
        jv=flat(host(jnew_opt.v)), jstep=int(jnew_opt.step))


def test_train_step_loss_matches_jax(stepped):
    tol = 1e-5 if stepped["tol"] <= 1e-4 else stepped["tol"]  # relative
    met, jmet = stepped["met"], stepped["jmet"]
    for got, want in ((stepped["loss"], stepped["jloss"]), (met["loss"], jmet["loss"])):
        assert abs(float(got) - float(want)) <= tol * abs(float(want))
    assert float(met["tokens"]) == float(jmet["tokens"])
    _within(met["grad_norm"], jmet["grad_norm"], stepped["tol"])


def test_train_step_grads_and_moments_match_jax(stepped):
    tol = stepped["tol"]
    assert int(stepped["opt"].step) == stepped["jstep"] == 1
    assert set(stepped["grads"]) == set(stepped["jgrads"])
    for k, g in stepped["grads"].items():
        _within(g, stepped["jgrads"][k], tol, f"grad {k}")
        _within(stepped["opt"].m[k], stepped["jm"][k], tol, f"m {k}")
        _within(np.sqrt(stepped["opt"].v[k].numpy()), np.sqrt(stepped["jv"][k]), tol, f"v {k}")


def test_train_step_params_match_jax(stepped):
    tol = stepped["tol"]
    for k, p in stepped["params"].items():
        g = np.abs(stepped["jgrads"][k])
        above = g > tol * g.max()
        want = stepped["jparams"][k]
        err = np.abs(p.astype(np.float64) - want)[above]
        assert err.size == 0 or err.max() <= tol * np.abs(want).max(), k
        flips = np.sign(p - stepped["p0"][k]) != np.sign(want - stepped["p0"][k])
        assert not (flips & above).any(), k
        assert flips.sum() <= 0.02 * flips.size, (k, int(flips.sum()))


# --------------------------------------------------------------------------
# Within the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minitron-4b", "falcon-mamba-7b"])
def test_remat_gives_equal_grads(arch):
    batch = {k: torch.as_tensor(v) for k, v in _batch(128, seed=3).items()}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(j_reduced(j_get_config(arch)), remat=remat)
        cfg = ArchConfig(**dataclasses.asdict(cfg))
        api = build_model(cfg, device="cpu")
        model = api.init(0).requires_grad_(True)
        loss, _ = api.loss(model, batch)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_prefill_records_no_graph():
    cfg = ArchConfig(**dataclasses.asdict(j_reduced(j_get_config("minitron-4b"))))
    api = build_model(cfg, device="cpu")
    model = api.init(0).requires_grad_(True)
    logits = make_prefill_step(api)(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert not logits.requires_grad
    assert api.forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}).requires_grad


def test_adamw_state_bridge_roundtrip():
    cfg = ArchConfig(**dataclasses.asdict(j_reduced(j_get_config("falcon-mamba-7b"))))
    model = build_model(cfg, device="cpu").init(1)
    rng = np.random.default_rng(2)
    tree = {"step": np.int32(3),
            "m": {"embed": rng.normal(size=model.embed.shape).astype(np.float32)}}
    with pytest.raises(KeyError, match="names differ"):
        bridge.adamw_state_from_numpy(model, {**tree, "v": tree["m"]}, "cpu")
    full = {name: rng.normal(size=p.shape).astype(np.float32)
            for name, p in model.named_parameters()}
    nested = bridge.adamw_state_to_numpy(AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        m={k: torch.as_tensor(v) for k, v in full.items()},
        v={k: torch.as_tensor(-v) for k, v in full.items()}))
    assert set(nested["m"]) == {name.split(".")[0] for name in full}
    assert set(nested["m"]["blocks"]) == set(model.blocks)
    state = bridge.adamw_state_from_numpy(model, nested, "cpu")
    assert int(state.step) == 3
    for name, value in full.items():
        np.testing.assert_array_equal(state.m[name].numpy(), value)
        np.testing.assert_array_equal(state.v[name].numpy(), -value)


COMMON = ["--arch", "minitron-4b", "--reduced", "--device", "cpu", "--batch", "4",
          "--seq", "16", "--n-cu", "6", "--log-every", "100"]


def test_train_main_lowers_the_loss():
    summary = train.main(COMMON + ["--steps", "40", "--batch", "8", "--seq", "32",
                                   "--slot-every", "8", "--lr", "1e-2"])
    assert summary["device"] == "cpu" and len(summary["losses"]) == 40
    assert all(np.isfinite(summary["losses"]))
    assert summary["min_loss"] < summary["first_loss"] - 0.2
    assert summary["sched_trained"] > 0


class Crash(Exception):
    pass


def crash_after(monkeypatch, n_steps: int) -> None:
    """Make ``train.main``'s train step raise on its call after ``n_steps``:
    a run killed between two steps."""
    make = train.make_train_step

    def crashing(*args, **kwargs):
        step, calls = make(*args, **kwargs), []

        def run(*a):
            if len(calls) == n_steps:
                raise Crash
            calls.append(1)
            return step(*a)
        return run

    monkeypatch.setattr(train, "make_train_step", crashing)


@pytest.mark.parametrize("scheduler", ["ds", "l-ds"])
def test_resume_after_interrupt_is_bit_equal(tmp_path, scheduler, monkeypatch):
    """A 20-step run killed after step 10, then run again: the resumed run
    ends on the step-20 snapshot of an uninterrupted run, bit for bit (the
    data stream of the steps it skips is replayed)."""
    from repro_torch.checkpoint import latest_step
    args = COMMON + ["--steps", "20", "--checkpoint-every", "10", "--slot-every", "3",
                     "--lr", "1e-3", "--scheduler", scheduler]
    with monkeypatch.context() as m:
        crash_after(m, 10)
        with pytest.raises(Crash):
            train.main(args + ["--checkpoint-dir", str(tmp_path / "a")])
    assert latest_step(tmp_path / "a") == 10
    resumed = train.main(args + ["--checkpoint-dir", str(tmp_path / "a")])
    whole = train.main(args + ["--checkpoint-dir", str(tmp_path / "b")])
    assert resumed["start_step"] == 10 and len(resumed["losses"]) == 10
    assert resumed["losses"] == whole["losses"][10:]
    assert latest_step(tmp_path / "a") == latest_step(tmp_path / "b") == 20
    with np.load(tmp_path / "a" / "step_0000000020.npz") as a, \
            np.load(tmp_path / "b" / "step_0000000020.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_example_runs(tmp_path):
    summary = train_lm_cocktail.main(["--d-model", "64", "--layers", "2", "--vocab", "256",
                                      "--steps", "12", "--batch", "4", "--seq", "16",
                                      "--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    assert summary["last_loss"] < summary["first_loss"]
