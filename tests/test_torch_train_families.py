"""Cocktail-scheduled training of the MoE, hybrid, encoder-decoder, VLM and
soft-capped dense families through the port's entry point
(``launch.train.main``), reduced, on the CPU.

For each of gemma2-27b, mixtral-8x7b, zamba2-2.7b, whisper-base and
paligemma-3b, ``train.main --reduced --device cpu`` runs 3 steps with a
scheduler slot every 2 steps, its train step patched to record each batch
and the state after the first step:

  * every loss is finite and the scheduler ran its slots;
  * the step's batch carries the frames (whisper) or patches (paligemma)
    the entry point draws from (--seed, step), of the family's shape, and
    no such input for the other families;
  * the run's first step is bit-equal to ``make_train_step`` outside the
    entry point (no mesh) on the run's first batch from the same seed-0
    model: loss, updated parameters and both AdamW moments.

gemma2-27b's reduced train step (the soft-caps, the local / global windows,
post-norms and tied embeddings) is also held against the JAX package's
``make_train_step`` outside a mesh by ``tests/test_torch_distributed.py``'s
rule at 1e-4 of each leaf's scale (1e-5 relative on the loss).

``chip_smoke.py`` counts each train step's exact attention launches on the
card from the config (``attention_calls``, each call's kernel by
``kernel.variant``). On the CPU, with bf16 compute and remat as at full
width, every call a family's differentiated forward makes to the
attention's plain version (the forward and the remat recompute) has the
(type, head dim, query rows) that count predicts.
"""
from __future__ import annotations

import dataclasses
import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import _case, _hold, _references  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = ["gemma2-27b", "mixtral-8x7b", "zamba2-2.7b", "whisper-base", "paligemma-3b"]
STEPS, SLOT_EVERY, BATCH, SEQ, LR = 3, 2, 4, 16, 3e-4
ARGV = ["--reduced", "--device", "cpu", "--steps", str(STEPS), "--slot-every", str(SLOT_EVERY),
        "--batch", str(BATCH), "--seq", str(SEQ), "--n-cu", "6", "--lr", str(LR),
        "--seed", "0", "--log-every", "100"]
# family -> (batch key, rows of the stub input)
STUB = {"encdec": ("frames", lambda cfg: cfg.enc_ctx),
        "vlm": ("patches", lambda cfg: cfg.n_img_tokens)}


def _recorded_run(arch: str) -> dict:
    """``train.main`` on reduced ``arch`` with its train step recording every
    batch and, after the first step, the parameters and moments."""
    make = train.make_train_step
    rec: dict = {"batches": []}

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(params, opt, batch):
            rec["batches"].append({k: v.clone() for k, v in batch.items()})
            out = step(params, opt, batch)
            if len(rec["batches"]) == 1:
                rec["params"] = {k: p.detach().clone() for k, p in out[0].named_parameters()}
                rec["m"] = {k: t.clone() for k, t in out[1].m.items()}
                rec["v"] = {k: t.clone() for k, t in out[1].v.items()}
                rec["loss"] = out[2]["loss"].clone()
            return out
        return run

    train.make_train_step = recording
    try:
        rec["summary"] = train.main(["--arch", arch] + ARGV)
    finally:
        train.make_train_step = make
    return rec


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return request.param, _recorded_run(request.param)


def test_losses_are_finite(run):
    arch, rec = run
    summary = rec["summary"]
    assert summary["arch"] == arch and summary["device"] == "cpu"
    assert len(summary["losses"]) == STEPS and all(np.isfinite(summary["losses"]))
    assert summary["n_layers"] == reduced(get_config(arch)).n_layers
    assert summary["sched_slots"] >= -(-STEPS // SLOT_EVERY) and summary["sched_trained"] > 0
    assert len(rec["batches"]) == STEPS


def test_stub_inputs_reach_the_step(run):
    arch, rec = run
    cfg = reduced(get_config(arch))
    for it, batch in enumerate(rec["batches"]):
        assert batch["tokens"].shape == (BATCH, SEQ)
        if cfg.family not in STUB:
            assert set(batch) == {"tokens", "labels", "weights"}
            continue
        key, rows = STUB[cfg.family]
        assert set(batch) == {"tokens", "labels", "weights", key}
        want = np.random.default_rng([0, it]).standard_normal(
            (BATCH, rows(cfg), cfg.d_model), dtype=np.float32)
        np.testing.assert_array_equal(batch[key].numpy(), want)


def test_first_step_is_make_train_step(run):
    """The entry point's first step (under its world-of-1 mesh) against
    ``make_train_step`` on the same batch from the same seed-0 model."""
    arch, rec = run
    cfg = reduced(get_config(arch))
    api = build_model(cfg, device="cpu")
    model = api.init(0)
    opt = adamw_init(model)
    from repro_torch.launch.steps import make_train_step
    model, opt, met = make_train_step(api, AdamWConfig(lr=LR), total_steps=STEPS)(
        model, opt, rec["batches"][0])
    assert torch.equal(met["loss"], rec["loss"]), (float(met["loss"]), float(rec["loss"]))
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), rec["params"][k]), k
        assert torch.equal(opt.m[k], rec["m"][k]), k
        assert torch.equal(opt.v[k], rec["v"][k]), k


@pytest.fixture(scope="module")
def gemma2_refs():
    return _references(_case("gemma2-27b", {}))


def test_gemma2_train_step_matches_jax(gemma2_refs):
    ref = gemma2_refs
    cfg = ref["cfg"]
    assert cfg["attn_softcap"] > 0 and cfg["logit_softcap"] > 0 and cfg["post_norm"]
    assert cfg["local_global_alternate"] and cfg["tie_embeddings"]
    _hold(ref["port"], ref["jax"], ref["jax"]["m"], ref["p0"], 1e-4, "gemma2-27b vs JAX")


@pytest.mark.parametrize("arch", ARCHS + ["minitron-4b"])
def test_attention_calls_are_the_models(arch, monkeypatch):
    cfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype="bfloat16", remat=True)
    calls = []
    plain = fops.attention_chunked

    def recording(q, k, v, *args, **kwargs):
        calls.append((q.dtype, q.shape[-1], q.shape[1]))
        return plain(q, k, v, *args, **kwargs)

    monkeypatch.setattr(fops, "attention_chunked", recording)
    api = build_model(cfg, device="cpu")
    model = api.init(0)
    model.requires_grad_(True)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, SEQ)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    stub = train._stub_input(types.SimpleNamespace(seed=0, batch=2), cfg, 0, "cpu")
    if stub is not None:
        batch[STUB[cfg.family][0]] = stub
    loss, _ = api.loss(model, batch)
    torch.autograd.grad(loss, list(model.parameters()))
    assert Counter(calls) == Counter(chip_smoke.attention_calls(cfg, SEQ) * 2)
    counts = chip_smoke.train_attention_launches(cfg, SEQ, 1)
    assert counts["flash_attention"] == len(calls)
