#!/usr/bin/env python3
"""Where the bf16 decode-vs-forward gap of the full-size models comes from.

    python3 scripts/bf16_gap.py [--arch NAME ...] [--json PATH]

For each arch (default: minitron-4b, qwen2.5-32b, mixtral-8x7b at the
depth ``chip_smoke.py`` phase 12 serves, zamba2-2.7b) at its published
widths, with bf16 weights drawn on the card from seed 0 and the tokens
``chip_smoke.phase_serve`` decodes, computes the logits of the forward and
of teacher-forced decode on five routes: bf16 with the kernels, bf16 with
the plain versions (``impl="chunked"``), bf16 with the kernels and cuBLAS's
reduced-precision bf16 reduction off, float32 compute (same weights) with
the kernels. Prints, of the float32 forward's scale, each bf16 route's
forward and decode against the float32 forward, each route's decode against
its forward, the kernels' bf16 decode against the plain one, whether the
reduction setting changed any bit, and for an MoE the expert choices that
differ between decode and forward. Prints the card and one JSON object;
needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("minitron-4b", "qwen2.5-32b", "mixtral-8x7b", "zamba2-2.7b")


def decode(torch, cfg, api, model, tokens, extra):
    """Teacher-forced decode logits (B, S, V) from a fresh cache."""
    from repro_torch.models import encdec
    cache = api.init_cache(tokens.shape[0], 48)
    if cfg.family == "encdec":
        cache = encdec.prefill_cross(cfg, model, extra["frames"], cache)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def experts(torch, log, n_layers: int, steps: int) -> list:
    """Per layer, the (T, k) sorted expert ids of a forward (``steps`` 1) or
    of ``steps`` decode calls."""
    ids = [i.sort(-1).values for i, _ in log]
    return [torch.cat([ids[s * n_layers + layer] for s in range(steps)])
            for layer in range(n_layers)]


def gaps(torch, cs, models, configs, arch: str) -> dict:
    from repro_torch.models import moe
    cfg = configs.get_config(arch)
    if arch in cs.FAMILY_CELLS and cs.FAMILY_CELLS[arch][0]:
        cfg = dataclasses.replace(cfg, n_layers=cs.FAMILY_CELLS[arch][0])
    api = models.build_model(cfg)
    model = api.init(0, dtype=torch.bfloat16)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device="cuda")
    extra = cs.stub_inputs(torch, cfg, 4, seed=2)
    tokens = cs.decode_tokens(cfg, prompt)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    routes = {"bf16_kernels": (cfg, api, True),
              "bf16_plain": (cfg, models.build_model(cfg, impl="chunked"), True),
              "bf16_kernels_no_reduced_reduction": (cfg, api, False),
              "f32_kernels": (cfg32, models.build_model(cfg32), True)}
    logits, routing = {}, {}
    matmul = torch.backends.cuda.matmul
    for name, (c, a, reduced) in routes.items():
        matmul.allow_bf16_reduced_precision_reduction = reduced
        with moe.recording_routing() as log_f:  # (the forward an MoE records itself)
            fwd = (a.forward(model, {"tokens": tokens}) if cfg.family == "moe" else
                   cs.reference_forward(c, a, model, tokens, extra)).float()
        with moe.recording_routing() as log_d:
            dec = decode(torch, c, a, model, tokens, extra).float()
        logits[name] = (fwd, dec)
        if cfg.family == "moe":
            routing[name] = (experts(torch, log_f, cfg.n_layers, 1),
                             experts(torch, log_d, cfg.n_layers, tokens.shape[1]))
    matmul.allow_bf16_reduced_precision_reduction = True
    ref = logits["f32_kernels"][0]
    out = {"n_layers": cfg.n_layers, "tokens": list(tokens.shape),
           "f32_logit_scale": float(ref.abs().max())}
    for name, (fwd, dec) in logits.items():
        r = {"forward_vs_f32_forward": cs.rel_err(fwd, ref)[1],
             "decode_vs_f32_forward": cs.rel_err(dec, ref)[1],
             "decode_vs_forward": cs.logit_gap(dec, fwd)}
        if name in routing:
            f, d = routing[name]
            r["expert_flips_decode_vs_forward"] = int(sum(int((x != y).any(-1).sum())
                                                          for x, y in zip(f, d)))
        out[name] = r
    out["bf16_kernels_decode_vs_plain_decode"] = cs.logit_gap(
        logits["bf16_kernels"][1], logits["bf16_plain"][1])
    out["reduced_reduction_changes_bits"] = not all(
        torch.equal(x, y) for x, y in zip(logits["bf16_kernels"],
                                          logits["bf16_kernels_no_reduced_reduction"]))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", action="append", default=None)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bf16_gap: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import configs, models
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.mamba_scan import kernel as skernel
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda mod: mod.build(), (fkernel, skernel)))
    res = {}
    for arch in args.arch or ARCHS:
        res[arch] = gaps(torch, cs, models, configs, arch)
        print(arch, json.dumps(res[arch]), flush=True)
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "archs": res}, indent=1))
    print(json.dumps({"card": smi, "archs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
