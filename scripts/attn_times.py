#!/usr/bin/env python3
"""Device times of the SIMT attention kernel (``flash_attention.cu``) of one
source tree, at the cells of ``chip_smoke.py`` phase 6 that take it.

    python3 scripts/attn_times.py [--src DIR] [--library] [--forward] [--json PATH]

Builds the flash library of ``DIR/repro_torch`` (default: this checkout's
``src``) and launches the SIMT kernel (``force_simt=True``) on the inputs
``chip_smoke.py`` draws for each cell: device ms per call by CUDA graph
replay, each cell first held against the plain version (float32 within
2e-5, bf16 within 8e-3 of scale; rows that see no key exactly 0) and its
bound. ``--library`` adds SDPA's device time by graph replay where one call
computes the cell; ``--forward`` adds the profiler's device busy time of
minitron-4b's 16-token forward at full size (weights random from seed 0)
and the SIMT kernel's share of it. To compare two trees, run it on both
in turns on one card (A, B, B, A): an older tree's wrapper is timed as it
is. Prints the card and one JSON object; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# name: (B, Sq, Skv, H, Hkv, hd), dtype, spec keywords, inputs (chip_smoke.attn_inputs)
CELLS = {
    "forward16_bf16": ((4, 16, 16, 32, 8, 128), "bf16", {}, False),
    "prefill_f32": ((4, 2048, 2048, 32, 8, 128), "f32", {}, False),
    "decode_bf16": ((4, 1, 48, 32, 8, 128), "bf16", {}, True),
    "prefill_hd80_bf16": ((4, 2048, 2048, 32, 32, 80), "bf16", {}, False),
    "prefill_hd256_bf16": ((4, 2048, 2048, 8, 1, 256), "bf16", {"prefix_len": 256}, False),
    "softcap_f32": ((2, 512, 512, 8, 2, 128), "f32", {"softcap": 50.0}, False),
    "prefix_f32": ((2, 512, 512, 8, 2, 64), "f32", {"prefix_len": 100}, False),
    "hd80_f32": ((2, 300, 300, 8, 8, 80), "f32", {}, False),
    "masked_rows_f32": ((2, 256, 256, 8, 2, 128), "f32", {"window": 64}, "masked"),
    "decode_hd36_f32": ((4, 1, 48, 32, 8, 36), "f32", {}, True),
}


def cell_inputs(torch, chip_smoke, fref, name: str, seed: int):
    (b, sq, skv, h, hkv, hd), dt, spec_kw, kind = CELLS[name]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, qp, kp, valid = chip_smoke.attn_inputs(torch, b, sq, skv, h, hkv, hd, dtype, seed,
                                                    kind if kind != "masked" else False)
    if kind == "masked":  # one batch row has no valid key; others see some
        valid = torch.ones((b, skv), dtype=torch.bool, device="cuda")
        valid[1] = False
        valid[0, 100:180] = False
    return q, k, v, qp, kp, valid, fref.AttnSpec(**spec_kw)


def forward_profile(torch, chip_smoke) -> dict:
    """minitron-4b's 16-token forward at B 4, full size, under the profiler:
    device busy time and the SIMT kernel's time and launches in it."""
    from repro_torch import configs, models
    cfg = configs.get_config("minitron-4b")
    api = models.build_model(cfg)
    model = api.init(0, dtype=torch.bfloat16)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32, device="cuda")
    api.forward(model, {"tokens": prompt})  # warm
    torch.cuda.synchronize()
    runs = [chip_smoke.profile_window(torch, lambda: api.forward(model, {"tokens": prompt}),
                                      match="flash_fwd_kernel") for _ in range(3)]
    del model, api
    torch.cuda.empty_cache()
    return {"device_busy_ms": [r["device_busy_ms"] for r in runs],
            "simt_ms": [r["match_ms"] for r in runs],
            "simt_launches": [r["match_count"] for r in runs],
            "simt_share": [r["match_ms"] / r["device_busy_ms"] for r in runs],
            "device_launches": [r["device_launches"] for r in runs]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the tree's src directory, holding repro_torch")
    parser.add_argument("--library", action="store_true", help="also time SDPA per cell")
    parser.add_argument("--forward", action="store_true",
                        help="also profile minitron-4b's 16-token forward")
    parser.add_argument("--cells", default=",".join(CELLS), help="comma-separated cell names")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attn_times: no CUDA device is available", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    if src not in Path(fkernel.__file__).resolve().parents:
        raise SystemExit(f"attn_times: imported {fkernel.__file__}, not a module of {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    fkernel.build()
    result = {"card": smi, "src": str(src), "build_s": time.perf_counter() - t0, "cells": {}}
    failed = []
    for idx, name in enumerate(args.cells.split(",")):
        q, k, v, qp, kp, valid, spec = cell_inputs(torch, chip_smoke, fref, name, 300 + idx)
        call = lambda: fkernel.flash_attention_cuda(  # noqa: E731
            q, k, v, qp, kp, spec, kv_valid=valid, force_simt=True)
        before = dict(fkernel.launches)
        got = call()
        simt = fkernel.launches["flash_attention"] - before["flash_attention"] - sum(
            fkernel.launches[n] - before[n] for n in before if n != "flash_attention")
        want = chip_smoke.plain_attention(torch, fops, q, k, v, qp, kp, spec, valid)
        torch.cuda.synchronize()
        err, rel = chip_smoke.rel_err(got, want)
        tol = chip_smoke.BF16_TOL if q.dtype == torch.bfloat16 else chip_smoke.F32_TOL
        unseen = ~fref.attention_mask(qp, kp, spec, valid).any(dim=-1)
        ok = (simt == 1 and rel <= tol and bool(torch.isfinite(got).all())
              and bool((got[unseen] == 0).all()))
        big = q.shape[1] * k.shape[1] > 1_000_000
        bound, bound_by, visible = chip_smoke.attn_bound(torch, fref, q, k, v, qp, kp, spec,
                                                         valid)
        res = {"shape": list(CELLS[name][0]), "dtype": str(q.dtype), "spec": str(spec),
               "err_of_scale": rel, "max_abs_err": err, "ok": ok, "simt_launches": simt,
               "rows_seeing_no_key": int(unseen.sum()), "bound_ms": bound, "bound_by": bound_by,
               "device_ms": chip_smoke.graph_ms_per_call(torch, call, 4 if big else 64,
                                                         3 if big else 10)}
        if hasattr(fkernel, "simt_rows"):
            b, sq, _, h, hkv, hd = CELLS[name][0]
            rows = fkernel.simt_rows(b, sq, hkv, h // hkv, hd, fkernel.device_sms(q.device))
            res.update(rows=rows, occupancy=fkernel.simt_occupancy(q.dtype, hd, rows))
        if args.library:
            sdpa = chip_smoke.sdpa_call(torch, fref, q, k, v, qp, kp, spec, valid)
            res["library_err_of_scale"] = chip_smoke.rel_err(sdpa().transpose(1, 2), want)[1]
            res["library_device_ms"] = chip_smoke.graph_ms_per_call(
                torch, sdpa, 4 if big else 64, 3 if big else 10)
        result["cells"][name] = res
        print(f"{name}: device {res['device_ms']:.5g} ms, bound {bound:.4g} ({bound_by}), "
              f"{rel:.3g} of scale, ok {ok}"
              + (f", SDPA {res['library_device_ms']:.5g} ms" if args.library else ""), flush=True)
        if not ok:
            failed.append(name)
        del q, k, v, got, want, call
        torch.cuda.empty_cache()
    if args.forward:
        result["forward16"] = forward_profile(torch, chip_smoke)
        print(f"forward16: {json.dumps(result['forward16'])}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    if failed:
        print(f"attn_times: {failed} differ from the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
