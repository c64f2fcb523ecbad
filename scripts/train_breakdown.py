#!/usr/bin/env python3
"""Where a train step's time goes, for each family ``chip_smoke.py`` phase 18
trains (and minitron-4b, phase 11's model), at its published widths.

    python3 scripts/train_breakdown.py [--arch A ...] [--json PATH]

For each arch, cut to phase 18's depth (``chip_smoke.TRAIN18_CELLS``), with
weights drawn on the card from seed 0 and a B 16 x 128 batch of the run's
sampler (frames or patches as ``train._stub_input`` draws them), runs
``chip_smoke.profile_train_step`` without a mesh: the median host ms of
three steps after a warm one, one step under torch.profiler (device busy
time, launches, the largest kernels, the attention kernels' time -- the
scan kernels' for falcon-mamba-7b -- and the attention and scan launches,
which must be the config's exactly) and one step split into its
forward, backward (with the remat recompute) and AdamW spans by CUDA
events; and the peak memory of it all. Prints the card and one JSON
object; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cells = dict(cs.TRAIN18_CELLS, **{"minitron-4b": 0})
    parser.add_argument("--arch", nargs="*", default=list(cells), choices=list(cells))
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import configs, models, optim
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.kernels.matching import kernel
    from repro_torch.launch import steps, train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = (kernel, fkernel, skernel)
    out = {"card": smi, "torch": torch.__version__, "archs": {}}
    for arch in args.arch:
        cfg = configs.get_config(arch)
        if cells[arch]:
            cfg = dataclasses.replace(cfg, name=f"{arch}-{cells[arch]}l", n_layers=cells[arch])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = cs.profile_train_step(torch, models.build_model(cfg), train, steps, optim, kernels,
                                  match="mamba1_scan" if cfg.family == "ssm" else "flash_")
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["n_layers"] = cfg.n_layers
        out["archs"][cfg.name] = r
        print(f"{cfg.name} [{smi}]: " + json.dumps(r), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
