"""Batched greedy-decode serving entry point of the port (counterpart of
``repro.launch.serve``): the prompt is fed through the KV cache / recurrent
state one token at a time (teacher-forced), then ``--gen`` tokens are
generated greedily; prints one JSON summary line. An encoder-decoder first
encodes stub frames (drawn from a generator seeded with 1) into its
cross-attention cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced --device cpu
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.serve \
        --arch mixtral-8x7b --model-parallel 2

Runs on the CUDA card (weights drawn there from ``--seed``, stored in the
compute dtype); ``--device cpu`` runs the plain PyTorch versions instead.
It builds the host mesh (``--model-parallel N`` ranks on its ``model``
axis, the rest on ``data``) and serves inside its context in the ``serve``
style, as the JAX package's decode cells place the weights: each rank draws
and keeps its tensor-parallel block of every leaf (replicated over
``data``), takes its rows of the batch over ``data``, and greedy tokens
come from the logits gathered along the vocab. Rank 0 prints the summary,
which names the mesh and the collectives of a decode step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config, reduced as make_reduced
import torch.distributed as dist

from ..models import build_model, encdec
from ..parallel.sharding import (axis_sizes, comm_counts, local_rows, mesh_context,
                                 reset_comm_counts)
from .mesh import local_device, make_host_mesh
from .steps import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (a depth cut where the model does not "
                         "fit the card); 0 keeps them all")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor parallelism)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = make_host_mesh(model_parallel=args.model_parallel, device=args.device)
    with mesh_context(mesh, "serve"):
        return _serve(args, cfg, mesh)


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch leaf, where they divide over the
    data-parallel ranks (the cache is laid out so; else every rank serves
    the whole batch)."""
    try:
        return local_rows(x, mesh)
    except ValueError:
        return x


def _serve(args, cfg, mesh):
    model = build_model(cfg, device=local_device(mesh))
    params = model.init(args.seed, dtype=getattr(torch, cfg.compute_dtype), mesh=mesh)
    cache = model.init_cache(args.batch, args.prompt_len + args.gen)
    if cfg.family == "encdec":
        gen = torch.Generator(device=model.device).manual_seed(1)
        frames = torch.randn((args.batch, cfg.enc_ctx, cfg.d_model), generator=gen,
                             device=model.device)
        cache = encdec.prefill_cross(cfg, params, _rows(frames, mesh), cache)
    step = make_serve_step(model)

    rng = np.random.default_rng(args.seed)
    prompt = _rows(torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (args.batch, args.prompt_len)),
                                   dtype=torch.int32, device=model.device), mesh)
    tok = None
    reset_comm_counts()
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        tok, cache = step(params, cache, prompt[:, t:t + 1])
    generated = []
    for _ in range(args.gen):
        tok, cache = step(params, cache, tok)
        generated.append(tok[:, 0].cpu().numpy())  # waits for the step
    dt = time.perf_counter() - t0
    out = np.stack(generated, axis=1)
    n_steps = args.prompt_len + args.gen
    summary = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch, "generated": args.gen,
        "tokens_per_s": round(args.batch * n_steps / dt, 1), "decode_s": dt,
        "sample_tokens": out[0][:8].tolist(), "device": str(model.device),
        "mesh": axis_sizes(mesh),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(model.device) / 2 ** 30
                            if model.device.type == "cuda" else None),
        "collectives_per_step": {k: v / n_steps for k, v in sorted(comm_counts.items())
                                 if not k.endswith("_bytes")},
    }
    if dist.get_rank() == 0:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
