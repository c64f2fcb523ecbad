"""End-to-end Cocktail training entry point of the port; counterpart of
``repro.launch.train``.

Wires every layer together on the ranks of a mesh (``launch.mesh``):

  Cocktail scheduler (core)  ->  per-slot x/y/z decisions (rank 0)
  CocktailSampler (data)     ->  per-EC batch composition + sample weights
  train step (launch.steps)  ->  weighted mean loss == paper eq. 15, AdamW
  CheckpointManager          ->  atomic snapshots + auto-resume

ECs are the data-parallel shard groups: with dp data-parallel ranks the
scheduler runs max(dp, 2) ECs, and rank r trains the r-th block of the
global batch's rows, EC r's rows when there are as many ECs as ranks. The
ECs' simulated capacities f_j(t) are heterogeneous, so the scheduler
throttles slow workers while the (phi, lam) multipliers repair the induced
data skew. Rank 0 runs the scheduler and broadcasts each slot's x, y and z,
so every rank trains on one decision; every rank draws the whole global
batch from the sampler (deterministic from ``--seed``) and keeps its rows.
Parameters and AdamW moments are sharded over ``data`` by the rule table
(ZeRO: float32 master blocks on each rank), each layer's weights gathered
in the compute dtype at use; only rank 0 prints and returns the summary.

The data stream is a function of ``--seed`` and the step: a resumed run
replays the scheduler's slots and the sampler's draws of the steps it
skips (host work, no model step), so it trains on the batches an
uninterrupted run of its width would. A snapshot holds full arrays, so a
run resumes at another width.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b --reduced \\
        --device cpu --steps 200 --batch 16 --seq 128
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train --arch minitron-4b

Runs on the CUDA card of its rank (``cuda:LOCAL_RANK``) unless ``--device``
names another device; plain ``python -m`` is a world of 1.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import core
from ..checkpoint import CheckpointManager, load_into
from ..configs import get_config, reduced as make_reduced
from ..data import CocktailSampler, TokenSource
from ..models import build_model
from ..optim import AdamWConfig, AdamWState, adamw_init
from ..parallel.sharding import (axis_sizes, batch_axes, local_rows, mesh_context,
                                 param_shardings, shard_params)
from .mesh import local_device, make_host_mesh
from .steps import make_train_step


def build_cocktail(n_cu: int, n_ec: int, seed: int) -> core.CocktailConfig:
    # heterogeneous EC capacities (paper Sec. IV-C): stragglers are the
    # low-capacity workers
    caps = tuple(float(c) for c in
                 np.random.default_rng(seed).choice([8000, 14000, 20000, 48000], n_ec))
    return core.CocktailConfig(n_cu=n_cu, n_ec=n_ec, eps=0.1, delta=0.05,
                               f_base=caps, pair_iters=30, seed=seed)


def _trains(decision) -> bool:
    return float(decision.x.sum() + decision.y.sum()) > 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)  # global
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-cu", type=int, default=12)
    ap.add_argument("--slot-every", type=int, default=10)  # steps per slot
    ap.add_argument("--sched-warmup", type=int, default=8)  # max warmup slots
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--scheduler", default="ds", choices=sorted(core.ALL_SPECS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    mesh = make_host_mesh(device=args.device)
    with mesh_context(mesh):
        return _train(args, cfg, mesh)


def _broadcast_decision(dec, ck, dev) -> core.Decision:
    """Rank 0's x, y and z on every rank (the sampler reads x and y); rank
    0 passes its decision, the others ``None`` and get ``alpha`` / ``theta``
    as ``None``."""
    n, m = ck.n_cu, ck.n_ec
    sizes = [n * m, n * m * m, m * m]
    if dec is not None:
        flat = torch.cat([dec.x.reshape(-1), dec.y.reshape(-1), dec.z.reshape(-1)]).float()
    else:
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dist.broadcast(flat, src=0)
    x, y, z = flat.split(sizes)
    return core.Decision(alpha=None if dec is None else dec.alpha,
                         theta=None if dec is None else dec.theta,
                         x=x.view(n, m), y=y.view(n, m, m), z=z.view(m, m))


def _stub_input(args, cfg, it: int, dev):
    """The stub frontend's global (B, ...) input of step ``it`` (encdec
    frames, vlm patches), drawn from (--seed, it), or None."""
    rows = {"encdec": cfg.enc_ctx, "vlm": cfg.n_img_tokens}.get(cfg.family)
    if rows is None:
        return None
    draw = np.random.default_rng([args.seed, it]).standard_normal(
        (args.batch, rows, cfg.d_model), dtype=np.float32)
    return torch.as_tensor(draw, device=dev)


def _train(args, cfg, mesh):
    rank0 = dist.get_rank() == 0
    dev = local_device(mesh)
    model = build_model(cfg, device=dev)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh))
    n_ec = max(dp, 2)
    if args.batch % n_ec:
        raise ValueError(f"--batch {args.batch} must divide into {n_ec} ECs")

    # --- paper core: scheduler (rank 0) + non-IID sources + sampler ---
    ck = build_cocktail(args.n_cu, n_ec, args.seed)
    spec = core.ALL_SPECS[args.scheduler]
    sched_state = core.init_state(ck, device=dev) if rank0 else None
    # warm-up slots: EC-side queues R start empty, so the first few slots
    # only collect; spin the scheduler until data is actually being trained
    warm_dec = None
    n_slots = 0
    if rank0:
        for _ in range(args.sched_warmup):
            sched_state, _, warm_dec = core.step(ck, spec, sched_state)
            n_slots += 1
            if _trains(warm_dec):
                break
    decision = _broadcast_decision(warm_dec, ck, dev) if args.sched_warmup > 0 else None
    sources = [TokenSource(i, cfg.vocab_size, args.seq, seed=args.seed)
               for i in range(args.n_cu)]
    sampler = CocktailSampler(ck, sources, batch_per_ec=args.batch // n_ec, seed=args.seed)

    # --- model + optimizer state (float32 master blocks on each rank) ---
    opt_cfg = AdamWConfig(lr=args.lr)
    params = shard_params(model.init(args.seed), mesh)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg, total_steps=args.steps)
    p_sh = param_shardings(params)
    shardings = {"params": p_sh, "opt": AdamWState(step=None, m=p_sh, v=p_sh)}

    def snapshot():
        return {"params": dict(params.named_parameters()), "opt": opt_state}

    start = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, every_steps=args.checkpoint_every)
        resumed = ckpt.resume(snapshot(), shardings=shardings)
        if resumed is not None:
            host, _, start = resumed
            load_into(snapshot(), host)
            if rank0:
                print(f"resumed from step {start}")

    losses, step_ms = [], []
    t0 = time.time()
    for it in range(args.steps):
        t_step = time.perf_counter()
        if decision is None or it % args.slot_every == 0:
            new_dec = None
            if rank0:
                sched_state, _, new_dec = core.step(ck, spec, sched_state)
                n_slots += 1
                # steps run at a much finer timescale than slots: between
                # scheduler updates workers keep training the last scheduled
                # mix, so an occasional empty slot (multiplier oscillation)
                # does not stall the optimizer
                if decision is not None and not _trains(new_dec):
                    new_dec = decision
            decision = _broadcast_decision(new_dec, ck, dev)
        host_batch = sampler.sample(decision)
        if it < start:  # trained before the snapshot: replayed for the data stream only
            continue
        batch = {k: local_rows(torch.as_tensor(host_batch[k], device=dev), mesh)
                 for k in ("tokens", "labels", "weights")}
        extra = _stub_input(args, cfg, it, dev)
        if extra is not None:
            batch["frames" if cfg.family == "encdec" else "patches"] = local_rows(extra, mesh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if ckpt is not None:
            ckpt.maybe_save(it + 1, snapshot(), extra={"arch": cfg.name, "step": it + 1},
                            shardings=shardings)
        if rank0 and (it + 1) % args.log_every == 0:
            sk = float(core.skew_degree(ck, sched_state.queues.omega))
            print(f"step {it+1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"sched_cost={float(sched_state.total_cost):.0f} "
                  f"skew={sk:.4f} "
                  f"({(time.time()-t0)/(it+1-start):.2f}s/step)")

    if not rank0:
        return None
    nonzero = [l for l in losses if l > 0]
    summary = {
        "arch": cfg.name, "steps": args.steps,
        "first_loss": float(np.mean(nonzero[:3])) if nonzero else None,
        "last_loss": float(np.mean(nonzero[-10:])) if nonzero else None,
        "min_loss": float(np.min(nonzero[3:])) if len(nonzero) > 3 else None,
        "scheduler": args.scheduler,
        "sched_cost": float(sched_state.total_cost),
        "sched_trained": float(sched_state.total_trained),
        "skew_degree": float(core.skew_degree(ck, sched_state.queues.omega)),
        "device": str(dev), "n_layers": cfg.n_layers, "start_step": start,
        "sched_slots": n_slots, "world": dist.get_world_size(), "dp": dp, "n_ec": n_ec,
        "losses": losses, "step_ms": step_ms,
    }
    print(json.dumps(summary))
    return summary

if __name__ == "__main__":
    main()
