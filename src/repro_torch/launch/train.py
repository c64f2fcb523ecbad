"""End-to-end Cocktail training entry point of the port; counterpart of
``repro.launch.train``.

Wires every layer together on one device:

  Cocktail scheduler (core)  ->  per-slot x/y/z decisions
  CocktailSampler (data)     ->  per-EC batch composition + sample weights
  train step (launch.steps)  ->  weighted mean loss == paper eq. 15, AdamW
  CheckpointManager          ->  atomic snapshots + auto-resume

ECs are the data-parallel shard groups; their simulated capacities f_j(t)
are heterogeneous, so the scheduler throttles slow workers while the
(phi, lam) multipliers repair the induced data skew. One card is one
data-parallel group, so the scheduler keeps two ECs (the JAX entry point's
``max(dp, 2)``). The model keeps float32 master weights and AdamW moments
on the device and computes in ``cfg.compute_dtype``.

The data stream is a function of ``--seed`` and the step: a resumed run
replays the scheduler's slots and the sampler's draws of the steps it
skips (host work, no model step), so it trains on the batches an
uninterrupted run would.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b --reduced \\
        --device cpu --steps 200 --batch 16 --seq 128

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import core
from ..checkpoint import CheckpointManager, load_into
from ..configs import get_config, reduced as make_reduced
from ..data import CocktailSampler, TokenSource
from ..models import build_model
from ..optim import AdamWConfig, adamw_init
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
    model = build_model(cfg, device=args.device)
    dev = model.device
    n_ec = 2
    if args.batch % n_ec:
        raise ValueError(f"--batch {args.batch} must divide into {n_ec} ECs")

    # --- paper core: scheduler + non-IID sources + sampler ---
    ck = build_cocktail(args.n_cu, n_ec, args.seed)
    spec = core.ALL_SPECS[args.scheduler]
    sched_state = core.init_state(ck, device=dev)
    # warm-up slots: EC-side queues R start empty, so the first few slots
    # only collect; spin the scheduler until data is actually being trained
    warm_dec = None
    n_slots = 0
    for _ in range(args.sched_warmup):
        sched_state, _, warm_dec = core.step(ck, spec, sched_state)
        n_slots += 1
        if _trains(warm_dec):
            break
    sources = [TokenSource(i, cfg.vocab_size, args.seq, seed=args.seed)
               for i in range(args.n_cu)]
    sampler = CocktailSampler(ck, sources, batch_per_ec=args.batch // n_ec, seed=args.seed)

    # --- model + optimizer state (float32 master weights on the device) ---
    opt_cfg = AdamWConfig(lr=args.lr)
    params = model.init(args.seed)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg, total_steps=args.steps)

    def snapshot():
        return {"params": dict(params.named_parameters()), "opt": opt_state}

    start = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, every_steps=args.checkpoint_every)
        resumed = ckpt.resume(snapshot())
        if resumed is not None:
            host, _, start = resumed
            load_into(snapshot(), host)
            print(f"resumed from step {start}")

    decision = warm_dec
    losses, step_ms = [], []
    t0 = time.time()
    for it in range(args.steps):
        t_step = time.perf_counter()
        if decision is None or it % args.slot_every == 0:
            sched_state, _, new_dec = core.step(ck, spec, sched_state)
            n_slots += 1
            # steps run at a much finer timescale than slots: between
            # scheduler updates workers keep training the last scheduled
            # mix, so an occasional empty slot (multiplier oscillation)
            # does not stall the optimizer
            if decision is None or _trains(new_dec):
                decision = new_dec
        host_batch = sampler.sample(decision)
        if it < start:  # trained before the snapshot: replayed for the data stream only
            continue
        batch = {k: torch.as_tensor(host_batch[k], device=dev)
                 for k in ("tokens", "labels", "weights")}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if ckpt is not None:
            ckpt.maybe_save(it + 1, snapshot(), extra={"arch": cfg.name, "step": it + 1})
        if (it + 1) % args.log_every == 0:
            sk = float(core.skew_degree(ck, sched_state.queues.omega))
            print(f"step {it+1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"sched_cost={float(sched_state.total_cost):.0f} "
                  f"skew={sk:.4f} "
                  f"({(time.time()-t0)/(it+1-start):.2f}s/step)")

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
        "sched_slots": n_slots,
        "losses": losses, "step_ms": step_ms,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
