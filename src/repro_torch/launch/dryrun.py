"""Dry run of every (arch x shape x mesh x style) cell for the H100: one
rank's step traced abstractly on a fake process group of 256 or 512 ranks,
with the per-rank memory, operations, collective bytes and roofline;
counterpart of ``repro.launch.dryrun``, the capacity planner.

MUST be invoked as its own process: it starts the default process group as
the fake backend (``torch.testing._internal.distributed.fake_pg``) with
the production mesh's world size, which no other process group may
precede:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape train_4k --mesh pod --out build/dryrun

The step is the port's own: ``build_model(cfg, device="cpu")``, rank 0's
blocks of the weights (``model.init(0, dtype, mesh=mesh)``; float32 master
weights and AdamW moments for a train cell, the compute type for serving),
its rows of ``specs.batch_abstract``'s batch where ``batch_pspecs`` shards
them, or its blocks of ``specs.decode_abstract``'s cache as
``cache_pspecs`` places them (``layers.alloc_cache``), through
``make_train_step``, ``make_prefill_step`` (inside
``layers.vocab_parallel()``: the logits stay the rank's vocab block, as the
JAX dry run's ``out_shardings`` leave them) or ``make_serve_step``, all
under ``FakeTensorMode`` and ``mesh_context(mesh, style)``. Nothing is
launched on any device and nothing is allocated: the fake CPU tensors take
the plain versions of the kernels (``attention_chunked``,
``mamba1_scan_chunked``), as the JAX dry run lowers its jnp paths on host
devices, and the record says ``"route": "plain"``. The fake tensors are
the design of a dry run, not a fallback: the card runs the kernels.

Outputs one JSON per cell (same tag, keys and ``OK`` / ``SKIP`` / ``FAIL``
lines and exit codes as the JAX dry run):

  memory:   argument / output / temp / peak / alias bytes of rank 0
            (``op_cost.OpCost``'s live storages; alias: the bytes updated in
            place, weights and moments or the cache)
  cost:     flops, bytes written, dot operand bytes and the traffic proxy
            (``op_cost``, the counterpart of ``hlo_cost``)
  collectives_bytes: wire bytes a rank by kind (ring formulas)
  analytic_memory:   the JAX package's analytic residency and traffic
            model, ported line for line
  roofline: compute / memory / collective seconds against the H100's data
            sheet constants below: projections, not measurements

``compile_seconds`` is the host seconds of the traced step (there is no
compile). The JAX dry run's ``--save-hlo`` has no counterpart (there is no
HLO), nor its XLA cost-analysis and while-loop trip-count keys: the counter
sees every op the step executes, loops unrolled by Python.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import SHAPES, get_config
from ..models import build_model
from ..models.layers import vocab_parallel
from ..optim import AdamWConfig, adamw_init
from ..parallel.sharding import local_rows, mesh_context
from . import specs as S
from .mesh import make_production_mesh
from .op_cost import OpCost, storage_bytes
from .steps import make_prefill_step, make_serve_step, make_train_step

# H100 SXM constants (per card)
PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM data sheet
HBM_BW = 3.35e12  # bytes/s of HBM3, H100 SXM data sheet
HBM_BYTES = 80e9  # 80 GB of HBM3, H100 SXM data sheet
# A 16-wide mesh axis spans two 8-card nodes, so its collectives cross the
# nodes' network: NDR InfiniBand, 400 Gb/s a card.
NET_BW = 50e9  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction of NVLink 4 (900 GB/s both ways)


def analytic_memory(cfg, shape_name: str, kind: str, mesh_shape: tuple,
                    cache_abs=None, cache_specs=None, style: str = "tp") -> dict:
    """Projected per-rank memory residency and HBM traffic (bytes): the JAX
    package's analytic model (``repro.launch.dryrun.analytic_memory``), line
    for line; ``fits_hbm`` against the H100's 80 GB. The counted traffic
    (``op_cost``) is reported beside it as an upper bound."""
    seq, gb, _ = SHAPES[shape_name]
    n_chips = 1
    for d in mesh_shape:
        n_chips *= d
    model_sz = mesh_shape[-1]
    dp = n_chips // model_sz
    p_total = cfg.n_params()
    p_active = cfg.n_active_params()
    tok_dev = gb * seq // dp
    b_dev = max(gb // dp, 1)
    d_model, n_layers = cfg.d_model, cfg.n_layers
    v_shard = (cfg.vocab_size // model_sz if cfg.vocab_size % model_sz == 0
               else cfg.vocab_size)

    if kind == "train":
        # fp32 master + adam m/v sharded over (data x model); bf16 cast and
        # f32 grads are transient but coexist with activations at peak.
        state = p_total * 12 / n_chips
        transients = p_total * 6 / n_chips  # bf16 copy + f32 grad shard
        act = n_layers * b_dev * seq * d_model * 2  # remat: one carry/layer
        if style == "tp_sp":  # sequence-sharded carries
            act /= model_sz
        logits = 2 * tok_dev * v_shard * 4
        residency = state + transients + act + logits
        # traffic: 3 weight passes (fwd + remat + bwd) over the gathered TP
        # shard; optimizer read/write; activation carries w+r; logits io.
        w_shard = p_active * 2 / model_sz
        traffic = 3 * w_shard + p_total * 24 / n_chips + 2 * act + 2 * logits
    elif kind == "prefill":
        state = p_total * 2 / n_chips  # bf16 serving weights
        act = b_dev * seq * d_model * 2 * 4  # few live layers, no bwd
        kv = 0.0
        if cfg.n_kv_heads and cfg.family not in ("ssm",):
            kv = (n_layers * b_dev * seq * cfg.n_kv_heads
                  * cfg.resolved_head_dim * 2 * 2 / model_sz)
        residency = state + act + kv
        traffic = p_active * 2 / model_sz + 2 * act + kv
    else:  # decode
        state = p_total * 2 / n_chips
        cache_dev = 0.0
        if cache_abs is not None:
            ms = dict(zip(("pod", "data", "model")[-len(mesh_shape):], mesh_shape))
            for name, leaf in cache_abs.items():
                nb = float(math.prod(leaf.shape)) * leaf.element_size()
                shards = 1
                if cache_specs is not None and name in cache_specs:
                    for entry in cache_specs[name]:
                        axes = (entry,) if isinstance(entry, str) else (entry or ())
                        for ax in axes:
                            shards *= ms.get(ax, 1)
                cache_dev += nb / shards
        residency = state + cache_dev
        # per decoded token: all weights (TP shard) + the whole local cache
        traffic = p_active * 2 / model_sz + cache_dev
    return {"residency_bytes": float(residency), "traffic_bytes": float(traffic),
            "fits_hbm": bool(residency <= HBM_BYTES)}


def fake_world(world_size: int) -> None:
    """Start the default process group as ``world_size`` fake ranks (this
    process is rank 0; collectives return at once and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(f"the dry run needs a fake world of {world_size} ranks; this "
                               f"process has a {dist.get_backend()} world of "
                               f"{dist.get_world_size()}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _rows(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """Rank 0's rows of a global batch leaf placed by ``spec``, as a new
    tensor (a view would hold the global storage)."""
    return local_rows(x, mesh).clone() if spec[0] is not None else x


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_cfg: AdamWConfig = AdamWConfig(), style: str = "tp",
               pad_vocab: bool = False) -> dict:
    """Trace one cell's step on rank 0 of the fake production world; returns
    its record. The process group must be the fake world of the mesh's size
    (``fake_world``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if pad_vocab and cfg.vocab_size % 128:
        # pad the vocab to a TP-shardable multiple (padded logits rows are
        # never labelled; standard practice, counted in the FLOPs honestly)
        cfg = dataclasses.replace(cfg, vocab_size=-(-cfg.vocab_size // 128) * 128)
    if shape_name not in cfg.shapes():
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long-context cell skipped: full-attention arch "
                          "(DESIGN.md §4)"}
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    seq, gb, kind = SHAPES[shape_name]
    api = build_model(cfg, device="cpu")
    dtype = getattr(torch, cfg.param_dtype if kind == "train" else cfg.compute_dtype)
    t0 = time.time()
    cache_abs = raw_c = None
    with FakeTensorMode(), mesh_context(mesh, style=style):
        params = api.init(0, dtype, mesh=mesh)
        cost = OpCost()
        if kind == "train":
            opt = adamw_init(params)
            batch_abs = S.batch_abstract(cfg, shape_name, "train")
            b_specs = S.batch_pspecs(cfg, batch_abs, mesh)
            batch = {k: _rows(v, b_specs[k], mesh) for k, v in batch_abs.items()}
            step = make_train_step(api, opt_cfg)
            args, alias = (params, opt, batch), (params, opt)
            run = lambda: step(params, opt, batch)  # noqa: E731
        elif kind == "prefill":
            batch_abs = S.batch_abstract(cfg, shape_name, "prefill")
            b_specs = S.batch_pspecs(cfg, batch_abs, mesh)
            batch = {k: _rows(v, b_specs[k], mesh) for k, v in batch_abs.items()}
            step = make_prefill_step(api)
            args, alias = (params, batch), ()

            def run():
                with vocab_parallel():
                    return step(params, batch)
        else:  # decode
            cache_abs, tok_abs = S.decode_abstract(cfg, api, shape_name)
            raw_c, t_spec = S.decode_pspecs(cfg, cache_abs, gb, mesh)
            cache = api.init_cache(gb, seq)  # the rank's blocks, as raw_c places them
            for k, v in cache.items():
                if isinstance(v, torch.Tensor) and tuple(v.shape) != S.local_shape(
                        tuple(cache_abs[k].shape), raw_c[k], mesh):
                    raise AssertionError(f"cache leaf {k}: block {tuple(v.shape)} is not "
                                         f"{raw_c[k]}'s")
            cache["pos"] = seq - 1  # the context's last slot takes the new token
            tokens = _rows(tok_abs, t_spec, mesh)
            step = make_serve_step(api)
            args, alias = (params, cache, tokens), (cache,)
            run = lambda: step(params, cache, tokens)  # noqa: E731
        arg_storages = storage_bytes(args)
        with cost:
            cost.track(args)
            out = run()
    arg_bytes = sum(arg_storages.values())
    alias_bytes = sum(storage_bytes(alias).values())
    out_bytes = sum(n for k, n in storage_bytes(out).items() if k not in arg_storages)
    step_s = time.time() - t0

    n_chips = 512 if multi_pod else 256
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    coll_bytes = cost.total_collective_bytes
    eff_mesh = mesh_shape if style != "fsdp" else (n_chips, 1)
    am = analytic_memory(cfg, shape_name, kind, eff_mesh, cache_abs=cache_abs,
                         cache_specs=raw_c, style=style)
    record = {
        "arch": arch, "shape": shape_name, "kind": kind, "style": style,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": n_chips,
        "seq": seq, "global_batch": gb, "route": "plain",
        "compile_seconds": round(step_s, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(cost.peak_bytes - arg_bytes - out_bytes, 0),
            "peak_bytes": cost.peak_bytes,
            "alias_bytes": alias_bytes,
        },
        "cost": {
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.memory_traffic,
            "bytes_written_per_device": cost.bytes_written,
            "dot_operand_bytes": cost.dot_operand_bytes,
            "ops": cost.ops,
        },
        "collectives_bytes": dict(cost.collective_bytes),
        "collective_calls": dict(cost.collective_calls),
        "collective_calls_by_group": dict(cost.calls_by_group),
        "analytic_memory": am,
        "roofline": {
            "compute_s": cost.flops / PEAK_FLOPS,
            "memory_s": am["traffic_bytes"] / HBM_BW,
            "memory_s_upper": cost.memory_traffic / HBM_BW,
            "collective_s": coll_bytes / NET_BW,
            "collective_s_nvlink": coll_bytes / NVLINK_BW,
        },
    }
    rf = record["roofline"]
    rf["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: rf[k])
    rf["step_s_lower_bound"] = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--style", default="tp", choices=["tp", "tp_sp", "fsdp", "serve"])
    ap.add_argument("--pad-vocab", action="store_true")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = f"{args.arch}_{args.shape}_{args.mesh}".replace(".", "_").replace("/", "_")
    if args.style != "tp":
        tag += f"_{args.style}"
    try:
        fake_world(512 if args.mesh == "multipod" else 256)
        record = lower_cell(args.arch, args.shape, args.mesh == "multipod", style=args.style,
                            pad_vocab=args.pad_vocab)
    except Exception as e:  # record failures: they are bugs to fix
        record = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    (outdir / f"{tag}.json").write_text(json.dumps(record, indent=2))
    if "error" in record:
        print(f"FAIL {tag}: {record['error'][:200]}")
        raise SystemExit(1)
    if record.get("skipped"):
        print(f"SKIP {tag}: {record['reason']}")
        return
    rf = record["roofline"]
    print(f"OK {tag}: compile={record['compile_seconds']}s "
          f"peak={record['memory']['peak_bytes']/2**30:.2f}GiB/dev "
          f"compute={rf['compute_s']*1e3:.2f}ms mem={rf['memory_s']*1e3:.2f}ms "
          f"coll={rf['collective_s']*1e3:.2f}ms -> {rf['bottleneck']}")


if __name__ == "__main__":
    main()
