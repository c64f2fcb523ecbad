"""Spawned ``torch.distributed`` worlds for the port's distributed tests.

``World(n, task, payload, tmp_path, timeout)`` starts ``n`` processes
(``torch.multiprocessing``, spawn), one rank each, joined through gloo and a
``FileStore`` under ``tmp_path``; rank r runs ``TASKS[task](payload)`` and
pickles its result, and the world's ``result()`` returns the ranks' results
in rank order. A rank that raises or exits non-zero fails ``result()`` with
its traceback, and a world that has not finished within ``timeout`` seconds
of its start is killed and fails it too. Each rank runs one intra-op
thread, so several worlds can run at once.

This module imports torch and the port only, so a rank never imports JAX;
the tests compute their JAX references in the parent process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import pickle
import time
import uuid
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

# --------------------------------------------------------------------------
# The world
# --------------------------------------------------------------------------


class World:
    """A started world; ``result()`` waits for it."""

    def __init__(self, n: int, task: str, payload, tmp_path, timeout: float):
        self.n, self.task, self.timeout = n, task, timeout
        self.work = Path(tmp_path) / f"{task}-{n}-{uuid.uuid4().hex[:8]}"
        self.work.mkdir(parents=True)
        self.deadline = time.monotonic() + timeout
        self.ctx = mp.start_processes(_entry, args=(n, str(self.work), task, payload),
                                      nprocs=n, join=False, start_method="spawn")

    def result(self) -> list:
        try:
            while not self.ctx.join(timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"the world of {self.n} ranks ({self.task}) did not "
                                       f"finish within {self.timeout} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(self.n):
            with open(self.work / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _entry(rank: int, n: int, work: str, task: str, payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{work}/store", n), rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=60))
    try:
        result = TASKS[task](payload)
        with open(f"{work}/rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


# --------------------------------------------------------------------------
# int8 cross-pod sum
# --------------------------------------------------------------------------

def int8_sum(payload) -> dict:
    """A (pod 2, data 4, model 1) mesh: each rank packs and sums its pod's
    partial of every leaf (``payload``: name -> ((n_pod, ...) float32
    partials, dtype name))."""
    from repro_torch.parallel.collectives import (_int8_pack, cross_pod_compressed_allreduce,
                                                  cross_pod_sum_partials)
    mesh = init_device_mesh("cpu", (2, 4, 1), mesh_dim_names=("pod", "data", "model"))
    flat = init_device_mesh("cpu", (dist.get_world_size(), 1), mesh_dim_names=("data", "model"))
    pod = mesh.get_local_rank("pod")
    out = {}
    for name, (parts, dtype) in payload.items():
        x = torch.as_tensor(parts[pod]).to(getattr(torch, dtype))
        q, scale = _int8_pack(x)
        summed = cross_pod_sum_partials({"x": x}, mesh)["x"]
        stacked = torch.as_tensor(parts.reshape(-1, *parts.shape[2:])).to(x.dtype)
        allreduced = cross_pod_compressed_allreduce([stacked], mesh)[0]
        untouched = cross_pod_sum_partials({"x": x}, flat)["x"]
        out[name] = {"q": q.numpy(), "scale": scale.numpy(), "sum": _np(summed),
                     "sum_dtype": str(summed.dtype), "allreduce": _np(allreduced),
                     "no_pod_is_identity": untouched is x}
    return out


# --------------------------------------------------------------------------
# Train steps
# --------------------------------------------------------------------------

def train_steps(cases) -> list:
    """One train step of each case (dict: cfg fields, weights, batch, mesh
    shape and names, style) on this rank's blocks and rows: the metrics,
    this rank's parameter and moment blocks with each leaf's sharded dim,
    the MoE routing of each call, and the collectives issued."""
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, moe, new_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding

    out = []
    for case in cases:
        mesh = init_device_mesh("cpu", case["mesh_shape"], mesh_dim_names=case["mesh_names"])
        cfg = ArchConfig(**case["cfg"])
        api = build_model(cfg, device="cpu")
        model = new_model(cfg, "cpu")
        model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
        with sharding.mesh_context(mesh, case["style"]):
            sharding.shard_params(model, mesh)
            opt = adamw_init(model)
            batch = {k: sharding.local_rows(torch.as_tensor(v), mesh)
                     for k, v in case["batch"].items()}
            sharding.reset_comm_counts()
            with moe.recording_routing() as log:
                model, opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(
                    model, opt, batch)
        named = dict(model.named_parameters())
        dims = {k: sharding.sharding_of(p).dim for k, p in named.items()}
        out.append({
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "tokens": float(met["tokens"]), "dims": dims,
            "params": {k: p.detach().numpy() for k, p in named.items()},
            "m": {k: t.numpy() for k, t in opt.m.items()},
            "v": {k: t.numpy() for k, t in opt.v.items()},
            "routing": [(i.numpy(), kept.numpy()) for i, kept in log],
            "comm": dict(sharding.comm_counts),
        })
    return out


def moe_dispatch(payload) -> dict:
    """``moe_ffn`` under a (world, 1) mesh on this rank's rows of x."""
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    cfg = ArchConfig(**payload["cfg"])
    mesh = make_host_mesh(device="cpu")
    with sharding.mesh_context(mesh):
        x = sharding.local_rows(torch.as_tensor(payload["x"]), mesh)
        with moe.recording_routing() as log:
            y = moe.moe_ffn(cfg, x, {k: torch.as_tensor(v) for k, v in payload["p"].items()})
    (idx, kept), = log
    return {"y": y.numpy(), "idx": idx.numpy(), "kept": kept.numpy(),
            "capacity": moe.capacity(cfg, x.shape[0] * x.shape[1])}


# --------------------------------------------------------------------------
# Tensor-parallel serving
# --------------------------------------------------------------------------

def tp_serving(cases) -> list:
    """Each case (dict: cfg fields, the JAX package's parameter tree as
    numpy, mesh shape, style, forward tokens (and patches or frames: an
    encoder-decoder's cache is filled by ``prefill_cross``), decode tokens,
    cache length, a hidden state) on a (data, model) mesh: the port's model
    from ``bridge.lm_params_from_numpy`` sharded by ``shard_params``; the
    rank's rows of the forward's and every decode step's logits (whole
    vocab), the collectives of each step, greedy tokens from
    ``make_serve_step``, the embedding rows and the logits of the given
    hidden state, each leaf's block and whether gathering every leaf gives
    the JAX tree back, and the same for ``init(seed, mesh=)`` against the
    unsharded draws."""
    from repro_torch import bridge
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model, encdec, moe, ssm, transformer
    from repro_torch.parallel import sharding

    out = []
    for case in cases:
        mesh = init_device_mesh("cpu", case["mesh_shape"], mesh_dim_names=("data", "model"))
        cfg = ArchConfig(**case["cfg"])
        api = build_model(cfg, device="cpu")
        model = bridge.lm_params_from_numpy(cfg, case["tree"], "cpu")
        flat = {k: np.asarray(v) for k, v in bridge._flat_names(case["tree"]).items()}
        rows = lambda a: sharding.local_rows(torch.as_tensor(a), mesh)  # noqa: E731
        res = {"comm": []}
        with sharding.mesh_context(mesh, case["style"]), torch.no_grad():
            sharding.shard_params(model, mesh)
            named = dict(model.named_parameters())
            res["blocks_are_local"] = all(
                np.array_equal(p.numpy(), np.asarray(sharding.sharding_of(p).local(flat[k])))
                for k, p in named.items())
            res["gather_is_identity"] = {
                k: bool(np.array_equal(sharding.sharding_of(p).gather(p).numpy(), flat[k]))
                for k, p in named.items()}
            res["tp_dims"] = {k: sharding.sharding_of(p).tp_dim for k, p in named.items()}
            drawn = api.init(3, mesh=mesh)
            res["init_blocks"] = {k: sharding.sharding_of(p).gather(p).numpy()
                                  for k, p in drawn.named_parameters()}
            del drawn
            batch = {k: rows(case[k]) for k in ("tokens", "patches", "frames") if k in case}

            def new_cache():
                cache = api.init_cache(case["tokens"].shape[0], case["max_len"])
                if "frames" in case:  # the cross-attention keys of each rank's block
                    cache = encdec.prefill_cross(cfg, model, batch["frames"], cache)
                return cache

            with moe.recording_routing() as log:
                res["forward"] = api.forward(model, batch).numpy()
            res["routing"] = [(i.numpy(), kept.numpy()) for i, kept in log]
            cache = new_cache()
            res["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()
                                   if isinstance(v, torch.Tensor)}
            res["cache_slots"] = {k: v for k, v in cache.items() if "slots" in k}
            steps = []
            for t in range(case["decode"].shape[1]):
                sharding.reset_comm_counts()
                logits, cache = api.decode_step(model, cache, rows(case["decode"][:, t:t + 1]))
                res["comm"].append({k: v for k, v in sharding.comm_counts.items()
                                    if not k.endswith("_bytes")})
                steps.append(logits.numpy())
            res["decode"] = np.stack(steps)
            step = make_serve_step(api)
            cache = new_cache()
            tok, greedy = rows(case["decode"][:, :1]), []
            for _ in range(case["decode"].shape[1]):
                tok, cache = step(model, cache, tok)
                greedy.append(tok.numpy())
            res["greedy"] = np.concatenate(greedy, axis=1)
            res["embed_rows"] = sharding.embed_rows(model.embed, rows(case["tokens"]),
                                                    torch.float32).numpy()
            hidden = rows(case["hidden"])
            res["head_logits"] = (ssm._logits(cfg, model, hidden) if cfg.family == "ssm"
                                  else transformer.logits_of(cfg, model, hidden)).numpy()
        out.append(res)
    return out


def split_decode(cases) -> list:
    """Each case (dict: cfg fields, the JAX package's parameter tree as
    numpy, mesh shape and names, style, decode tokens (B, steps) of a batch
    that does not divide over the data-parallel axes, cache length, an
    encoder-decoder's frames) on its mesh: the port's model from
    ``bridge.lm_params_from_numpy`` sharded by ``shard_params``, every rank
    decoding the whole batch; the cache's block shapes and slot keys, every
    teacher-forced step's logits and collectives, and the greedy tokens of
    ``make_serve_step``."""
    from repro_torch import bridge
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model, encdec
    from repro_torch.parallel import sharding

    out = []
    for case in cases:
        mesh = init_device_mesh("cpu", case["mesh_shape"], mesh_dim_names=case["mesh_names"])
        cfg = ArchConfig(**case["cfg"])
        api = build_model(cfg, device="cpu")
        model = bridge.lm_params_from_numpy(cfg, case["tree"], "cpu")
        tokens = torch.as_tensor(case["decode"])
        res = {}
        with sharding.mesh_context(mesh, case["style"]), torch.no_grad():
            sharding.shard_params(model, mesh)

            def new_cache():
                cache = api.init_cache(tokens.shape[0], case["max_len"])
                if "frames" in case:
                    cache = encdec.prefill_cross(cfg, model, torch.as_tensor(case["frames"]),
                                                 cache)
                return cache

            cache = new_cache()
            res["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()
                                   if isinstance(v, torch.Tensor)}
            res["cache_slots"] = {k: v for k, v in cache.items() if "slot" in k}
            steps, comm = [], []
            for t in range(tokens.shape[1]):
                sharding.reset_comm_counts()
                logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
                comm.append(dict(sharding.comm_counts))
                steps.append(logits.numpy())
            res["decode"], res["comm"] = np.stack(steps), comm
            step = make_serve_step(api)
            cache, tok, greedy = new_cache(), tokens[:, :1], []
            for _ in range(tokens.shape[1]):
                tok, cache = step(model, cache, tok)
                greedy.append(tok.numpy())
            res["greedy"] = np.concatenate(greedy, axis=1)
        out.append(res)
    return out


def tp_train(cases) -> list:
    """Each case (dict: cfg fields, the port's weights as numpy, the global
    batch, mesh shape, optional ``style`` (default tp), ``save`` /
    ``restore`` snapshot directory, ``forward`` / ``decode`` tokens) on a
    (data, model) mesh: the port's model sharded by ``shard_params``
    (restored from the snapshot's step 1 by ``restore_sharded``, then one
    step, where ``restore`` is set), one ``make_train_step`` on this rank's
    rows; the metrics, every leaf's parameters and moments gathered whole,
    this rank's blocks of the leaves (and of the fused leaves' parts) that
    every model rank holds whole, and the collectives of the step, of its
    forward (through the loss) apart (a snapshot of the state after it is
    written where ``save`` is set). Before the step, where given, the
    forward logits of this rank's rows of ``forward`` and
    (``tp_decode``) the decode logits of each teacher-forced step of
    ``decode`` with the collectives of each; under fsdp the refusals of a
    decode and of its cache."""
    from repro_torch import checkpoint
    from repro_torch.configs import ArchConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, new_model
    from repro_torch.optim import AdamWConfig, AdamWState, adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import sharding

    out = []
    for case in cases:
        mesh = init_device_mesh("cpu", case["mesh_shape"], mesh_dim_names=("data", "model"))
        cfg = ArchConfig(**case["cfg"])
        api = build_model(cfg, device="cpu")
        model = new_model(cfg, "cpu")
        model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
        res = {}
        with sharding.mesh_context(mesh, case.get("style", "tp")):
            sharding.shard_params(model, mesh)
            named = dict(model.named_parameters())
            shs = {k: sharding.sharding_of(p) for k, p in named.items()}
            if "forward" in case:
                res.update(_tp_serving_checks(api, model, case, mesh))
            opt = adamw_init(model)
            tree_sh = {"params": shs, "opt": AdamWState(step=None, m=shs, v=shs)}
            if case.get("restore"):
                tree, _ = checkpoint.restore_sharded(case["restore"], 1,
                                                     {"params": named, "opt": opt}, tree_sh)
                checkpoint.load_into({"params": named, "opt": opt}, tree)
            batch = {k: sharding.local_rows(torch.as_tensor(v), mesh)
                     for k, v in case["batch"].items()}
            forward = {}

            def loss(model, batch, _loss=api.loss):
                value = _loss(model, batch)
                forward.update(sharding.comm_counts)
                return value

            sharding.reset_comm_counts()
            model, opt, met = make_train_step(dataclasses.replace(api, loss=loss), AdamWConfig(),
                                              total_steps=10)(model, opt, batch)
            comm = dict(sharding.comm_counts)
            m_norm = float(global_norm(opt.m, shs))
            full = {key: {k: shs[k].gather(t).numpy() for k, t in tree.items()}
                    for key, tree in (("params", named), ("m", opt.m), ("v", opt.v))}
            if case.get("save"):
                checkpoint.save(case["save"], int(opt.step), {"params": named, "opt": opt},
                                shardings=tree_sh)

        def whole(t, sh):
            """The parts of this rank's block that every model rank holds."""
            if sh.tp_dim is None:
                return [t.detach().numpy()]
            return [t.detach().narrow(sh.tp_dim, lo, hi - lo).numpy()
                    for lo, hi in sh.tp_whole()]

        out.append({
            **res, "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "tokens": float(met["tokens"]), **full, "comm": comm,
            "comm_forward": {k: v for k, v in forward.items() if not k.endswith("_bytes")},
            "m_norm": m_norm, "dims": {k: sh.dim for k, sh in shs.items()},
            "tp_dims": {k: sh.tp_dim for k, sh in shs.items()},
            "replicated": {key: {k: whole(t, shs[k]) for k, t in tree.items()}
                           for key, tree in (("params", named), ("m", opt.m))},
        })
    return out


def _tp_serving_checks(api, model, case, mesh) -> dict:
    """The forward logits of this rank's rows of ``case["forward"]`` (and
    its patches or frames) and their collectives; with a ``decode``
    (tokens, cache length) pair, the logits of each teacher-forced decode
    step and its collectives, or under fsdp the refusals of the cache and
    of a decode step."""
    from repro_torch.models import encdec
    from repro_torch.parallel import sharding
    cfg = api.cfg
    rows = lambda a: sharding.local_rows(torch.as_tensor(a), mesh)  # noqa: E731
    batch = {k: rows(v) for k, v in case["forward"].items()}
    out = {}
    with torch.no_grad():
        sharding.reset_comm_counts()
        out["forward"] = api.forward(model, batch).numpy()
        out["forward_comm"] = {k: v for k, v in sharding.comm_counts.items()
                               if not k.endswith("_bytes")}
        if "decode" not in case:
            return out
        tokens, max_len = case["decode"]
        if sharding.current_style() == "fsdp":
            refused = {}
            for what, call in (("cache", lambda: api.init_cache(tokens.shape[0], max_len)),
                               ("decode", lambda: api.decode_step(model, {}, rows(tokens[:, :1])))):
                try:
                    call()
                    refused[what] = ""
                except NotImplementedError as exc:
                    refused[what] = str(exc)
            out["decode_refused"] = refused
            return out
        cache = api.init_cache(tokens.shape[0], max_len)
        if cfg.family == "encdec":
            cache = encdec.prefill_cross(cfg, model, batch["frames"], cache)
        steps, comm = [], []
        for t in range(tokens.shape[1]):
            sharding.reset_comm_counts()
            logits, cache = api.decode_step(model, cache, rows(tokens[:, t:t + 1]))
            comm.append({k: v for k, v in sharding.comm_counts.items() if not k.endswith("_bytes")})
            steps.append(logits.numpy())
        out["decode"], out["decode_comm"] = np.stack(steps), comm
    return out


def vocab_ce(cases) -> list:
    """``weighted_cross_entropy`` of this rank's vocab block of each case's
    logits (``vocab_parallel``; soft-capped first where ``cap`` is set) on
    a (1, world) mesh: the loss and the gradient of this rank's block."""
    from repro_torch.models import layers
    from repro_torch.parallel import sharding
    mesh = init_device_mesh("cpu", (1, dist.get_world_size()), mesh_dim_names=("data", "model"))
    r, n = mesh.get_local_rank("model"), dist.get_world_size()
    out = []
    with sharding.mesh_context(mesh, "tp"):
        for case in cases:
            full = torch.as_tensor(case["logits"])
            v = full.shape[-1] // n
            block = full[..., r * v:(r + 1) * v].clone().requires_grad_(True)
            logits = layers.softcap(block, case["cap"]) if case["cap"] else block
            loss, _ = layers.weighted_cross_entropy(
                logits, torch.as_tensor(case["labels"]), torch.as_tensor(case["weights"]),
                vocab_parallel=True)
            loss.backward()
            out.append({"loss": float(loss), "grad": block.grad.numpy()})
    return out


def serve_main(argvs) -> list:
    """``serve.main(argv)`` of each argv on this rank, its standard output
    captured."""
    from repro_torch.launch import serve
    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = serve.main(argv)
        out.append({"summary": summary, "stdout": buf.getvalue()})
    return out


# --------------------------------------------------------------------------
# Fleets
# --------------------------------------------------------------------------

def fleet_jobs(name: str):
    """K = 8 fleets at a small shape: homogeneous DS and L-DS (rates, costs,
    budgets and seeds differ per slice), and a ragged mixed-policy fleet
    under SWITCHED."""
    from repro_torch import core
    if name in ("ds", "l-ds"):
        base = core.CocktailConfig(n_cu=10, n_ec=4, eps=0.1, pair_iters=15, seed=7)
        spec = core.ALL_SPECS[name]
        return [core.SliceJob(dataclasses.replace(
            base, seed=7 + k, eps=0.1 + 0.02 * k, c_base=100.0 + 10.0 * k,
            f_base=tuple(16000.0 + 2000.0 * ((j + k) % 4) for j in range(4))), spec)
            for k in range(8)]
    base = core.CocktailConfig(n_cu=6, n_ec=3, eps=0.1, pair_iters=15, seed=7,
                               f_base=(8000.0, 20000.0, 12000.0))
    specs = ["ds", "l-ds", "no-sdc", "no-slt", "no-lsa", "greedy", "ecself", "cufull"]
    shapes = [(6, 3), (8, 4), (6, 3), (5, 2), (6, 3), (8, 4), (6, 3), (5, 2)]
    return [core.SliceJob(dataclasses.replace(base, n_cu=n, n_ec=m, seed=k,
                                              f_base=base.f_base[:m] + (9000.0,) * (m - 3)),
                          core.ALL_SPECS[s])
            for k, (s, (n, m)) in enumerate(zip(specs, shapes))]


def recording_decisions():
    """Patch ``datasche.stacked_step`` to log every slot's decision; yields
    the list."""
    from repro_torch.core import datasche
    log, step = [], datasche.stacked_step

    def logged(*args, **kw):
        out = step(*args, **kw)
        log.append(out[2])
        return out
    return log, mock.patch.object(datasche, "stacked_step", logged)


def fleet_result(state, recs, decisions) -> dict:
    from repro_torch import bridge
    return {"state": bridge.to_numpy(state), "recs": bridge.to_numpy(recs),
            "decisions": [bridge.to_numpy(d) for d in decisions]}


def fleets(payload) -> dict:
    """``FleetEngine.run(mesh=)`` of each named fleet over a (world, 1)
    mesh; a fleet whose K does not divide by the world raises."""
    from repro_torch import core
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    out = {}
    for name in payload["fleets"]:
        eng = core.FleetEngine.from_jobs(fleet_jobs(name), device="cpu")
        log, patch = recording_decisions()
        with patch:
            state, recs = eng.run(payload["slots"], mesh=mesh)
        out[name] = fleet_result(state, recs, log)
    odd = core.FleetEngine.from_jobs(fleet_jobs("ds")[:dist.get_world_size() + 1], device="cpu")
    try:
        odd.run(1, mesh=mesh)
        out["odd_k_raised"] = ""
    except ValueError as exc:
        out["odd_k_raised"] = str(exc)
    return out


# --------------------------------------------------------------------------
# train.main (elastic resume)
# --------------------------------------------------------------------------

def train_main(payload) -> dict:
    """``train.main(payload["argv"])`` with its standard output captured;
    with ``payload["snapshot"]`` (an npz path), the parameters and moments
    the run's first step receives are gathered whole and compared with the
    snapshot's arrays bit for bit."""
    from repro_torch.launch import train
    from repro_torch.parallel.sharding import sharding_of
    checks = {}
    make = train.make_train_step

    def checking(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(params, opt, batch):
            if not checks and payload.get("snapshot"):
                with np.load(payload["snapshot"]) as z:
                    for name, p in params.named_parameters():
                        key = name.replace(".", "/")
                        for prefix, t in ((f"params/{key}", p), (f"opt/.m/{key}", opt.m[name]),
                                          (f"opt/.v/{key}", opt.v[name])):
                            sh = sharding_of(p)
                            full = sh.gather(t) if sh is not None else t
                            checks[prefix] = bool(np.array_equal(full.detach().numpy(),
                                                                 z[prefix]))
                    checks["opt/.step"] = int(opt.step) == int(z["opt/.step"])
            return step(params, opt, batch)
        return run

    buf = io.StringIO()
    with mock.patch.object(train, "make_train_step", checking), contextlib.redirect_stdout(buf):
        summary = train.main(payload["argv"])
    return {"stdout": buf.getvalue(), "summary": summary, "restored_equal": checks}


def several(tasks) -> list:
    """Each (task, payload) of ``tasks`` in turn, in one world."""
    return [TASKS[task](payload) for task, payload in tasks]


TASKS = {"int8_sum": int8_sum, "train_steps": train_steps, "moe_dispatch": moe_dispatch,
         "fleets": fleets, "train_main": train_main, "several": several,
         "tp_serving": tp_serving, "serve_main": serve_main, "tp_train": tp_train,
         "vocab_ce": vocab_ce, "split_decode": split_decode}
