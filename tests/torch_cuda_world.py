"""One rank of the port's two-card check, started by ``torchrun``:

    PYTHONPATH=src torchrun --standalone --nproc_per_node 2 tests/torch_cuda_world.py OUT.json [CASE ...]

CASE names what runs (default: train_f32, train_bf16_remat, fleet,
cross_pod, tp; ``tp_train``, ``tp_sp_train`` and ``fsdp_train`` are the
train step on a model axis of 2 in the tp, tp_sp and fsdp styles).

Over a (2, 1) NCCL mesh (``make_host_mesh``, ``cuda:LOCAL_RANK``): one train
step of reduced minitron-4b (float32, and bf16 with remat) on sharded
weights, each rank on its rows, against the unsharded step on rank 0's card
(loss 1e-5 relative, parameters and moments 1e-4 of each leaf's scale in
float32, 2e-2 in bf16); a DS fleet of K = 8 at 256 x 16 over 3 slots against
``run()`` (decisions' records and states within rtol 1e-6); the int8
cross-pod sum over a (pod 2, data 1, model 1) mesh against both pods' packs
dequantised and summed in pod order, bit for bit; tensor-parallel serving
over a (1, 2) mesh: minitron-4b at full width (bf16 weights from seed 0,
float32 compute), six teacher-forced decode steps against the unsharded
run on rank 0's card (1e-4 of scale, greedy tokens equal), with the
collectives a step; one train step over a (1, 2) mesh in the tp, tp_sp
(sequence-sharded layer carries) or fsdp (whole-layer gathers over data x
model) style: minitron-4b at full width cut to 4 layers, float32, B 4 x
128, each rank holding its blocks against the unsharded step on its own
card (``chip_smoke.hold_train_blocks``: the loss 1e-5 relative, grad norm,
moments and updated parameters 1e-4 of each leaf's scale). Rank 0 writes
what it measured to OUT.json; any failure raises, so the rank exits
non-zero. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import bridge, core
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import local_device, make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import collectives, sharding


def _scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def train_case(mesh, dev, changes: dict, tol: float) -> dict:
    cfg = dataclasses.replace(reduced(get_config("minitron-4b")), **changes)
    api = build_model(cfg, device=dev)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev),
             "weights": torch.tensor([1.3, 0.0, 0.7, 2.0], device=dev)}
    step = make_train_step(api, AdamWConfig(), total_steps=10)
    model = sharding.shard_params(api.init(0), mesh)
    opt = adamw_init(model)
    with sharding.mesh_context(mesh):
        local = {k: sharding.local_rows(v, mesh) for k, v in batch.items()}
        sharding.reset_comm_counts()
        model, opt, met = step(model, opt, local)
    named = dict(model.named_parameters())
    full = {k: sharding.sharding_of(p).gather(p) for k, p in named.items()}
    full_m = {k: sharding.sharding_of(named[k]).gather(t) for k, t in opt.m.items()}
    full_v = {k: sharding.sharding_of(named[k]).gather(t) for k, t in opt.v.items()}
    out = {"loss": float(met["loss"]), "collectives": dict(sharding.comm_counts)}
    if dist.get_rank() == 0:
        ref = api.init(0)
        ref_opt = adamw_init(ref)
        ref, ref_opt, ref_met = step(ref, ref_opt, batch)
        rel = abs(out["loss"] - float(ref_met["loss"])) / abs(float(ref_met["loss"]))
        worst = {"params": 0.0, "m": 0.0, "v_root": 0.0}
        for k, p in ref.named_parameters():
            worst["params"] = max(worst["params"], _scale_err(full[k], p.detach()))
            worst["m"] = max(worst["m"], _scale_err(full_m[k], ref_opt.m[k]))
            worst["v_root"] = max(worst["v_root"],
                                  _scale_err(full_v[k].sqrt(), ref_opt.v[k].sqrt()))
        if rel > (1e-5 if tol <= 1e-4 else tol) or max(worst.values()) > tol:
            raise AssertionError(f"train step {changes}: loss {rel:.3e} relative, {worst}")
        out.update(loss_rel_err=rel, err_of_leaf_scale=worst)
    return out


def fleet_case(mesh, dev) -> dict:
    base = core.CocktailConfig(n_cu=256, n_ec=16, eps=0.1, pair_iters=30, seed=0)
    cfgs = [dataclasses.replace(base, seed=s, eps=0.1 + 0.02 * (s % 3)) for s in range(8)]
    eng = core.FleetEngine.from_configs(cfgs, core.DS, device=dev)
    state, recs = eng.run(3, mesh=mesh)
    out = {"k": 8, "slots": 3}
    if dist.get_rank() == 0:
        ref_state, ref_recs = eng.run(3)
        for got, want in ((state, ref_state), (recs, ref_recs)):
            for path, a in _leaves(bridge.to_numpy(got)):
                b = dict(_leaves(bridge.to_numpy(want)))[path]
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=path)
        out["within_rtol_1e-6"] = True
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


def cross_pod_case(dev) -> dict:
    pod_mesh = init_device_mesh("cuda", (2, 1, 1), mesh_dim_names=("pod", "data", "model"))
    parts = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 1024, 512))
                            .astype(np.float32), device=dev)
    pod = pod_mesh.get_local_rank("pod")
    got = collectives.cross_pod_sum_partials({"g": parts[pod]}, pod_mesh)["g"]
    packs = [collectives._int8_pack(parts[p]) for p in range(2)]
    want = torch.sum(torch.stack([q.float() * s for q, s in packs]), dim=0)
    if not torch.equal(got, want):
        raise AssertionError("cross-pod sum over two pods is not the packs' dequantised sum")
    return {"bit_equal": True}


def tp_case(dev) -> dict:
    cfg = dataclasses.replace(get_config("minitron-4b"), compute_dtype="float32")
    mesh = make_host_mesh(model_parallel=2)
    api = build_model(cfg, device=dev)
    steps = 6
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, steps)),
                             dtype=torch.int32, device=dev)

    def decode(model):
        cache, out = api.init_cache(4, steps + 2), []
        for t in range(steps):
            logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
            out.append(logits[:, 0].float())
        return torch.stack(out, dim=1)

    with sharding.mesh_context(mesh, "serve"):
        sharding.reset_comm_counts()
        got = decode(api.init(0, dtype=torch.bfloat16, mesh=mesh))
        comm = {k: v / steps for k, v in sharding.comm_counts.items() if k.startswith("tp_")}
    out = {"collectives_per_step": comm}
    want_comm = {"tp_all_reduce": 2 * cfg.n_layers + 1, "tp_all_gather": 1}
    if {k: v for k, v in comm.items() if not k.endswith("_bytes")} != want_comm:
        raise AssertionError(f"tensor-parallel decode: collectives a step {comm}")
    if dist.get_rank() == 0:
        want = decode(api.init(0, dtype=torch.bfloat16))
        err = _scale_err(got, want)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if err > 1e-4 or agree != 1.0:
            raise AssertionError(f"tensor-parallel decode: {err:.3e} of scale from one card, "
                                 f"argmax agreement {agree}")
        out.update(err_of_scale=err, argmax_agreement=agree)
    return out


def tp_train_case(dev, style: str = "tp") -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch import models
    cfg = dataclasses.replace(get_config("minitron-4b"), n_layers=4, compute_dtype="float32")
    mesh = make_host_mesh(model_parallel=2)
    api = build_model(cfg, device=dev)
    batch = chip_smoke.tp15_batch(torch, cfg, dev)
    with sharding.mesh_context(mesh, style):
        model = api.init(0, mesh=mesh)
        opt = adamw_init(model)
        local = {k: sharding.local_rows(v, mesh) for k, v in batch.items()}
        sharding.reset_comm_counts()
        model, opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(model, opt, local)
        comm = {k: v for k, v in sharding.comm_counts.items() if not k.endswith("_bytes")}
    shardings = {k: sharding.sharding_of(p) for k, p in model.named_parameters()}
    worst = chip_smoke.hold_train_blocks(torch, models, api, batch, model, opt, met, shardings)
    return {"loss": float(met["loss"]), "loss_rel_err": worst["loss_rel"], "collectives": comm,
            "err_of_leaf_scale": max(worst[k] for k in ("grad_norm_rel", "m", "v_root",
                                                        "params"))}


CASES = {
    "train_f32": lambda mesh, dev: train_case(mesh, dev, {}, 1e-4),
    "train_bf16_remat": lambda mesh, dev: train_case(
        mesh, dev, {"compute_dtype": "bfloat16", "remat": True}, 2e-2),
    "fleet": fleet_case, "cross_pod": lambda mesh, dev: cross_pod_case(dev),
    "tp": lambda mesh, dev: tp_case(dev),
    **{f"{style}_train": lambda mesh, dev, style=style: tp_train_case(dev, style)
       for style in ("tp", "tp_sp", "fsdp")},
}


def main(out_path: str, cases=("train_f32", "train_bf16_remat", "fleet", "cross_pod", "tp")
         ) -> None:
    mesh = make_host_mesh()
    dev = local_device(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"world": dist.get_world_size(), "backend": str(dist.get_backend()),
              "device": torch.cuda.get_device_name(dev)}
    for name in cases:
        result[name] = CASES[name](mesh, dev)
    dist.barrier()
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], *([tuple(sys.argv[2:])] if len(sys.argv) > 2 else []))
