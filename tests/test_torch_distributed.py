"""The port's distribution layer across ranks: worlds of 2, 4 and 8 gloo
processes on the CPU (``tests/torch_dist_worlds.py``: spawned, a FileStore
under tmp_path, a join timeout each), held against the port's unsharded
runs and the JAX package's.

  * int8 cross-pod sum, (pod 2, data 4): each rank's q and scale bit for bit
    the JAX ``_int8_pack`` of its pod's partial, the sum bit for bit the
    dequantised sum of JAX's ``leaf_sync``; without a ``pod`` axis the tree
    comes back as it is.
  * One train step on worlds of 2 and 4 ((data, model) meshes in the tp
    style; also fsdp at 2 and (pod 2, data 2) at 4): reduced minitron-4b in
    float32 and in bf16 with remat, reduced mixtral-8x7b and whisper-base,
    on one global batch from bridged weights, against the port's unsharded
    step and JAX's ``make_train_step`` outside a mesh, at
    ``tests/test_torch_train.py``'s tolerances (1e-5 relative on the loss,
    1e-4 of each leaf's scale in float32, 2e-2 in bf16: the ranks' bf16
    gradients meet in a bf16 sum). MoE: every rank dispatches its own
    tokens (JAX's shard-local groups, G = dp); the step is held against
    the unsharded one where no assignment drops on either side (checked),
    and the dispatch alone against JAX's ``moe_ffn`` once per group's rows
    on a skewed router that drops: the same capacity, experts and kept
    assignments.
  * Fleets of K = 8 over T = 3 slots on worlds of 2 and 4 (DS, L-DS, a
    ragged mixed-policy fleet under SWITCHED): every slot's decisions equal
    the unsharded run's, states and records within rtol 1e-6; a K that does
    not divide raises.
  * Elastic resume: ``train.main`` on reduced whisper-base trains 10 steps
    on 2 ranks (snapshots every 5), then resumes on 4 up to step 20; the
    parameters and moments its first step receives equal the snapshot's
    bit for bit, and the JAX package's ``checkpoint.restore`` reads it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.parallel import collectives as j_collectives  # noqa: E402
from torch_dist_worlds import (World, fleet_jobs, fleet_result,  # noqa: E402
                               recording_decisions)

from repro_torch import bridge, core  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import ArchConfig, get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, moe, new_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

WORLDS = (2, 4)
# name -> (arch, config changes, tolerance)
CASES = {
    "minitron-4b": ("minitron-4b", {}, 1e-4),
    "minitron-4b-bf16-remat": ("minitron-4b", {"compute_dtype": "bfloat16", "remat": True}, 2e-2),
    "mixtral-8x7b": ("mixtral-8x7b", {}, 1e-4),
    "whisper-base": ("whisper-base", {}, 1e-4),
}
# run name -> (case, world, mesh shape, mesh names, style)
RUNS = {f"{case}@{n}": (case, n, (n, 1), ("data", "model"), "tp")
        for n in WORLDS for case in CASES}
RUNS["minitron-4b@2-fsdp"] = ("minitron-4b", 2, (2, 1), ("data", "model"), "fsdp")
RUNS["minitron-4b@4-pod"] = ("minitron-4b", 4, (2, 2, 1), ("pod", "data", "model"), "tp")
FLEETS = ("ds", "l-ds", "mixed")
SLOTS = 3
B, S = 4, 8


def _batch(cfg) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, 3] = -1
    out = {"tokens": tokens, "labels": labels,
           "weights": np.array([1.3, 0.0, 0.7, 2.0], np.float32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


def _case(arch, changes) -> dict:
    """Reduced ``arch``'s config fields, weights (the port's init from seed
    0) and global batch, as numpy."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    model = build_model(cfg, device="cpu").init(0)
    return {"cfg": dataclasses.asdict(cfg), "batch": _batch(cfg),
            "weights": {k: v.numpy() for k, v in model.state_dict().items()}}


def _nested(flat: dict) -> dict:
    """port parameter names -> the JAX package's nested parameter tree."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _references(case: dict) -> dict:
    """The JAX step outside a mesh and the port's unsharded step, from the
    case's weights and batch."""
    cfg = ArchConfig(**case["cfg"])
    jcfg = dataclasses.replace(j_reduced(j_get_config(cfg.name)), compute_dtype=cfg.compute_dtype,
                               remat=cfg.remat)
    jmodel = j_build_model(jcfg)
    jparams = _nested(case["weights"])
    jbatch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    jnew, jopt, jmet = jax.jit(j_make_train_step(jmodel, JAdamWConfig(), total_steps=10))(
        jparams, j_adamw_init(jparams), jbatch)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    flat = bridge._flat_names
    api = build_model(cfg, device="cpu")
    model = new_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
    with moe.recording_routing() as log:
        model, opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(
            model, adamw_init(model), {k: torch.as_tensor(v) for k, v in case["batch"].items()})
    port = {"loss": float(met["loss"]), "tokens": float(met["tokens"]),
            "grad_norm": float(met["grad_norm"]),
            "params": {k: p.detach().numpy() for k, p in model.named_parameters()},
            "m": {k: t.numpy() for k, t in opt.m.items()},
            "v": {k: t.numpy() for k, t in opt.v.items()},
            "routing": [(i.numpy(), kept.numpy()) for i, kept in log]}
    jax_ref = {"loss": float(jmet["loss"]), "tokens": float(jmet["tokens"]),
               "grad_norm": float(jmet["grad_norm"]), "params": flat(host(jnew)),
               "m": flat(host(jopt.m)), "v": flat(host(jopt.v))}
    return {"cfg": case["cfg"], "p0": case["weights"], "port": port, "jax": jax_ref}


def _skewed_moe():
    """Reduced mixtral's MoE inputs whose router favours expert 0, at 16 x 16
    tokens: every rank of a world of 2 or 4 drops assignments."""
    cfg = j_reduced(j_get_config("mixtral-8x7b"))
    rng = np.random.default_rng(0)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    u = rng.standard_normal(d).astype(np.float32)  # a direction every token shares
    x = rng.standard_normal((16, 16, d)).astype(np.float32) + 0.5 * u
    router = rng.standard_normal((d, e)).astype(np.float32) * 0.1
    router[:, 0] += 0.5 * np.sign(u)
    p = {"router": router,
         "we_gate": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
         "we_up": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
         "we_down": rng.standard_normal((e, ff, d)).astype(np.float32) / np.sqrt(ff)}
    return cfg, x, p


INT8_PARTS = np.random.default_rng(11).standard_normal((2, 33, 17)).astype(np.float32)
INT8 = {"f32": (INT8_PARTS, "float32"), "bf16": (INT8_PARTS * 3, "bfloat16"),
        "tiny": (INT8_PARTS * 1e-4, "float32"),
        "zero_pod": (INT8_PARTS * np.array([0.0, 1.0], np.float32)[:, None, None], "float32")}


def _argv(ckpt, steps):
    return ["--arch", "whisper-base", "--reduced", "--device", "cpu", "--steps", str(steps),
            "--batch", "8", "--seq", "32", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "5", "--lr", "1e-3", "--log-every", "100"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every world of this file, started at once (each rank runs one
    thread): worlds of 2 and 4 for the train steps, the MoE dispatch and the
    fleets, 8 for the int8 sum, and the elastic resume's two in turn (a
    thread waits for the first)."""
    tmp = tmp_path_factory.mktemp("worlds")
    cases = {case: _case(arch, changes) for case, (arch, changes, _) in CASES.items()}
    jcfg, x, p = _skewed_moe()
    handles = {}
    for n in WORLDS:
        runs = [name for name, r in RUNS.items() if r[1] == n]
        payload = [{**cases[RUNS[name][0]], "mesh_shape": RUNS[name][2],
                    "mesh_names": RUNS[name][3], "style": RUNS[name][4]} for name in runs]
        handles[n] = (runs, World(n, "several", [
            ("train_steps", payload),
            ("moe_dispatch", {"cfg": dataclasses.asdict(jcfg), "x": x, "p": p}),
            ("fleets", {"fleets": FLEETS, "slots": SLOTS})], tmp, timeout=240))
    handles["int8"] = World(8, "int8_sum", INT8, tmp, timeout=240)
    handles["elastic"] = _POOL.submit(_elastic, tmp)
    return {"cases": cases, "handles": handles, "tmp": tmp}


_POOL = concurrent.futures.ThreadPoolExecutor(1)


def _elastic(tmp):
    """The elastic resume's two worlds in turn: 10 steps on 2 ranks, then
    on 4 up to step 20 from a copy of the step-10 snapshot."""
    ckpt = tmp / "ck"
    first = World(2, "train_main", {"argv": _argv(ckpt, 10)}, tmp, timeout=240).result()
    snapshot = tmp / "step_10.npz"
    shutil.copy(ckpt / "step_0000000010.npz", snapshot)
    second = World(4, "train_main", {"argv": _argv(ckpt, 20), "snapshot": str(snapshot)},
                   tmp, timeout=240).result()
    return {"ckpt": ckpt, "first": first, "second": second, "snapshot": snapshot}


@pytest.fixture(scope="module")
def refs(launched):
    """Computed while the worlds run."""
    return {case: _references(c) for case, c in launched["cases"].items()}


@pytest.fixture(scope="module")
def worlds(launched, refs):
    """world size -> {"train": run name -> rank results, "moe": ranks,
    "fleets": ranks}."""
    out = {}
    for n in WORLDS:
        runs, handle = launched["handles"][n]
        ranks = handle.result()
        out[n] = {"train": {name: [r[0][i] for r in ranks] for i, name in enumerate(runs)},
                  "moe": [r[1] for r in ranks], "fleets": [r[2] for r in ranks]}
    return out


# --------------------------------------------------------------------------
# int8 cross-pod sum
# --------------------------------------------------------------------------

def test_int8_cross_pod_sum_matches_jax(launched):
    ranks = launched["handles"]["int8"].result()
    for name, (parts, dtype) in INT8.items():
        jdt = jnp.dtype(dtype)
        packs = [j_collectives._int8_pack(jnp.asarray(parts[p], jdt)) for p in range(2)]
        qs = jnp.stack([q for q, _ in packs])
        ss = jnp.stack([s for _, s in packs])
        deq = qs.astype(jnp.float32) * ss.reshape((-1,) + (1,) * (parts.ndim - 1))
        want = np.asarray(jnp.sum(deq, axis=0).astype(jdt).astype(jnp.float32))
        for rank, r in enumerate(ranks):
            got = r[name]
            pod = rank // 4
            np.testing.assert_array_equal(got["q"], np.asarray(packs[pod][0]), err_msg=name)
            np.testing.assert_array_equal(got["scale"], np.asarray(packs[pod][1]), err_msg=name)
            np.testing.assert_array_equal(got["sum"], want, err_msg=name)
            np.testing.assert_array_equal(got["allreduce"], want, err_msg=name)
            assert got["sum_dtype"] == f"torch.{dtype}"
            assert got["no_pod_is_identity"]


# --------------------------------------------------------------------------
# Train steps
# --------------------------------------------------------------------------

def _assemble(ranks: list, key: str, mesh_shape) -> dict[str, np.ndarray]:
    """The global leaves from the ranks' blocks: the data ranks of the first
    pod in order, concatenated along each leaf's sharded dim; every other
    rank must hold the same blocks as its data peer."""
    n_data = mesh_shape[-2]
    out = {}
    for name, dim in ranks[0]["dims"].items():
        blocks = [r[key][name] for r in ranks[:n_data]]
        out[name] = blocks[0] if dim is None else np.concatenate(blocks, axis=dim)
        for i, r in enumerate(ranks):
            want = blocks[i % n_data] if dim is not None else blocks[0]
            np.testing.assert_array_equal(r[key][name], want, err_msg=f"{key} {name} rank {i}")
    return out


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = float(np.abs(got - want).max()), float(max(np.abs(want).max(), 1e-30))
    assert err <= tol * scale, (what, err, scale)


def _hold(got, ref, grad, p0, tol, what):
    """test_torch_train's rule: the loss within 1e-5 relative (tol in
    bf16), the grad norm, m and sqrt(v) within tol of each leaf's scale, the
    parameters where |g| is above tol of its largest (``grad``: name -> a
    multiple of each leaf's gradient), sign flips of an update only below
    it and on at most 2 % of a leaf."""
    rel = 1e-5 if tol <= 1e-4 else tol
    assert abs(got["loss"] - ref["loss"]) <= rel * abs(ref["loss"]), (what, got["loss"], ref["loss"])
    assert abs(got["tokens"] - ref["tokens"]) <= 1e-6 * ref["tokens"], what  # a sum in another order
    _within(got["grad_norm"], ref["grad_norm"], tol, f"{what} grad_norm")
    for k in ref["m"]:
        _within(got["m"][k], ref["m"][k], tol, f"{what} m {k}")
        _within(np.sqrt(got["v"][k]), np.sqrt(ref["v"][k]), tol, f"{what} v {k}")
        g = np.abs(grad[k])
        above = g > tol * g.max()
        p, want = got["params"][k], ref["params"][k]
        err = np.abs(p.astype(np.float64) - want)[above]
        assert err.size == 0 or err.max() <= tol * np.abs(want).max(), (what, k)
        flips = np.sign(p - p0[k]) != np.sign(want - p0[k])
        assert not (flips & above).any(), (what, k)
        assert flips.sum() <= 0.02 * flips.size, (what, k, int(flips.sum()))


@pytest.mark.parametrize("run", list(RUNS))
def test_train_step_matches_unsharded_and_jax(worlds, refs, run):
    case, n, mesh_shape, _, _ = RUNS[run]
    ranks = worlds[n]["train"][run]
    ref = refs[case]
    tol = CASES[case][2]
    got = {"loss": ranks[0]["loss"], "tokens": ranks[0]["tokens"],
           "grad_norm": ranks[0]["grad_norm"],
           **{key: _assemble(ranks, key, mesh_shape) for key in ("params", "m", "v")}}
    for r in ranks:  # every rank reports the global loss and norm
        assert (r["loss"], r["tokens"], r["grad_norm"]) == \
            (got["loss"], got["tokens"], got["grad_norm"])
    assert any(d is not None for d in ranks[0]["dims"].values())
    grad = ref["jax"]["m"]  # after one step, m = (1 - b1) x the clipped gradient
    _hold(got, ref["port"], grad, ref["p0"], tol, f"{run} vs unsharded")
    _hold(got, ref["jax"], grad, ref["p0"], tol, f"{run} vs JAX")


@pytest.mark.parametrize("n", WORLDS)
def test_moe_train_step_dispatches_each_ranks_tokens(worlds, refs, n):
    """Each rank routes its own B / n rows; no assignment drops on either
    side at this batch, so the sharded step is the unsharded function."""
    ranks = worlds[n]["train"][f"mixtral-8x7b@{n}"]
    cfg = ArchConfig(**refs["mixtral-8x7b"]["cfg"])
    whole = refs["mixtral-8x7b"]["port"]["routing"]
    assert len(whole) == cfg.n_layers and all(kept.all() for _, kept in whole)
    for rank, r in enumerate(ranks):
        assert len(r["routing"]) == cfg.n_layers
        for (idx, kept), (widx, _) in zip(r["routing"], whole):
            t = idx.shape[0]
            assert t == B * S // n and kept.all()
            np.testing.assert_array_equal(idx, widx[rank * t:(rank + 1) * t])


@pytest.mark.parametrize("n", WORLDS)
def test_moe_dispatch_per_rank_matches_jax_per_group(worlds, n):
    jcfg, x, p = _skewed_moe()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rows = x.shape[0] // n
    dropped = 0
    for g, r in enumerate(worlds[n]["moe"]):
        xg = x[g * rows:(g + 1) * rows]
        t = xg.shape[0] * xg.shape[1]
        assert r["capacity"] == j_moe.capacity(jcfg, t)
        probs = jax.nn.softmax(jnp.asarray(xg).reshape(t, -1) @ jp["router"], axis=-1)
        _, jidx = jax.lax.top_k(probs, jcfg.n_experts_per_tok)
        onehot = jax.nn.one_hot(jidx.reshape(-1), jcfg.n_experts, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
        jkept = np.asarray(pos < r["capacity"]).reshape(t, -1)
        np.testing.assert_array_equal(r["idx"], np.asarray(jidx))
        np.testing.assert_array_equal(r["kept"], jkept)
        want = np.asarray(j_moe.moe_ffn(jcfg, jnp.asarray(xg), jp))
        _within(r["y"], want, 1e-5, f"moe rank {g}")
        dropped += int((~jkept).sum())
        assert (~jkept).any(), g  # the capacity bound is exercised on every rank
    assert dropped > 0


# --------------------------------------------------------------------------
# Fleets
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded_fleets():
    out = {}
    for name in FLEETS:
        eng = core.FleetEngine.from_jobs(fleet_jobs(name), device="cpu")
        log, patch = recording_decisions()
        with patch:
            state, recs = eng.run(SLOTS)
        out[name] = fleet_result(state, recs, log)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("name", FLEETS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_fleet_matches_unsharded(worlds, unsharded_fleets, n, name):
    want = unsharded_fleets[name]
    ranks = [r[name] for r in worlds[n]["fleets"]]
    for r in ranks:  # every rank returns the whole (K, ...) state and (T, K) records
        for key in ("state", "recs"):
            for (path, got), (_, ref) in zip(_leaves(r[key]), _leaves(want[key])):
                assert got.shape == ref.shape, (key, path)
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=f"{key}{path}")
    assert len(want["decisions"]) == SLOTS
    for t in range(SLOTS):
        for path, ref in _leaves(want["decisions"][t]):
            got = np.concatenate([dict(_leaves(r["decisions"][t]))[path] for r in ranks])
            np.testing.assert_array_equal(got, ref, err_msg=f"slot {t} decision{path}")


@pytest.mark.parametrize("n", WORLDS)
def test_fleet_k_that_does_not_divide_raises(worlds, n):
    for r in worlds[n]["fleets"]:
        assert f"{n + 1} slices do not divide over the {n} ranks" in r["odd_k_raised"]


# --------------------------------------------------------------------------
# Elastic resume: 2 ranks -> 4 ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elastic(launched):
    return launched["handles"]["elastic"].result()


def test_elastic_first_run_trains_on_two_ranks(elastic):
    s = elastic["first"][0]["summary"]
    assert s["world"] == 2 and s["n_ec"] == 2 and len(s["losses"]) == 10
    assert all(np.isfinite(s["losses"]))
    assert [r["summary"] for r in elastic["first"][1:]] == [None]  # rank 0 alone returns it


def test_elastic_resume_on_four_ranks(elastic):
    out = elastic["second"][0]
    assert "resumed from step 10" in out["stdout"]
    assert all("resumed" not in r["stdout"] for r in elastic["second"][1:])  # rank 0 prints
    s = out["summary"]
    assert s["world"] == 4 and s["n_ec"] == 4 and s["start_step"] == 10
    assert len(s["losses"]) == 10 and all(np.isfinite(s["losses"]))
    assert latest_step(elastic["ckpt"]) == 20


def test_elastic_restore_is_bit_exact(elastic):
    for r in elastic["second"]:
        checks = r["restored_equal"]
        assert checks and all(checks.values()), {k: v for k, v in checks.items() if not v}
        assert any(k.startswith("opt/.m/") for k in checks)


def test_jax_reads_the_elastic_snapshot(elastic):
    jcfg = j_reduced(j_get_config("whisper-base"))
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    template = {"params": jparams, "opt": j_adamw_init(jparams)}
    tree, meta = j_restore(elastic["ckpt"], 20, template)
    assert meta == {"arch": jcfg.name, "step": 20}
    with np.load(elastic["ckpt"] / "step_0000000020.npz") as z:
        np.testing.assert_array_equal(np.asarray(tree["params"]["embed"]), z["params/embed"])
        np.testing.assert_array_equal(np.asarray(tree["opt"].v["dec_blocks"]["wq"]),
                                      z["opt/.v/dec_blocks/wq"])
    assert int(tree["opt"].step) == 20
