"""The port's train step on a ``model`` axis above 1 (the ``tp`` style):
Megatron's f / g pair in every family's forward, the vocab-parallel
cross-entropy, the global norm over ``model`` and the checkpoint on a
(data, model) mesh, held against the port's unsharded step and the JAX
package's ``make_train_step`` outside a mesh.

  * One step of each family in spawned gloo worlds
    (``tests/torch_dist_worlds.py``, task ``tp_train``): reduced minitron-4b
    (dense), mixtral-8x7b (MoE), falcon-mamba-7b (Mamba-1), zamba2-2.7b
    (Mamba-2 + the shared block), whisper-base (encoder-decoder) and
    paligemma-3b (VLM, MQA), float32, at (data, model) = (1, 2) and (2, 2),
    minitron-4b also at (1, 4) (whole kv heads beside a q block), on one
    global batch from the port's init: the loss, grad norm, every gathered
    parameter and moment by ``tests/test_torch_distributed.py``'s rule
    (``_hold``: 1e-5 relative on the loss, 1e-4 of each leaf's scale).
  * Every leaf that the ``model`` ranks hold whole (norms, routers, whole
    kv projections, ``a_log``, ``gate_norm``, Mamba-2's B and C columns of
    ``in_proj``) comes out of the step bit-equal on every ``model`` rank,
    its first moment (the clipped gradient) included; every rank reports the
    same global loss; minitron-4b's collectives of the step counted exactly
    (g forward, f backward, the cross-entropy's three).
  * The vocab-parallel cross-entropy (``vocab_ce``) against the gathered
    one, in value (1e-6 relative) and gradient (1e-5 of scale), with and
    without gemma2's soft-cap.
  * A snapshot written at (1, 2) restores at (2, 2) (``restore_sharded``)
    and at (1, 1), and either run's next step equals the uninterrupted
    unsharded run's within 1e-4 of each leaf's scale; the JAX package's
    ``checkpoint.restore`` reads the snapshot.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from test_torch_distributed import _batch, _hold, _references, _within  # noqa: E402
from torch_dist_worlds import World  # noqa: E402

from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs import ArchConfig, get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, new_model  # noqa: E402
from repro_torch.models.layers import softcap, weighted_cross_entropy  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCHS = ["minitron-4b", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b", "whisper-base",
         "paligemma-3b"]
# mesh name -> (world, (data, model))
MESHES = {"1x2": (2, (1, 2)), "2x2": (4, (2, 2)), "1x4": (4, (1, 4))}
RUNS = [(arch, mesh) for arch in ARCHS for mesh in ("1x2", "2x2")] + [("minitron-4b", "1x4")]
TOL = 1e-4
B, S = 4, 8
VOCAB = 128  # the reduced vocabulary
CE_CASES = {"plain": 0.0, "softcap": 30.0}


def _case(arch: str) -> dict:
    """Reduced ``arch``'s config fields, weights (the port's init from seed
    0) and global batch (patches for the VLM), as numpy."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu").init(0)
    batch = _batch(cfg)
    if cfg.family == "vlm":
        batch["patches"] = np.random.default_rng(8).standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return {"cfg": dataclasses.asdict(cfg), "batch": batch,
            "weights": {k: v.numpy() for k, v in model.state_dict().items()}}


def _ce_inputs() -> list:
    rng = np.random.default_rng(21)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int64)
    labels[1, 2:5] = -1
    return [{"logits": (rng.standard_normal((B, S, VOCAB)) * 20).astype(np.float32),
             "labels": labels, "weights": np.array([1.3, 0.0, 0.7, 2.0], np.float32),
             "cap": cap} for cap in CE_CASES.values()]


def _payload(cases: dict, mesh: str, **extra) -> list:
    return [{**cases[arch], "mesh_shape": MESHES[mesh][1], **extra.get(arch, {})}
            for arch, m in RUNS if m == mesh]


def _resumed(tmp, cases: dict):
    """Step 1 of minitron-4b at (1, 2), snapshot written; then, from the
    snapshot, step 2 at (2, 2)."""
    ckpt = tmp / "ck"
    first = World(2, "tp_train", [{**cases["minitron-4b"], "mesh_shape": (1, 2),
                                   "save": str(ckpt)}], tmp, timeout=240).result()
    second = World(4, "tp_train", [{**cases["minitron-4b"], "mesh_shape": (2, 2),
                                    "restore": str(ckpt)}], tmp, timeout=240).result()
    return {"ckpt": ckpt, "first": first, "second": second}


_POOL = concurrent.futures.ThreadPoolExecutor(1)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every world at once (one thread a rank): (1, 2) on 2 ranks, (2, 2)
    and (1, 4) on 4, and the snapshot's two worlds in turn."""
    tmp = tmp_path_factory.mktemp("tp_train_worlds")
    cases = {arch: _case(arch) for arch in ARCHS}
    ce = _ce_inputs()
    handles = {
        2: World(2, "several", [("tp_train", _payload(cases, "1x2")), ("vocab_ce", ce)],
                 tmp, timeout=400),
        4: World(4, "several", [("tp_train", _payload(cases, "2x2")),
                                ("tp_train", _payload(cases, "1x4")), ("vocab_ce", ce)],
                 tmp, timeout=400),
        "resumed": _POOL.submit(_resumed, tmp, cases),
    }
    return {"cases": cases, "ce": ce, "handles": handles}


@pytest.fixture(scope="module")
def refs(launched):
    """Computed while the worlds run."""
    return {arch: _references(case) for arch, case in launched["cases"].items()}


@pytest.fixture(scope="module")
def worlds(launched, refs):
    """(arch, mesh) -> the ranks' step results; "ce" -> world size -> the
    ranks' cross-entropy results."""
    ranks2 = launched["handles"][2].result()
    ranks4 = launched["handles"][4].result()
    out = {"ce": {2: [r[1] for r in ranks2], 4: [r[2] for r in ranks4]}}
    for i, (arch, _) in enumerate(r for r in RUNS if r[1] == "1x2"):
        out[(arch, "1x2")] = [r[0][i] for r in ranks2]
    for i, (arch, _) in enumerate(r for r in RUNS if r[1] == "2x2"):
        out[(arch, "2x2")] = [r[0][i] for r in ranks4]
    out[("minitron-4b", "1x4")] = [r[1][0] for r in ranks4]
    return out


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_tp_train_step_matches_unsharded_and_jax(worlds, refs, run):
    ranks = worlds[run]
    ref = refs[run[0]]
    got = {key: ranks[0][key] for key in ("loss", "tokens", "grad_norm", "params", "m", "v")}
    for r in ranks:  # every rank reports the global loss and norm
        assert (r["loss"], r["tokens"], r["grad_norm"]) == \
            (got["loss"], got["tokens"], got["grad_norm"])
    assert any(d is not None for d in ranks[0]["tp_dims"].values())
    grad = ref["jax"]["m"]  # after one step, m = (1 - b1) x the clipped gradient
    _hold(got, ref["port"], grad, ref["p0"], TOL, f"{run} vs unsharded")
    _hold(got, ref["jax"], grad, ref["p0"], TOL, f"{run} vs JAX")


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_replicated_leaves_are_bit_equal_across_model_ranks(worlds, run):
    """Each leaf (or part of a fused leaf) that every model rank holds whole
    comes out of the step bit-equal on the model ranks of a data rank: its
    updated value and its first moment, so its gradient. Gathered leaves
    are the same on every rank."""
    model = MESHES[run[1]][1][1]
    ranks = worlds[run]
    whole = [k for k, parts in ranks[0]["replicated"]["m"].items() if parts]
    assert whole
    if run[0] == "zamba2-2.7b":
        assert {"blocks.a_log", "blocks.gate_norm", "blocks.in_proj"} <= set(whole)
    for rank, r in enumerate(ranks):
        peer = ranks[rank - rank % model]
        for key in ("params", "m"):
            for k in whole:
                for got, want in zip(r["replicated"][key][k], peer["replicated"][key][k]):
                    np.testing.assert_array_equal(got, want, err_msg=f"{run} {key} {k} {rank}")
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=f"{run} {k}")


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_collectives_of_a_dense_train_step(worlds, mesh):
    """Reduced minitron-4b: g forward after wo and w_down (2 a layer), the
    embedding rows (1) and the cross-entropy's max, sum and label logit
    (3); f backward before each column-parallel product (2 a layer, 4 where
    the kv heads are whole beside the q block: q's input, k's and v's
    products) and the head (1). Nothing is gathered over model."""
    cfg = reduced(get_config("minitron-4b"))
    kv_whole = cfg.n_kv_heads % MESHES[mesh][1][1] != 0
    per_layer = 4 if kv_whole else 2
    for r in worlds[("minitron-4b", mesh)]:
        c = r["comm"]
        assert c["tp_all_reduce"] == 2 * cfg.n_layers + 4, c
        assert c["tp_copy_bwd"] == per_layer * cfg.n_layers + 1, c
        assert "tp_all_gather" not in c


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CE_CASES))
def test_vocab_parallel_cross_entropy(worlds, launched, world, case):
    """Each rank's vocab block (soft-capped in place where set) through the
    vocab-parallel CE: the loss of the gathered logits within 1e-6, and the
    gradient of each rank's block that of the gathered CE's, within 1e-5 of
    scale (the softmax divided by the summed exponentials, where the
    gathered CE's backward takes exp(x - lse): a few float32 ulps)."""
    inp = launched["ce"][list(CE_CASES).index(case)]
    full = torch.as_tensor(inp["logits"]).requires_grad_(True)
    logits = softcap(full, inp["cap"]) if inp["cap"] else full
    loss, _ = weighted_cross_entropy(logits, torch.as_tensor(inp["labels"]),
                                     torch.as_tensor(inp["weights"]))
    loss.backward()
    loss = float(loss.detach())
    v = VOCAB // world
    for r, got in enumerate(worlds["ce"][world]):
        got = got[list(CE_CASES).index(case)]
        assert abs(got["loss"] - loss) <= 1e-6 * abs(loss), (got["loss"], loss)
        _within(got["grad"], full.grad[..., r * v:(r + 1) * v].numpy(), 1e-5, f"{case} grad {r}")


def _two_unsharded_steps(case: dict, restored=None):
    """The port's unsharded steps 1 and 2 on the case's batch, or step 2
    alone from ``restored`` (a host tree of params and opt)."""
    cfg = ArchConfig(**case["cfg"])
    api = build_model(cfg, device="cpu")
    model = new_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
    opt = adamw_init(model)
    step = make_train_step(api, AdamWConfig(), total_steps=10)
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    if restored is None:
        model, opt, _ = step(model, opt, batch)
    else:
        checkpoint.load_into({"params": dict(model.named_parameters()), "opt": opt}, restored)
    model, opt, met = step(model, opt, batch)
    return {"loss": float(met["loss"]),
            "params": {k: p.detach().numpy() for k, p in model.named_parameters()},
            "m": {k: t.numpy() for k, t in opt.m.items()},
            "v": {k: t.numpy() for k, t in opt.v.items()}}


def _same_state(got: dict, want: dict, what: str) -> None:
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (what, got["loss"])
    for k in want["m"]:
        for key in ("params", "m"):
            _within(got[key][k], want[key][k], TOL, f"{what} {key} {k}")
        _within(np.sqrt(got["v"][k]), np.sqrt(want["v"][k]), TOL, f"{what} v {k}")


def test_snapshot_from_a_model_axis_resumes_at_other_meshes(launched):
    """Written at (1, 2) after step 1, the snapshot holds the global arrays:
    restored at (2, 2) by ``restore_sharded`` and unsharded (1, 1) by
    ``restore``, step 2 equals the uninterrupted unsharded run's step 2;
    the JAX package reads it."""
    res = launched["handles"]["resumed"].result()
    case = launched["cases"]["minitron-4b"]
    want = _two_unsharded_steps(case)
    assert checkpoint.latest_step(res["ckpt"]) == 1
    for (r,) in res["second"]:
        _same_state(r, want, "restored at (2, 2)")
    cfg = ArchConfig(**case["cfg"])
    model = new_model(cfg, "meta")
    template = {"params": {k: np.zeros(p.shape, np.float32) for k, p in model.named_parameters()}}
    template["opt"] = adamw_init({k: torch.zeros(v.shape) for k, v in template["params"].items()})
    host, _ = checkpoint.restore(res["ckpt"], 1, template)
    _same_state(_two_unsharded_steps(case, host), want, "restored at (1, 1)")
    jparams = j_build_model(j_reduced(j_get_config("minitron-4b"))).init(jax.random.PRNGKey(0))
    jtree, _ = j_restore(res["ckpt"], 1, {"params": jparams, "opt": j_adamw_init(jparams)})
    np.testing.assert_array_equal(np.asarray(jtree["params"]["blocks"]["wq"]),
                                  host["params"]["blocks.wq"])
    assert int(jtree["opt"].step) == 1
