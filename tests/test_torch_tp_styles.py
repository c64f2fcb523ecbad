"""The port's ``tp_sp`` and ``fsdp`` styles on a ``model`` axis above 1,
held against the port's unsharded runs and the JAX package's
``make_train_step`` outside a mesh (both styles change where the data sits,
not what is computed).

  * One train step of each family in spawned gloo worlds
    (``tests/torch_dist_worlds.py``, task ``tp_train`` with a ``style``):
    reduced minitron-4b (dense), mixtral-8x7b (MoE), falcon-mamba-7b
    (Mamba-1), zamba2-2.7b (Mamba-2 + the shared block), whisper-base
    (encoder-decoder: ``tp_sp`` is ``tp`` there) and paligemma-3b (VLM),
    float32, at (data, model) = (1, 2) and (2, 2), minitron-4b also at
    (1, 4), in each style: the loss within 1e-5 relative and the grad norm,
    moments and parameters within 1e-5 of each leaf's scale of the
    unsharded step (``_hold``), and within 1e-4 of JAX's.
  * Every leaf that no rank holds a block of (the norms) comes out of the
    step bit-equal on every rank; the parts that every ``model`` rank holds
    whole (whole kv projections, Mamba-2's ``a_log``, ``gate_norm`` and the
    B / C columns of ``in_proj``) bit-equal across the ``model`` ranks of a
    data rank, their first moments (the clipped gradients) included.
  * ``adamw.global_norm`` of the ``fsdp`` ranks' stored moment blocks is
    the norm of the gathered moments: the norm needs nothing of the style.
  * Reduced minitron-4b's collectives of a step, forward and rest, counted
    exactly: the numbers of ``PERF.md`` (4 layers with remat, as phase 16
    runs it) and the 2-layer step at each mesh.
  * The forward of each rank's rows (each style) and 6 teacher-forced
    ``tp_sp`` decode steps (``tp``'s decode: one position) within 1e-5 of
    scale of the unsharded run; a decode and its cache under ``fsdp``
    raise, naming ``cache_pspecs``' duplicate ``model`` placement.
  * ``repro_torch.configs.SHAPES`` and ``LONG_CONTEXT_OK`` are the JAX
    package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import LONG_CONTEXT_OK as J_LONG_CONTEXT_OK  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from test_torch_distributed import _batch, _hold, _references, _within  # noqa: E402
from torch_dist_worlds import World  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ArchConfig, get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, encdec, new_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCHS = ["minitron-4b", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-2.7b", "whisper-base",
         "paligemma-3b"]
STYLES = ["tp_sp", "fsdp"]
# mesh name -> (world, (data, model))
MESHES = {"1x2": (2, (1, 2)), "2x2": (4, (2, 2)), "1x4": (4, (1, 4))}
RUNS = [(arch, style, mesh) for arch in ARCHS for style in STYLES for mesh in ("1x2", "2x2")] + \
    [("minitron-4b", style, "1x4") for style in STYLES]
# Reduced minitron-4b at phase 16's depth and remat, for the collective counts.
COUNTED = "minitron-4b-L4-remat"
COUNT_RUNS = [(COUNTED, style, "1x2") for style in ["tp"] + STYLES]
# Its step's collectives (forward through the loss, the rest), as PERF.md
# predicts them for phases 15-16's minitron-4b at 4 layers on (1, 2).
_TP = {"forward": {"tp_all_reduce": 12, "all_gather": 6, "all_reduce": 1},
       "rest": {"tp_all_reduce": 4, "all_gather": 4, "tp_copy_bwd": 9, "reduce_scatter": 6,
                "all_reduce": 6}}
PERF_COUNTS = {
    "tp": _TP,
    "tp_sp": {"forward": {**_TP["forward"], "seq_gather": 5},
              "rest": {**_TP["rest"], "seq_gather": 4, "seq_split_bwd": 5}},
    "fsdp": {"forward": {"all_gather": 6, "all_reduce": 2},
             "rest": {"all_gather": 4, "reduce_scatter": 6, "all_reduce": 10}},
}
TOL, JAX_TOL = 1e-5, 1e-4
# The first AdamW update is lr g / (|g| + eps): where the clipped gradient
# is within a few hundred eps of eps, it magnifies the gradient's last ulps
# (a zero-init bias moved 1.2e-8 where 1e-5 of its scale is 3e-9), so at
# 1e-5 the parameters are held where |g| is above 1e3 eps as well (phase
# 15's ``TP15_GRAD_FLOOR`` on the card); the moments are held everywhere.
GRAD_FLOOR = 1e-5
B1 = AdamWConfig.b1
B, S = 4, 8
DECODE_STEPS = 6


def _cfg(name: str) -> ArchConfig:
    if name == COUNTED:
        return dataclasses.replace(reduced(get_config("minitron-4b")), n_layers=4, remat=True)
    return reduced(get_config(name))


def _case(name: str) -> dict:
    """Reduced ``name``'s config fields, weights (the port's init from seed
    0), global train batch (patches for the VLM) and the forward's and
    decode's inputs, as numpy."""
    cfg = _cfg(name)
    model = build_model(cfg, device="cpu").init(0)
    batch = _batch(cfg)
    if cfg.family == "vlm":
        batch["patches"] = np.random.default_rng(8).standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    forward = {k: v for k, v in batch.items() if k in ("tokens", "patches", "frames")}
    decode = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, DECODE_STEPS))
    return {"cfg": dataclasses.asdict(cfg), "batch": batch, "forward": forward,
            "decode": (decode.astype(np.int32), DECODE_STEPS + 2),
            "weights": {k: v.numpy() for k, v in model.state_dict().items()}}


def _payload(cases: dict, runs) -> list:
    return [{**cases[name], "mesh_shape": MESHES[mesh][1], "style": style}
            for name, style, mesh in runs]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds at once (one thread a rank): (1, 2) on 2 ranks, (2, 2)
    and (1, 4) on 4."""
    tmp = tmp_path_factory.mktemp("tp_styles_worlds")
    cases = {name: _case(name) for name in ARCHS + [COUNTED]}
    two = [r for r in RUNS if r[2] == "1x2"] + COUNT_RUNS
    four = [r for r in RUNS if r[2] != "1x2"]
    handles = {runs: World(MESHES[runs[0][2]][0], "tp_train", _payload(cases, runs), tmp,
                           timeout=400) for runs in (tuple(two), tuple(four))}
    return {"cases": cases, "handles": handles}


def _unsharded_serving(case: dict) -> dict:
    """The port's unsharded forward logits of the case's forward inputs and
    its teacher-forced decode logits (B, steps, V)."""
    cfg = ArchConfig(**case["cfg"])
    api = build_model(cfg, device="cpu")
    model = new_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
    batch = {k: torch.as_tensor(v) for k, v in case["forward"].items()}
    tokens, max_len = case["decode"]
    with torch.no_grad():
        forward = api.forward(model, batch).numpy()
        cache = api.init_cache(B, max_len)
        if cfg.family == "encdec":
            cache = encdec.prefill_cross(cfg, model, batch["frames"], cache)
        steps = []
        for t in range(tokens.shape[1]):
            logits, cache = api.decode_step(model, cache, torch.as_tensor(tokens[:, t:t + 1]))
            steps.append(logits.numpy())
    return {"forward": forward, "decode": np.stack(steps)}


def _unsharded_step(case: dict) -> dict:
    """The port's unsharded train step of the case (``_references``'s
    port half, for a config the JAX package's ``reduced`` does not make)."""
    cfg = ArchConfig(**case["cfg"])
    api = build_model(cfg, device="cpu")
    model = new_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
    model, opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(
        model, adamw_init(model), {k: torch.as_tensor(v) for k, v in case["batch"].items()})
    return {"loss": float(met["loss"]), "tokens": float(met["tokens"]),
            "grad_norm": float(met["grad_norm"]),
            "params": {k: p.detach().numpy() for k, p in model.named_parameters()},
            "m": {k: t.numpy() for k, t in opt.m.items()},
            "v": {k: t.numpy() for k, t in opt.v.items()}}


@pytest.fixture(scope="module")
def refs(launched):
    """Computed while the worlds run: JAX's and the port's unsharded steps
    and the unsharded forward and decode of each arch; the port's step of
    the counted config."""
    cases = launched["cases"]
    out = {arch: {**_references(cases[arch]), **_unsharded_serving(cases[arch])}
           for arch in ARCHS}
    out[COUNTED] = {"port": _unsharded_step(cases[COUNTED]), "p0": cases[COUNTED]["weights"]}
    return out


@pytest.fixture(scope="module")
def worlds(launched, refs):
    """(name, style, mesh) -> the ranks' step results."""
    out = {}
    for runs, handle in launched["handles"].items():
        ranks = handle.result()
        for i, run in enumerate(runs):
            out[run] = [r[i] for r in ranks]
    return out


def _leaf_kinds(rank: dict) -> tuple[list, list]:
    """(the leaves that no rank holds a block of, the other leaves that
    every model rank holds whole or in part: a data shard, or whole parts
    of a model block)."""
    replicated = [k for k, d in rank["tp_dims"].items()
                  if d is None and rank["dims"][k] is None]
    whole = [k for k, parts in rank["replicated"]["m"].items()
             if parts and k not in replicated]
    return replicated, whole


def _floored(m: dict) -> dict:
    """First moments as ``_hold``'s gradient mask, zero where the clipped
    gradient m / (1 - b1) is not above ``GRAD_FLOOR``."""
    return {k: np.where(np.abs(v) > GRAD_FLOOR * (1.0 - B1), v, 0.0) for k, v in m.items()}


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_train_step_matches_unsharded_and_jax(worlds, refs, run):
    ranks = worlds[run]
    ref = refs[run[0]]
    got = {key: ranks[0][key] for key in ("loss", "tokens", "grad_norm", "params", "m", "v")}
    for r in ranks:  # every rank reports the global loss and norm
        assert (r["loss"], r["tokens"], r["grad_norm"]) == \
            (got["loss"], got["tokens"], got["grad_norm"])
    assert any(d is not None for d in ranks[0]["tp_dims"].values())
    grad = ref["jax"]["m"]  # after one step, m = (1 - b1) x the clipped gradient
    _hold(got, ref["port"], _floored(grad), ref["p0"], TOL, f"{run} vs unsharded")
    _hold(got, ref["jax"], grad, ref["p0"], JAX_TOL, f"{run} vs JAX")


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_replicated_leaves_are_bit_equal_across_ranks(worlds, run):
    """A leaf no rank holds a block of comes out of the step (its value and
    its first moment, so its clipped gradient) bit-equal on every rank; a
    data shard that is whole on model (whole kv projections beside a q
    block, the router), and a part every model rank holds whole, on the
    model ranks of a data rank; gathered leaves are the same on every
    rank."""
    model = MESHES[run[2]][1][1]
    ranks = worlds[run]
    replicated, whole = _leaf_kinds(ranks[0])
    assert replicated
    if run[0] == "zamba2-2.7b":
        assert {"blocks.a_log", "blocks.gate_norm"} <= set(replicated)
        assert "blocks.in_proj" in whole
    for rank, r in enumerate(ranks):
        peer = ranks[rank - rank % model]
        for key in ("params", "m"):
            for k in replicated:
                np.testing.assert_array_equal(r["replicated"][key][k][0],
                                              ranks[0]["replicated"][key][k][0],
                                              err_msg=f"{run} {key} {k} {rank}")
            for k in whole:
                for got, want in zip(r["replicated"][key][k], peer["replicated"][key][k]):
                    np.testing.assert_array_equal(got, want, err_msg=f"{run} {key} {k} {rank}")
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=f"{run} {k}")


@pytest.mark.parametrize("run", [r for r in RUNS if r[1] == "fsdp"], ids="-".join)
def test_global_norm_of_fsdp_blocks_is_the_gathered_norm(worlds, run):
    """``adamw.global_norm`` over the ranks' stored first-moment blocks
    (the rule table's 2-D blocks, fused parts and all) equals the norm of
    the gathered moments: the style changes nothing the norm reads."""
    ranks = worlds[run]
    want = np.sqrt(sum(float(np.sum(np.square(m.astype(np.float64))))
                       for m in ranks[0]["m"].values()))
    for r in ranks:
        assert abs(r["m_norm"] - want) <= 1e-6 * want, (run, r["m_norm"], want)


def _expected_comm(name: str, style: str, mesh: str) -> dict:
    """Reduced minitron-4b's collectives of one step, (forward through the
    loss, the rest), by kind. L layers, r = L under remat (the recompute
    reissues each layer's gathers and the g all-reduce after ``wo``), d x m
    the mesh; every style: L + 2 all-gathers forward (one a layer, the
    embedding's, the head's), r in the recompute, L + 2 reduce-scatters
    back. tp: 2L + 4 g (+ r) and 2L + 1 f (4L + 1 where the kv heads are
    whole beside a q block); all-reduces: the denominator (forward), the
    loss, 3 norms, the global norm's 2. tp_sp adds L + 1 carry gathers
    forward (+ r) and L + 1 split gathers back. fsdp: no tensor parallelism; a layer
    whose kv heads do not divide over model gathers them over data apart
    (one more gather and reduce-scatter a layer, their gradients summed over
    model after); every all-reduce over both axes."""
    cfg = _cfg(name)
    n, (d, m) = cfg.n_layers, MESHES[mesh][1]
    r = n if cfg.remat else 0
    kv_whole = cfg.n_kv_heads % m != 0
    if style in ("tp", "tp_sp"):
        fwd = {"tp_all_reduce": 2 * n + 4, "all_gather": n + 2, "all_reduce": 1}
        rest = {"tp_all_reduce": r, "all_gather": r,
                "tp_copy_bwd": (4 if kv_whole else 2) * n + 1,
                "reduce_scatter": n + 2, "all_reduce": 6}
        if style == "tp_sp":
            fwd["seq_gather"] = n + 1
            rest.update(seq_gather=r, seq_split_bwd=n + 1)
    else:
        per_layer = 2 if kv_whole else 1
        fwd = {"all_gather": per_layer * n + 2, "all_reduce": 2}
        rest = {"all_gather": per_layer * r, "reduce_scatter": per_layer * n + 2,
                "all_reduce": 2 * 3 + 2 + 2 + (2 if kv_whole else 0)}
    return {"forward": fwd, "rest": {k: v for k, v in rest.items() if v}}


@pytest.mark.parametrize("run", COUNT_RUNS + [r for r in RUNS if r[0] == "minitron-4b"],
                         ids="-".join)
def test_collectives_of_a_dense_train_step(worlds, refs, run):
    """Counted exactly on every rank (``_expected_comm``); the counted
    config's step holds the unsharded one."""
    want = _expected_comm(*run)
    if run[0] == COUNTED:
        assert want == PERF_COUNTS[run[1]]
    for r in worlds[run]:
        total = {k: v for k, v in r["comm"].items() if not k.endswith("_bytes")}
        fwd = r["comm_forward"]
        got = {"forward": fwd, "rest": {k: v - fwd.get(k, 0) for k, v in total.items()
                                        if v - fwd.get(k, 0)}}
        assert got == want, (run, got, want)
    if run[0] == COUNTED:
        ref = refs[COUNTED]
        _hold(worlds[run][0], ref["port"], _floored(ref["port"]["m"]), ref["p0"], TOL, f"{run}")


def _rows(x: np.ndarray, style: str, mesh: str, rank: int) -> np.ndarray:
    """The rows of rank ``rank``: over data under tp_sp, over data x model
    under fsdp."""
    d, m = MESHES[mesh][1]
    r, n = (rank, d * m) if style == "fsdp" else (rank // m, d)
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_forward_and_decode_hold_the_unsharded_run(worlds, refs, run):
    """Each rank's forward logits within 1e-5 of scale of the unsharded
    forward's rows (tp_sp: the carry a block of positions between layers,
    except whisper's); tp_sp's 6 teacher-forced decode steps as well, with
    no carry collective (one position); fsdp's decode and cache raise."""
    arch, style, mesh = run
    ref = refs[arch]
    family = ArchConfig(**ref["cfg"]).family
    for rank, r in enumerate(worlds[run]):
        _within(r["forward"], _rows(ref["forward"], style, mesh, rank), TOL,
                f"{run} forward {rank}")
        seq = "seq_gather" in r["forward_comm"]
        assert seq == (style == "tp_sp" and family != "encdec"), (run, r["forward_comm"])
        if style == "fsdp":
            assert not any(k.startswith("tp_") for k in r["forward_comm"]), r["forward_comm"]
            assert set(r["decode_refused"]) == {"cache", "decode"}
            for what, msg in r["decode_refused"].items():
                assert "cache_pspecs" in msg and "'model'" in msg, (run, what, msg)
        else:
            want = np.stack([_rows(step, style, mesh, rank) for step in ref["decode"]])
            _within(r["decode"], want, TOL, f"{run} decode {rank}")
            assert not any("seq_" in k for c in r["decode_comm"] for k in c), r["decode_comm"]


def test_configs_shapes_and_long_context_match_jax():
    assert configs.SHAPES == J_SHAPES
    assert configs.LONG_CONTEXT_OK == J_LONG_CONTEXT_OK
