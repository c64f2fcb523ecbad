"""Decode caches whose slots split over the data-parallel axes: a global
batch below dp (long_500k's batch of 1), where the JAX package's
``cache_pspecs`` puts a kv leaf's slots on the batch axes (and on ``model``
after them where the kv heads do not divide over it) and every data rank
decodes the whole batch.

Each (mesh, style) runs in a spawned gloo world (``tests/torch_dist_worlds.py``,
task ``split_decode``) at B 1, float32, with the JAX package's reduced
weights bridged, on (data, model) = (2, 1) and (2, 2) and (pod, data, model)
= (2, 1, 2), in the ``serve`` and ``tp`` styles:

  * minitron-4b (kv heads on ``model``, slots on the data axes),
    granite-20b (one kv head: slots on data x model, q gathered over
    ``model``), gemma2-27b (an 8-slot window ring beside a global layer:
    ring ownership across data ranks), mixtral-8x7b (MoE: every data rank
    routes the whole batch), zamba2-2.7b (the hybrid's shared attention),
    whisper-base (self- and cross-attention caches, the encoder's frames
    split over the data axes by ``prefill_cross``) and paligemma-3b (VLM);
    the dense family also on (2, 1, 2);
  * ten teacher-forced decode steps (the ring wraps) within 1e-5 of scale of
    the port's unsharded decode and 1e-4 of the JAX package's unsharded
    ``decode_step``; greedy tokens of ``make_serve_step`` equal to the
    unsharded run's; each rank's cache block and its slot keys;
  * the collectives of every step counted: one merge all-gather an
    attention over the slot axes (``slot_all_gather``), a q gather an
    attention where ``model`` splits the slots, and the tensor-parallel
    all-reduces and logits gather of a ``model`` axis above 1;
  * ``serve.main --batch 1`` on a (2, 1) world gives the unsharded run's
    tokens.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from test_torch_tensor_parallel import _bridged, _within_scale  # noqa: E402
from torch_dist_worlds import World  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402

ARCHS = ["minitron-4b", "granite-20b", "gemma2-27b", "mixtral-8x7b", "zamba2-2.7b",
         "whisper-base", "paligemma-3b"]
DENSE = ["minitron-4b", "granite-20b", "gemma2-27b"]
STYLES = ["serve", "tp"]
# mesh name -> (world, shape, axis names)
MESHES = {"2x1": (2, (2, 1), ("data", "model")), "2x2": (4, (2, 2), ("data", "model")),
          "2x1x2": (4, (2, 1, 2), ("pod", "data", "model"))}
RUNS = [(arch, mesh, style) for mesh in MESHES for arch in (DENSE if mesh == "2x1x2" else ARCHS)
        for style in STYLES]
B, STEPS, MAX_LEN = 1, 10, 12
SERVE_ARGV = ["--arch", "minitron-4b", "--reduced", "--device", "cpu", "--batch", "1",
              "--prompt-len", "6", "--gen", "6"]


def _run_id(run) -> str:
    return "-".join(run)


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(17)
    out = {"decode": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32),
           "max_len": MAX_LEN}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds at once: (2, 1) and ``serve.main --batch 1`` on 2 ranks,
    (2, 2) and (2, 1, 2) on 4."""
    tmp = tmp_path_factory.mktemp("split_decode_worlds")
    arch_data = {arch: _bridged(arch) for arch in ARCHS}
    inputs = {arch: _inputs(arch_data[arch][3]) for arch in ARCHS}

    def cases(mesh):
        _, shape, names = MESHES[mesh]
        return [{"cfg": dataclasses.asdict(arch_data[arch][3]), "tree": arch_data[arch][2],
                 "mesh_shape": shape, "mesh_names": names, "style": style, **inputs[arch]}
                for arch, m, style in RUNS if m == mesh]

    handles = {
        2: World(2, "several", [("split_decode", cases("2x1")),
                                ("serve_main", [SERVE_ARGV])], tmp, timeout=400),
        4: World(4, "several", [("split_decode", cases("2x2")),
                                ("split_decode", cases("2x1x2"))], tmp, timeout=400),
    }
    return {"arch_data": arch_data, "inputs": inputs, "handles": handles}


def _new_cache(cfg, api, model, inp):
    cache = api.init_cache(B, MAX_LEN)
    if cfg.family == "encdec":
        cache = encdec.prefill_cross(cfg, model, torch.as_tensor(inp["frames"]), cache)
    return cache


def _port_reference(cfg, tree, inp) -> dict:
    api = build_model(cfg, device="cpu")
    model = bridge.lm_params_from_numpy(cfg, tree, "cpu")
    tokens = torch.as_tensor(inp["decode"])
    with torch.no_grad():
        cache, steps = _new_cache(cfg, api, model, inp), []
        for t in range(STEPS):
            logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
            steps.append(logits.numpy())
        step = make_serve_step(api)
        cache, tok, greedy = _new_cache(cfg, api, model, inp), tokens[:, :1], []
        for _ in range(STEPS):
            tok, cache = step(model, cache, tok)
            greedy.append(tok.numpy())
    return {"decode": np.stack(steps), "greedy": np.concatenate(greedy, axis=1)}


def _jax_reference(jcfg, jmodel, jparams, inp) -> np.ndarray:
    cache = jmodel.init_cache(B, MAX_LEN)
    if jcfg.family == "encdec":
        cache = jencdec.prefill_cross(jcfg, jparams, jnp.asarray(inp["frames"]), cache)
    step, steps = jax.jit(jmodel.decode_step), []
    for t in range(STEPS):
        logits, cache = step(jparams, cache, jnp.asarray(inp["decode"][:, t:t + 1]))
        steps.append(np.asarray(logits))
    return np.stack(steps)


@pytest.fixture(scope="module")
def refs(launched):
    """arch -> {"port": unsharded port run, "jax": unsharded JAX decode},
    computed while the worlds run."""
    out = {}
    for arch in ARCHS:
        jcfg, jmodel, jtree, cfg = launched["arch_data"][arch]
        inp = launched["inputs"][arch]
        jparams = jax.tree.map(jnp.asarray, jtree)
        out[arch] = {"port": _port_reference(cfg, jtree, inp),
                     "jax": _jax_reference(jcfg, jmodel, jparams, inp)}
    return out


@pytest.fixture(scope="module")
def worlds(launched, refs):
    """(arch, mesh, style) -> the ranks' results; "serve_main" -> the ranks'
    summaries."""
    ranks = {n: h.result() for n, h in launched["handles"].items()}
    out = {"serve_main": [r[1][0] for r in ranks[2]]}
    for mesh, (world, _, _) in MESHES.items():
        runs = [run for run in RUNS if run[1] == mesh]
        part = 1 if mesh == "2x1x2" else 0
        for i, run in enumerate(runs):
            out[run] = [r[part][i] for r in ranks[world]]
    return out


def _slot_axes(cfg, mesh: str) -> tuple[str, ...]:
    """The axes a kv leaf's slots split over at B 1: the data axes, then
    ``model`` where it is above 1 and the kv heads do not divide over it."""
    _, shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    axes = tuple(a for a in names if a != "model")
    heads_fit = cfg.n_kv_heads % sizes["model"] == 0 and cfg.n_kv_heads >= sizes["model"]
    return axes if heads_fit else axes + ("model",)


def _attentions(cfg) -> int:
    """Attentions over a split cache in one decode step."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers


def _expected_comm(cfg, mesh: str) -> dict:
    """The tensor-parallel and slot-merge collectives of one decode step:
    a merge an attention; on a ``model`` axis above 1 a q gather an
    attention where ``model`` splits the slots, the logits gather, the
    embedding rows' all-reduce and two all-reduces a layer (three a whisper
    decoder layer, two more an application of the hybrid's shared block)."""
    n = _attentions(cfg)
    out = {"slot_all_gather": n}
    if dict(zip(MESHES[mesh][2], MESHES[mesh][1]))["model"] > 1:
        reduces = 3 * cfg.n_layers if cfg.family == "encdec" else 2 * cfg.n_layers
        if cfg.family == "hybrid":
            reduces += 2 * n
        out["tp_all_reduce"] = reduces + 1
        out["tp_all_gather"] = 1 + (n if "model" in _slot_axes(cfg, mesh) else 0)
    return out


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_split_decode_matches_unsharded(run, worlds, refs, launched):
    arch, mesh, style = run
    cfg = launched["arch_data"][arch][3]
    ref = refs[arch]
    axes = _slot_axes(cfg, mesh)
    sizes = dict(zip(MESHES[mesh][2], MESHES[mesh][1]))
    split = int(np.prod([sizes[a] for a in axes]))
    for rank, r in enumerate(worlds[run]):
        what = f"{arch} {mesh} {style} rank {rank}"
        _within_scale(r["decode"], ref["port"]["decode"], 1e-5, f"{what}: port decode")
        _within_scale(r["decode"], ref["jax"], 1e-4, f"{what}: JAX decode")
        assert np.array_equal(r["greedy"], ref["port"]["greedy"]), what
        for leaf, shape in r["cache_shapes"].items():
            key = re.fullmatch(r"((?:attn|cross)_)?k(\d*)", leaf)
            if key is None:
                continue
            pre, i = key.group(1) or "", key.group(2)
            assert r["cache_slots"][f"{pre}slot_axes{i}"] == axes, (what, leaf)
            assert shape[1] == B and shape[2] * split == r["cache_slots"][f"{pre}slots{i}"], \
                (what, leaf)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_split_decode_collectives(run, worlds, launched):
    """Every step's collectives: exactly those of ``_expected_comm``; the
    ``tp`` style's gathers of ZeRO-sharded weights beside them."""
    arch, mesh, style = run
    cfg = launched["arch_data"][arch][3]
    want = _expected_comm(cfg, mesh)
    for rank, r in enumerate(worlds[run]):
        for t, comm in enumerate(r["comm"]):
            counts = {k: v for k, v in comm.items() if not k.endswith("_bytes")}
            if style == "tp":
                counts.pop("all_gather", None)
            assert counts == want, (arch, mesh, style, rank, t)


def test_serve_main_batch_one_on_a_data_axis_of_two(worlds):
    """``serve.main --batch 1`` on 2 ranks (mesh (2, 1)): every rank serves
    the whole batch, the unsharded run's greedy tokens, one merge a layer."""
    single = serve.main(SERVE_ARGV)
    for r in worlds["serve_main"]:
        s = r["summary"]
        assert s["mesh"] == {"data": 2, "model": 1}
        assert s["sample_tokens"] == single["sample_tokens"]
        assert s["collectives_per_step"] == {"slot_all_gather": s["n_layers"]}
