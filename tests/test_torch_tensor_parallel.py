"""Tensor-parallel serving of the port on a ``model`` axis above 1
(``parallel.sharding``, ``launch.specs``, the model families), held against
the port's unsharded run and the JAX package's.

  * Placements: ``cache_pspecs``, ``batch_pspecs`` / ``decode_pspecs`` and
    ``kv_layout`` equal the JAX package's for every arch on the meshes
    (1, 2), (1, 4), (2, 2) and (2, 16) in every style (the JAX rules take a
    duck mesh, as in ``test_torch_parallel.py``), over JAX's abstract
    shapes; the port's caches have JAX's leaves.
  * Serving runs in spawned gloo worlds (``tests/torch_dist_worlds.py``):
    reduced minitron-4b (kv heads on ``model`` at 2, slots at 4),
    granite-20b (MQA: slots), mixtral-8x7b (an 8-slot sliding-window ring:
    heads at 2, slots at 4), falcon-mamba-7b (Mamba-1, its fused
    ``in_proj``) and paligemma-3b (slots, a patch prefix), float32, with
    the JAX package's weights bridged, at (data, model) = (1, 2), (1, 4) and
    (2, 2) in the ``serve`` and ``tp`` styles. The forward's logits and ten
    teacher-forced decode steps' (the ring wraps) within 1e-5 of scale of
    the port's unsharded run and 1e-4 of JAX's unsharded ``forward`` /
    ``decode_step``; greedy tokens equal; the embedding rows and the
    gathered logits of one hidden state bit-equal; shard -> gather the
    identity for every leaf and ``init(seed, mesh=)`` the unsharded draws;
    the collectives of every decode step counted exactly.
  * The log-sum-exp merge of a slot-split cache on the plain route, windowed
    layers included, against the unsharded attention; the plain version of
    the decode kernel's ``lse`` output; ``serve.main --model-parallel 2``;
    the refusals of the styles a model axis above 1 does not run yet.
"""
from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402
from torch_dist_worlds import World  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.launch import serve, specs  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import build_model, moe, new_model, ssm, transformer  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

ARCHS = ["minitron-4b", "granite-20b", "mixtral-8x7b", "falcon-mamba-7b", "paligemma-3b"]
STYLES = ["tp", "tp_sp", "fsdp", "serve"]
SERVE_STYLES = ["serve", "tp"]
PLACEMENT_MESHES = [{"data": 1, "model": 2}, {"data": 1, "model": 4}, {"data": 2, "model": 2},
                    {"data": 2, "model": 16}]
# mesh name -> (world, (data, model))
MESHES = {"1x2": (2, (1, 2)), "1x4": (4, (1, 4)), "2x2": (4, (2, 2))}
RUNS = [(arch, mesh, style) for arch in ARCHS for mesh in MESHES for style in SERVE_STYLES]
B, S, STEPS, MAX_LEN = 4, 8, 10, 12


def _run_id(run) -> str:
    return "-".join(run)


def duck(sizes: dict):
    """A stand-in JAX mesh: what the JAX rules read, no devices."""
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=object))


def _within_scale(got, want, rel: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (what, err, scale)


# --------------------------------------------------------------------------
# Placements
# --------------------------------------------------------------------------

def _jax_cache(arch: str, gb: int, seq: int) -> dict:
    jm = j_build_model(j_get_config(arch))
    return jax.eval_shape(lambda: jm.init_cache(gb, seq))


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_pspecs_match_jax(arch, style):
    jcfg = j_get_config(arch)
    cfg = get_config(arch)
    for shape_name, (seq, gb, _) in SHAPES.items():
        cache = _jax_cache(arch, gb, seq)
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        for sizes in PLACEMENT_MESHES:
            with js.mesh_context(duck(sizes), style):
                mesh = js.current_mesh()
                want_cache = {k: tuple(v) for k, v in
                              j_specs.cache_pspecs(jcfg, cache, mesh, gb).items()}
                want_dec = j_specs.decode_pspecs(jcfg, cache, shape_name, mesh)
                want_batch = {kind: {k: tuple(v) for k, v in j_specs.batch_pspecs(
                    jcfg, shape_name, kind, mesh).items()} for kind in ("train", "prefill")}
                abstract = {kind: {k: tuple(v.shape) for k, v in j_specs.batch_abstract(
                    jcfg, shape_name, kind).items()} for kind in ("train", "prefill")}
            with sharding.mesh_context(sizes, style):
                assert specs.cache_pspecs(cfg, shapes, sizes, gb) == want_cache, (shape_name,
                                                                                 sizes)
                dec_cache, dec_tok = specs.decode_pspecs(cfg, shapes, gb, sizes)
                assert dec_cache == want_cache and dec_tok == tuple(want_dec[1])
                for kind in ("train", "prefill"):
                    assert specs.batch_pspecs(cfg, abstract[kind], sizes) == want_batch[kind]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_caches_hold_the_jax_leaves(arch):
    """The port's ``init_cache`` has JAX's leaf names and shapes, so
    ``cache_pspecs`` places both alike."""
    cfg = get_config(arch)
    cache = build_model(cfg, device="meta").init_cache(2, 16)
    want = {k: tuple(v.shape) for k, v in _jax_cache(arch, 2, 16).items()}
    assert {k: specs._shape(v) for k, v in cache.items()} == want


@pytest.mark.parametrize("style", STYLES)
def test_kv_layout_matches_jax(style):
    for sizes in PLACEMENT_MESHES:
        with js.mesh_context(duck(sizes), style):
            want = ([js.kv_layout(h) for h in range(1, 33)],
                    [js.dp_group_count(n) for n in range(1, 65)])
        with sharding.mesh_context(sizes, style):
            got = ([sharding.kv_layout(h) for h in range(1, 33)],
                   [sharding.dp_group_count(n) for n in range(1, 65)])
        assert got == want, sizes


@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-2.7b", "whisper-base"])
def test_pending_styles_raise_on_a_model_axis_above_one(arch):
    """On a model axis above 1 tp_sp and fsdp place every parameter as tp
    does (the rule table's 2-D blocks: only serve differs); the one path
    still refused is fsdp's decode cache, naming ``cache_pspecs``."""
    cfg = reduced(get_config(arch))
    model = new_model(cfg, "meta")
    sizes = {"data": 1, "model": 2}
    with sharding.mesh_context(sizes, "tp"):
        want = sharding.shard_params_pspecs(model, sizes)
    assert any("model" in spec for spec in want.values())
    for style in ("fsdp", "tp_sp"):
        with sharding.mesh_context(sizes, style):
            assert sharding.shard_params_pspecs(model, sizes) == want
            if style == "fsdp":
                with pytest.raises(NotImplementedError, match=r"fsdp style.*cache_pspecs"):
                    build_model(cfg, device="meta").init_cache(2, 16)


# --------------------------------------------------------------------------
# The log-sum-exp merge, plain route
# --------------------------------------------------------------------------

def _decode_inputs(seed: int, slots: int, window: int):
    """One decode query over a ring of ``slots`` (positions permuted, some
    empty) of reduced minitron-4b's attention (H 4, Hkv 2, hd 16)."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, 1, 4, 16)).astype(np.float32))
    k, v = (torch.as_tensor(rng.standard_normal((B, slots, 2, 16)).astype(np.float32))
            for _ in range(2))
    kp = np.stack([rng.permutation(slots) + 40 for _ in range(B)]).astype(np.int32)
    kp[rng.random(kp.shape) < 0.25] = -1
    kp[1, : slots // 2] = -1  # a batch row whose first half of the slots is empty
    qp = torch.full((B, 1), 40 + slots, dtype=torch.int32)
    kp = torch.as_tensor(kp)
    return q, k, v, qp, kp, ref.AttnSpec(window=window)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("ranks", [2, 4])
def test_seq_merge_equals_unsharded_attention(ranks, window):
    """Each rank's block of slots through the plain route with
    ``return_lse``, merged by ``transformer.merge_partials``: the unsharded
    attention at 1e-6 (a window of 6 leaves ranks with no visible key)."""
    q, k, v, qp, kp, spec = _decode_inputs(ranks + window, 16, window)
    want = ops.flash_attention(q, k, v, qp, kp, spec, kv_valid=kp >= 0)
    n = 16 // ranks
    parts = [ops.flash_attention(q, k[:, i:i + n], v[:, i:i + n], qp, kp[:, i:i + n], spec,
                                 kv_valid=kp[:, i:i + n] >= 0, return_lse=True)
             for i in range(0, 16, n)]
    if window:
        assert any(bool((lse == ref.NEG).any()) for _, lse in parts)
    got = transformer.merge_partials(torch.stack([o for o, _ in parts]),
                                     torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_lse_plain_version():
    """``attention_lse_ref``: the output of ``attention_ref`` and the
    log-sum-exp of each row's visible scaled logits; -1e30 and a zero row
    where a row sees no key; soft-capped logits capped first."""
    q, k, v, qp, kp, _ = _decode_inputs(7, 16, 0)
    kp[2] = -1  # a batch row that sees no key
    for spec in (ref.AttnSpec(), ref.AttnSpec(softcap=5.0)):
        out, lse = ops.flash_attention(q, k, v, qp, kp, spec, kv_valid=kp >= 0,
                                       return_lse=True)
        torch.testing.assert_close(out, ref.attention_ref(q, k, v, qp, kp, spec, kp >= 0),
                                   rtol=1e-6, atol=1e-6)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, dim=2)) / 4.0
        if spec.softcap:
            logits = spec.softcap * torch.tanh(logits / spec.softcap)
        logits = logits.masked_fill(~(kp >= 0)[:, None, None], -math.inf)
        want = torch.logsumexp(logits, dim=-1).permute(0, 2, 1)
        seen = torch.arange(B) != 2
        torch.testing.assert_close(lse[seen], want[seen], rtol=1e-6, atol=1e-6)
        assert bool((lse[2] == ref.NEG).all()) and bool((out[2] == 0).all())
        assert lse.dtype == torch.float32 and lse.shape == (B, 1, 4)


# --------------------------------------------------------------------------
# Serving in gloo worlds
# --------------------------------------------------------------------------

def _bridged(arch: str):
    jcfg = j_reduced(j_get_config(arch))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    return jcfg, jmodel, jax.tree.map(np.asarray, jparams), cfg


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32),
           "max_len": MAX_LEN,
           "hidden": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)
    return out


SERVE_ARGV = [["--arch", arch, "--reduced", "--device", "cpu", "--model-parallel", "2",
               "--prompt-len", "6", "--gen", "6"] for arch in ("minitron-4b", "granite-20b")]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every world at once: (1, 2) on 2 ranks, (1, 4) and (2, 2) on 4, and
    ``serve.main`` on 2."""
    tmp = tmp_path_factory.mktemp("tp_worlds")
    arch_data = {arch: _bridged(arch) for arch in ARCHS}
    inputs = {arch: _inputs(arch_data[arch][3]) for arch in ARCHS}

    def cases(mesh):
        return [{"cfg": dataclasses.asdict(arch_data[arch][3]), "tree": arch_data[arch][2],
                 "mesh_shape": MESHES[mesh][1], "style": style, **inputs[arch]}
                for arch in ARCHS for style in SERVE_STYLES]

    handles = {
        "1x2": World(2, "several", [("tp_serving", cases("1x2")),
                                    ("serve_main", SERVE_ARGV)], tmp, timeout=400),
        "4": World(4, "several", [("tp_serving", cases("1x4")), ("tp_serving", cases("2x2"))],
                   tmp, timeout=400),
    }
    return {"arch_data": arch_data, "inputs": inputs, "handles": handles}


def _port_reference(cfg, tree, inp) -> dict:
    api = build_model(cfg, device="cpu")
    model = bridge.lm_params_from_numpy(cfg, tree, "cpu")
    batch = {k: torch.as_tensor(inp[k]) for k in ("tokens", "patches") if k in inp}
    out = {}
    with torch.no_grad():
        with moe.recording_routing() as log:
            out["forward"] = api.forward(model, batch).numpy()
            out["forward_halves"] = np.concatenate([api.forward(model, {
                k: v[h:h + B // 2] for k, v in batch.items()}).numpy() for h in (0, B // 2)])
        out["dropped"] = sum(int((~kept).sum()) for _, kept in log)
        cache, steps = api.init_cache(B, MAX_LEN), []
        for t in range(STEPS):
            logits, cache = api.decode_step(model, cache, torch.as_tensor(inp["decode"][:, t:t + 1]))
            steps.append(logits.numpy())
        out["decode"] = np.stack(steps)
        step = make_serve_step(api)
        cache, tok, greedy = api.init_cache(B, MAX_LEN), torch.as_tensor(inp["decode"][:, :1]), []
        for _ in range(STEPS):
            tok, cache = step(model, cache, tok)
            greedy.append(tok.numpy())
        out["greedy"] = np.concatenate(greedy, axis=1)
        out["embed_rows"] = sharding.embed_rows(model.embed, torch.as_tensor(inp["tokens"]),
                                                torch.float32).numpy()
        head = ssm._logits if cfg.family == "ssm" else transformer.logits_of
        hidden = torch.as_tensor(inp["hidden"])
        out["head_logits"] = head(cfg, model, hidden).numpy()
        out["head_logits_halves"] = np.concatenate([
            head(cfg, model, hidden[h:h + B // 2]).numpy() for h in (0, B // 2)])
        out["init"] = {k: p.numpy() for k, p in api.init(3).named_parameters()}
    return out


def _jax_reference(jcfg, jmodel, jparams, inp) -> dict:
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "patches") if k in inp}
    fwd = jax.jit(jmodel.forward)
    out = {"forward": np.asarray(fwd(jparams, batch)),
           "forward_halves": np.concatenate([np.asarray(fwd(jparams, {
               k: v[h:h + B // 2] for k, v in batch.items()})) for h in (0, B // 2)])}
    step = jax.jit(jmodel.decode_step)
    cache, steps = jmodel.init_cache(B, MAX_LEN), []
    for t in range(STEPS):
        logits, cache = step(jparams, cache, jnp.asarray(inp["decode"][:, t:t + 1]))
        steps.append(np.asarray(logits))
    out["decode"] = np.stack(steps)
    return out


@pytest.fixture(scope="module")
def refs(launched):
    """arch -> {"port": unsharded port run, "jax": unsharded JAX run},
    computed while the worlds run."""
    out = {}
    for arch in ARCHS:
        jcfg, jmodel, jtree, cfg = launched["arch_data"][arch]
        inp = launched["inputs"][arch]
        out[arch] = {"port": _port_reference(cfg, jtree, inp),
                     "jax": _jax_reference(jcfg, jmodel, jax.tree.map(jnp.asarray, jtree), inp)}
    return out


@pytest.fixture(scope="module")
def worlds(launched, refs):
    """(arch, mesh, style) -> the ranks' results; "serve_main" -> the
    ranks' summaries."""
    out = {}
    pairs = [(arch, style) for arch in ARCHS for style in SERVE_STYLES]
    ranks2 = launched["handles"]["1x2"].result()
    ranks4 = launched["handles"]["4"].result()
    for i, (arch, style) in enumerate(pairs):
        out[(arch, "1x2", style)] = [r[0][i] for r in ranks2]
        out[(arch, "1x4", style)] = [r[0][i] for r in ranks4]
        out[(arch, "2x2", style)] = [r[1][i] for r in ranks4]
    out["serve_main"] = [r[1] for r in ranks2]
    return out


def _rows(rank: int, mesh: str) -> slice:
    data, model = MESHES[mesh][1]
    n = B // data
    d = rank // model
    return slice(d * n, (d + 1) * n)


def _per_rank(ref_run: dict, key: str, mesh: str) -> np.ndarray:
    """The reference of what a mesh's ranks compute on their rows: with two
    data ranks, each half of the batch on its own (the MoE routes each
    rank's rows as its own group, JAX's G = dp; a product over fewer rows
    may take another BLAS path)."""
    return ref_run[f"{key}_halves"] if MESHES[mesh][1][0] == 2 else ref_run[key]


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tp_logits_match_unsharded(worlds, refs, run):
    """Forward and every decode step within 1e-5 of scale of the port's
    unsharded run, on every rank's rows; greedy tokens equal."""
    arch, mesh, _ = run
    ref_port = refs[arch]["port"]
    if arch == "mixtral-8x7b":  # the capacity bound drops assignments in this forward
        assert ref_port["dropped"] > 0
    for rank, r in enumerate(worlds[run]):
        rows = _rows(rank, mesh)
        want = _per_rank(ref_port, "forward", mesh)[rows]
        assert r["forward"].shape == want.shape
        _within_scale(r["forward"], want, 1e-5, f"{run} forward")
        for t in range(STEPS):
            _within_scale(r["decode"][t], ref_port["decode"][t][rows], 1e-5, f"{run} step {t}")
        np.testing.assert_array_equal(r["greedy"], ref_port["greedy"][rows])


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tp_logits_match_jax(worlds, refs, run):
    """Forward and every decode step within 1e-4 of scale of JAX's
    unsharded ``forward`` / ``decode_step`` with the same weights."""
    arch, mesh, _ = run
    want = refs[arch]["jax"]
    for rank, r in enumerate(worlds[run]):
        rows = _rows(rank, mesh)
        _within_scale(r["forward"], _per_rank(want, "forward", mesh)[rows], 1e-4,
                      f"{run} forward")
        for t in range(STEPS):
            _within_scale(r["decode"][t], want["decode"][t][rows], 1e-4, f"{run} step {t}")


def _expected_comm(arch: str, mesh: str, style: str) -> dict:
    """Collectives of one decode step: 2 all-reduces a layer (wo / w_down,
    the MoE combine, x_proj / out_proj), 1 for the embedding rows, 1 logits
    gather; where the cache's slots are split (kv heads that do not divide
    over model), a q gather and the log-sum-exp merge a layer; in the tp
    style the FSDP gathers of the data shards (one a layer, the embedding,
    the head)."""
    cfg = reduced(get_config(arch))
    m = MESHES[mesh][1][1]
    seq = cfg.family != "ssm" and cfg.n_kv_heads % m != 0
    want = {"tp_all_reduce": 2 * cfg.n_layers + 1,
            "tp_all_gather": 1 + (2 * cfg.n_layers if seq else 0)}
    if style == "tp":
        want["all_gather"] = cfg.n_layers + 2
    return want


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_collectives_per_decode_step(worlds, run):
    arch, mesh, style = run
    want = _expected_comm(arch, mesh, style)
    cfg = reduced(get_config(arch))
    m = MESHES[mesh][1][1]
    for r in worlds[run]:
        assert all(c == want for c in r["comm"]), (r["comm"][0], want)
        if want["tp_all_gather"] > 1:  # slots split over model: each rank its block
            assert r["cache_slots"] == {"slots0": 8 if cfg.sliding_window else MAX_LEN}
            assert r["cache_shapes"]["k0"][2] == r["cache_slots"]["slots0"] // m
        elif cfg.family != "ssm":
            assert not r["cache_slots"] and r["cache_shapes"]["k0"][3] == cfg.n_kv_heads // m
        else:
            assert r["cache_shapes"]["h"][2] == cfg.d_inner // m


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_embedding_rows_and_gathered_logits_are_bit_equal(worlds, refs, run):
    """The masked local lookup summed over model is the unsharded lookup,
    and the head's vocab blocks gathered are the unsharded logits of the
    same hidden state, bit for bit."""
    arch, mesh, _ = run
    ref_port = refs[arch]["port"]
    for rank, r in enumerate(worlds[run]):
        rows = _rows(rank, mesh)
        np.testing.assert_array_equal(r["embed_rows"], ref_port["embed_rows"][rows])
        np.testing.assert_array_equal(r["head_logits"],
                                      _per_rank(ref_port, "head_logits", mesh)[rows])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_gather_and_sharded_init(worlds, refs, launched, arch, mesh):
    """Every leaf of the bridged JAX tree: each rank's block is
    ``Sharding.local`` of it and gathering the blocks gives it back (Mamba-1's
    ``in_proj`` as [x_r | z_r] blocks); ``init(3, mesh=)`` gathered is the
    unsharded ``init(3)``, bit for bit."""
    flat = bridge._flat_names(launched["arch_data"][arch][2])
    for style in SERVE_STYLES:
        for r in worlds[(arch, mesh, style)]:
            assert r["blocks_are_local"]
            assert set(r["gather_is_identity"]) == set(flat)
            assert all(r["gather_is_identity"].values()), [
                k for k, ok in r["gather_is_identity"].items() if not ok]
            for k, want in refs[arch]["port"]["init"].items():
                np.testing.assert_array_equal(r["init_blocks"][k], want, err_msg=k)
            on_model = {k for k, d in r["tp_dims"].items() if d is not None}
            assert "embed" in on_model
            assert ("blocks.in_proj" if arch == "falcon-mamba-7b" else "blocks.wq") in on_model


def test_serve_main_on_a_model_axis_of_two(worlds):
    """``serve.main --model-parallel 2`` on 2 ranks: the mesh in the summary,
    the unsharded run's greedy tokens, the collectives of a step, and the
    summary printed by rank 0 alone."""
    for i, argv in enumerate(SERVE_ARGV):
        ranks = [r[i] for r in worlds["serve_main"]]
        single = serve.main([a for a in argv if a not in ("--model-parallel", "2")])
        for r in ranks:
            s = r["summary"]
            assert s["mesh"] == {"data": 1, "model": 2}
            assert s["sample_tokens"] == single["sample_tokens"]
            assert s["collectives_per_step"]["tp_all_reduce"] == 2 * s["n_layers"] + 1
        assert ranks[0]["stdout"].strip() and not ranks[1]["stdout"].strip()
        assert single["mesh"] == {"data": 1, "model": 1}
