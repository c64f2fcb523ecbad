"""Tensor-parallel serving of the hybrid (zamba2-2.7b: Mamba-2 layers and a
shared attention block) and encoder-decoder (whisper-base) families on a
``model`` axis above 1, held against the port's unsharded run and the JAX
package's.

Each (mesh, style) runs in a spawned gloo world (``tests/torch_dist_worlds.py``,
task ``tp_serving``): reduced zamba2-2.7b (4 Mamba-2 layers, the shared
block after every 2: kv heads on ``model`` at 2, slots at 4) and reduced
whisper-base (2 + 2 layers; self- and cross-attention caches by kv heads
at 2, by slots at 4, filled by ``prefill_cross``), float32, with the JAX
package's weights bridged, at (data, model) = (1, 2), (1, 4) and (2, 2) in
the ``serve`` and ``tp`` styles:

  * the forward's logits and ten teacher-forced decode steps' within 1e-5
    of scale of the port's unsharded run and 1e-4 of JAX's unsharded
    ``forward`` / ``decode_step`` (``prefill_cross`` on both sides), greedy
    tokens equal;
  * shard -> gather the identity for every leaf, Mamba-2's fused
    ``in_proj`` held as ``[z_r | x_r | B | C | dt_r]`` (parts of unequal
    sizes, B and C whole on every rank), and ``init(seed, mesh=)`` the
    unsharded draws;
  * the collectives of every decode step counted exactly, the gated
    RMSNorm's all-reduce a Mamba-2 layer included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from test_torch_tensor_parallel import _bridged, _within_scale  # noqa: E402
from torch_dist_worlds import World  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import build_model, encdec, transformer  # noqa: E402

ARCHS = ["zamba2-2.7b", "whisper-base"]
STYLES = ["serve", "tp"]
# mesh name -> (world, (data, model))
MESHES = {"1x2": (2, (1, 2)), "1x4": (4, (1, 4)), "2x2": (4, (2, 2))}
RUNS = [(arch, mesh, style) for arch in ARCHS for mesh in MESHES for style in STYLES]
B, S, STEPS, MAX_LEN = 4, 8, 10, 12


def _run_id(run) -> str:
    return "-".join(run)


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(13)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32),
           "max_len": MAX_LEN,
           "hidden": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds at once: (1, 2) on 2 ranks, (1, 4) and (2, 2) on 4."""
    tmp = tmp_path_factory.mktemp("tp_family_worlds")
    arch_data = {arch: _bridged(arch) for arch in ARCHS}
    inputs = {arch: _inputs(arch_data[arch][3]) for arch in ARCHS}

    def cases(mesh):
        return [{"cfg": dataclasses.asdict(arch_data[arch][3]), "tree": arch_data[arch][2],
                 "mesh_shape": MESHES[mesh][1], "style": style, **inputs[arch]}
                for arch in ARCHS for style in STYLES]

    handles = {
        "1x2": World(2, "tp_serving", cases("1x2"), tmp, timeout=400),
        "4": World(4, "several", [("tp_serving", cases("1x4")), ("tp_serving", cases("2x2"))],
                   tmp, timeout=400),
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
    batch = {k: torch.as_tensor(inp[k]) for k in ("tokens", "frames") if k in inp}
    out = {}
    with torch.no_grad():
        out["forward"] = api.forward(model, batch).numpy()
        cache, steps = _new_cache(cfg, api, model, inp), []
        for t in range(STEPS):
            logits, cache = api.decode_step(model, cache, torch.as_tensor(inp["decode"][:, t:t + 1]))
            steps.append(logits.numpy())
        out["decode"] = np.stack(steps)
        step = make_serve_step(api)
        cache, tok, greedy = _new_cache(cfg, api, model, inp), torch.as_tensor(
            inp["decode"][:, :1]), []
        for _ in range(STEPS):
            tok, cache = step(model, cache, tok)
            greedy.append(tok.numpy())
        out["greedy"] = np.concatenate(greedy, axis=1)
        out["head_logits"] = transformer.logits_of(cfg, model, torch.as_tensor(inp["hidden"])).numpy()
        out["init"] = {k: p.numpy() for k, p in api.init(3).named_parameters()}
    return out


def _jax_reference(jcfg, jmodel, jparams, inp) -> dict:
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "frames") if k in inp}
    out = {"forward": np.asarray(jax.jit(jmodel.forward)(jparams, batch))}
    cache = jmodel.init_cache(B, MAX_LEN)
    if jcfg.family == "encdec":
        cache = jencdec.prefill_cross(jcfg, jparams, batch["frames"], cache)
    step, steps = jax.jit(jmodel.decode_step), []
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
    """(arch, mesh, style) -> the ranks' results."""
    out = {}
    pairs = [(arch, style) for arch in ARCHS for style in STYLES]
    ranks2 = launched["handles"]["1x2"].result()
    ranks4 = launched["handles"]["4"].result()
    for i, (arch, style) in enumerate(pairs):
        out[(arch, "1x2", style)] = [r[i] for r in ranks2]
        out[(arch, "1x4", style)] = [r[0][i] for r in ranks4]
        out[(arch, "2x2", style)] = [r[1][i] for r in ranks4]
    return out


def _rows(rank: int, mesh: str) -> slice:
    data, model = MESHES[mesh][1]
    n = B // data
    d = rank // model
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tp_logits_match_unsharded(worlds, refs, run):
    """Forward and every decode step within 1e-5 of scale of the port's
    unsharded run, on every rank's rows; greedy tokens equal; the gathered
    logits of one hidden state within 1e-6 of scale."""
    arch, mesh, _ = run
    ref_port = refs[arch]["port"]
    for rank, r in enumerate(worlds[run]):
        rows = _rows(rank, mesh)
        want = ref_port["forward"][rows]
        assert r["forward"].shape == want.shape
        _within_scale(r["forward"], want, 1e-5, f"{run} forward")
        for t in range(STEPS):
            _within_scale(r["decode"][t], ref_port["decode"][t][rows], 1e-5, f"{run} step {t}")
        np.testing.assert_array_equal(r["greedy"], ref_port["greedy"][rows])
        _within_scale(r["head_logits"], ref_port["head_logits"][rows], 1e-6, f"{run} head")


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tp_logits_match_jax(worlds, refs, run):
    """Forward and every decode step within 1e-4 of scale of JAX's
    unsharded ``forward`` / ``decode_step`` with the same weights."""
    arch, mesh, _ = run
    want = refs[arch]["jax"]
    for rank, r in enumerate(worlds[run]):
        rows = _rows(rank, mesh)
        _within_scale(r["forward"], want["forward"][rows], 1e-4, f"{run} forward")
        for t in range(STEPS):
            _within_scale(r["decode"][t], want["decode"][t][rows], 1e-4, f"{run} step {t}")


def _expected_comm(arch: str, mesh: str, style: str) -> dict:
    """Collectives of one decode step. zamba2: 2 all-reduces a Mamba-2 layer
    (the gated norm's sum of squares, out_proj) and 2 an application of the
    shared block (wo, w_down); whisper: 3 a decoder layer (self wo, cross
    wo, w_down). Plus 1 for the embedding rows and 1 logits gather where
    the vocabulary divides over model (both reduced vocabularies do), and,
    where the kv heads do not divide (slots split over model), a q gather
    and an lse merge an attention. The tp style adds the FSDP gathers of
    the data shards: one a layer, the shared block, the embedding and the
    head (a tied head is the embedding's second)."""
    cfg = reduced(get_config(arch))
    m = MESHES[mesh][1][1]
    seq = cfg.n_kv_heads % m != 0
    if cfg.family == "hybrid":
        attns = cfg.n_layers // cfg.hybrid_attn_every
        reduces, gathers = 2 * cfg.n_layers + 2 * attns, cfg.n_layers + 1
    else:
        attns = 2 * cfg.n_layers
        reduces, gathers = 3 * cfg.n_layers, cfg.n_layers
    want = {"tp_all_reduce": reduces + 1, "tp_all_gather": 1 + (2 * attns if seq else 0)}
    if style == "tp":
        want["all_gather"] = gathers + 2
    return want


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_collectives_per_decode_step(worlds, run):
    arch, mesh, style = run
    want = _expected_comm(arch, mesh, style)
    cfg = reduced(get_config(arch))
    m = MESHES[mesh][1][1]
    for r in worlds[run]:
        assert all(c == want for c in r["comm"]), (r["comm"][0], want)
        shapes = r["cache_shapes"]
        kv = "attn_k" if cfg.family == "hybrid" else "k"
        if cfg.n_kv_heads % m:  # slots split over model: each rank its block
            slots = {"attn_slots": MAX_LEN} if cfg.family == "hybrid" else {
                "slots": MAX_LEN, "cross_slots": cfg.enc_ctx}
            assert r["cache_slots"] == slots
            assert shapes[kv][2] == MAX_LEN // m and shapes[kv][3] == cfg.n_kv_heads
        else:
            assert not r["cache_slots"] and shapes[kv][3] == cfg.n_kv_heads // m
        if cfg.family == "hybrid":
            assert shapes["conv"][3] == cfg.d_inner // m
            assert shapes["h"][2] == cfg.d_inner // cfg.ssm_head_dim // m
        else:
            assert shapes["cross_k"][3 if cfg.n_kv_heads % m == 0 else 2] == (
                cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else cfg.enc_ctx // m)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_gather_and_sharded_init(worlds, refs, launched, arch, mesh):
    """Every leaf of the bridged JAX tree: each rank's block is
    ``Sharding.local`` of it and gathering the blocks gives it back
    (Mamba-2's ``in_proj`` as [z_r | x_r | B | C | dt_r] blocks);
    ``init(3, mesh=)`` gathered is the unsharded ``init(3)``, bit for bit."""
    flat = bridge._flat_names(launched["arch_data"][arch][2])
    cfg = reduced(get_config(arch))
    for style in STYLES:
        for r in worlds[(arch, mesh, style)]:
            assert r["blocks_are_local"]
            assert set(r["gather_is_identity"]) == set(flat)
            assert all(r["gather_is_identity"].values()), [
                k for k, ok in r["gather_is_identity"].items() if not ok]
            for k, want in refs[arch]["port"]["init"].items():
                np.testing.assert_array_equal(r["init_blocks"][k], want, err_msg=k)
            on_model = {k for k, d in r["tp_dims"].items() if d is not None}
            assert "embed" in on_model
            if cfg.family == "hybrid":
                assert {"blocks.in_proj", "blocks.conv_w", "blocks.dt_bias",
                        "shared_attn.wq"} <= on_model
                assert not {"blocks.a_log", "blocks.gate_norm"} & on_model
            else:
                assert {"enc_blocks.wq", "dec_blocks.cross_wq", "dec_blocks.w_up"} <= on_model


def test_fused_in_proj_blocks():
    """``Sharding`` with parts of unequal sizes on a duck mesh: the block of
    rank r is [z_r | x_r | B | C | dt_r] of the global columns, B and C
    (whole on every rank) at the same place in each block; a blocked part
    that does not divide raises."""
    from repro_torch.parallel.sharding import Sharding

    class Duck:
        def __init__(self, r, m):
            self.r, self.m = r, m
            self.mesh_dim_names, self.shape = ("data", "model"), (1, m)

        def get_local_rank(self, axis):
            return self.r if axis == "model" else 0

    di, n, h, m = 8, 3, 4, 2
    parts = ((di, True), (di, True), (2 * n, False), (h, True))
    full = np.arange(5 * (2 * di + 2 * n + h)).reshape(5, -1)
    for r in range(m):
        sh = Sharding(Duck(r, m), (None, "model"), full.shape, parts)
        got = sh.local(full)
        z, x, bc, dt = (full[:, :di], full[:, di:2 * di], full[:, 2 * di:2 * di + 2 * n],
                        full[:, 2 * di + 2 * n:])
        want = np.concatenate([z[:, r * 4:(r + 1) * 4], x[:, r * 4:(r + 1) * 4], bc,
                               dt[:, r * 2:(r + 1) * 2]], axis=1)
        np.testing.assert_array_equal(got, want)
        assert sh.tp_whole() == [(8, 14)]
    with pytest.raises(NotImplementedError, match="does not divide"):
        Sharding(Duck(0, 3), (None, "model"), full.shape, parts).segments(3)
