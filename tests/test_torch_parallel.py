"""The port's distribution layer in one process (``repro_torch.parallel``,
``repro_torch.launch.mesh``, ``repro_torch.core.matching``): the placement
rules against the JAX package's, the int8 pack, and a world of 1.

Placements: the JAX rules take a duck mesh (``axis_names``, ``devices`` of
the mesh's shape, ``shape`` as a dict) inside their ``mesh_context``, with
no JAX devices; the port's take a mapping of axis name -> size. Every leaf
of every architecture (reduced and full widths), in the styles tp, tp_sp,
fsdp and serve, on the meshes (1, 1), (4, 2), (2, 4), (8, 1) and
(2, 2, 2) with ``pod``: equal tuples. ``batch_axes``, ``kv_layout`` and
``dp_group_count`` likewise.

A world of 1 (the gloo group ``make_host_mesh`` starts in the process):
every collective is a copy, so one train step under the mesh equals the
unsharded step bit for bit, and the gather / reduce-scatter counts are one
a layer (each carries all of the layer's sharded leaves).
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.matching as j_matching  # noqa: E402
import repro.launch as j_launch  # noqa: E402
import repro.parallel as j_parallel  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.parallel import collectives as j_collectives  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402

import repro_torch.launch as launch  # noqa: E402
import repro_torch.parallel as parallel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import matching  # noqa: E402
from repro_torch.kernels.matching import ref as mref  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, new_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import collectives, sharding  # noqa: E402

MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 2}, {"data": 2, "model": 4},
          {"data": 8, "model": 1}, {"pod": 2, "data": 2, "model": 2}]
STYLES = ["tp", "tp_sp", "fsdp", "serve"]


def duck(sizes: dict):
    """A stand-in JAX mesh: what the JAX rules read, no devices."""
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=object))


def _jax_shapes(arch: str, full: bool) -> dict[str, tuple]:
    cfg = j_get_config(arch)
    cfg = cfg if full else j_reduced(cfg)
    tree = jax.eval_shape(j_build_model(cfg).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {js._path_str(path): tuple(leaf.shape) for path, leaf in flat}


def _port_shapes(arch: str, full: bool) -> dict[str, tuple]:
    cfg = get_config(arch)
    cfg = cfg if full else reduced(cfg)
    model = new_model(cfg, "meta")
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_match_jax(arch, style):
    for full in (False, True):
        jshapes, shapes = _jax_shapes(arch, full), _port_shapes(arch, full)
        assert {k.replace(".", "/") for k in shapes} == set(jshapes)
        for sizes in MESHES:
            with js.mesh_context(duck(sizes), style):
                want = {k: tuple(js.param_pspec(k, s, js.current_mesh()))
                        for k, s in jshapes.items()}
            with sharding.mesh_context(sizes, style):
                got = sharding.shard_params_pspecs(
                    {k: torch.empty(s, device="meta") for k, s in shapes.items()}, sizes)
            assert {k.replace(".", "/"): v for k, v in got.items()} == want, (full, sizes)


@pytest.mark.parametrize("style", STYLES)
def test_batch_axes_kv_layout_and_group_count_match_jax(style):
    for sizes in MESHES:
        with js.mesh_context(duck(sizes), style):
            want = (js.batch_axes(js.current_mesh()),
                    [js.kv_layout(h) for h in range(1, 17)],
                    [js.dp_group_count(n) for n in range(1, 33)])
        with sharding.mesh_context(sizes, style):
            got = (sharding.batch_axes(sizes),
                   [sharding.kv_layout(h) for h in range(1, 17)],
                   [sharding.dp_group_count(n) for n in range(1, 33)])
        assert got == want, sizes
    assert sharding.kv_layout(3) == "heads" and sharding.dp_group_count(7) == 1  # no mesh


def test_module_exports_match_jax():
    assert parallel.__all__ == j_parallel.__all__
    assert launch.__all__ == j_launch.__all__
    assert matching.__all__ == j_matching.__all__
    assert matching._NEG == j_matching._NEG
    assert matching.greedy_collection is mref.greedy_collection_ref
    assert matching.greedy_assignment is mref.greedy_assignment_ref
    assert matching.greedy_pairing is mref.greedy_pairing_ref
    assert matching._marginal_penalty is mref._marginal_penalty


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_pack_matches_jax(dtype):
    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-3, 0.0):
        x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
        x[0, :3] = [127.5 * scale, -0.5, 2.5]  # ties of the rounding
        jq, js_ = j_collectives._int8_pack(jnp.asarray(x, dtype))
        q, s = collectives._int8_pack(torch.as_tensor(x).to(getattr(torch, dtype)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(s.numpy(), np.asarray(js_))


def test_constrain_act_is_the_identity():
    x = torch.ones(2, 3)
    with sharding.mesh_context({"data": 2, "model": 1}):
        assert sharding.constrain_act(x, ("batch", None)) is x


@pytest.mark.parametrize("style", ["tp_sp", "fsdp"])
def test_pending_styles_raise_in_the_train_step(style):
    """The train step runs in every style on a model axis above 1
    (tests/test_torch_tp_styles.py); what stays refused there is a decode
    under fsdp, whose cache has no placement: ``init_cache`` and
    ``decode_step`` raise naming ``cache_pspecs``' duplicate ``model``
    placement, before anything is allocated, while tp_sp allocates the
    cache (whole on a mapping of axis sizes) and leaves the parameters
    untouched."""
    api = build_model(reduced(get_config("minitron-4b")), device="cpu")
    model = api.init(0)
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    for sizes in ({"data": 1, "model": 2}, {"data": 2, "model": 4}):
        with sharding.mesh_context(sizes, style):
            if style == "fsdp":
                for call in (lambda: api.init_cache(2, 4),
                             lambda: api.decode_step(model, {}, tokens)):
                    with pytest.raises(NotImplementedError, match=r"fsdp style.*cache_pspecs"):
                        call()
            else:
                assert tuple(api.init_cache(2, 4)["k0"].shape[1:3]) == (2, 4)
    assert not any(p.requires_grad for p in model.parameters())


# --------------------------------------------------------------------------
# A world of 1
# --------------------------------------------------------------------------

def test_host_mesh_of_a_world_of_one():
    mesh = make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()
    tree = {"a": torch.arange(6), "b": None}
    out = launch.mesh.shard_leading_axis(tree, mesh)
    assert torch.equal(out["a"], tree["a"]) and out["b"] is None


def test_cross_pod_sum_at_world_one_is_the_plain_pack():
    """A (1, 1, 1) pod mesh has no peers: the sum is one int8 copy
    dequantised, in the leaf's dtype."""
    from torch.distributed.device_mesh import init_device_mesh
    flat = make_host_mesh(device="cpu")  # starts the process group
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32))
    for t in (x, x.to(torch.bfloat16)):
        q, s = collectives._int8_pack(t)
        got = collectives.cross_pod_sum_partials({"g": t}, mesh)["g"]
        assert got.dtype == t.dtype
        assert torch.equal(got, (q.float() * s).to(t.dtype))
        assert torch.equal(collectives.cross_pod_compressed_allreduce([t], mesh)[0], got)
    assert collectives.cross_pod_sum_partials({"g": x}, flat)["g"] is x


@pytest.mark.parametrize("changes", [{}, {"compute_dtype": "bfloat16", "remat": True}],
                         ids=["f32", "bf16-remat"])
def test_train_step_at_world_one_is_the_unsharded_step(changes):
    """Two steps of reduced minitron-4b under a (1, 1) mesh and without one,
    from the same weights and batches: losses, parameters and moments bit
    for bit; one all-gather per layer per forward pass (twice under remat:
    the recompute gathers again) and one reduce-scatter per layer per step,
    each carrying all of the layer's sharded leaves, plus one each for the
    embedding and the head."""
    cfg = dataclasses.replace(reduced(get_config("minitron-4b")), **changes)
    api = build_model(cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels),
             "weights": torch.tensor([1.3, 0.0, 0.7, 2.0])}
    mesh = make_host_mesh(device="cpu")
    runs = []
    for sharded in (False, True):
        model = api.init(0)
        step = make_train_step(api, AdamWConfig(), total_steps=10)
        if sharded:
            sharding.shard_params(model, mesh)
        opt = adamw_init(model)
        losses = []
        sharding.reset_comm_counts()
        for _ in range(2):
            if sharded:
                with sharding.mesh_context(mesh):
                    model, opt, met = step(model, opt, batch)
            else:
                model, opt, met = step(model, opt, batch)
            losses.append(float(met["loss"]))
        runs.append((losses, dict(model.named_parameters()), opt, dict(sharding.comm_counts)))
    (l0, p0, o0, c0), (l1, p1, o1, c1) = runs
    assert l0 == l1 and c0 == {}
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(o0.m[k], o1.m[k]) and torch.equal(o0.v[k], o1.v[k]), k
    dims = sharding.param_shardings(p1)
    stacked = sum(1 for k, s in dims.items() if s.dim is not None and k.startswith("blocks."))
    top = sum(1 for k, s in dims.items() if s.dim is not None and not k.startswith("blocks."))
    assert stacked > 0 and top == 2  # embed and head
    passes = 2 if cfg.remat else 1  # a layer's sharded leaves travel in one collective
    assert c1["all_gather"] == 2 * (passes * cfg.n_layers + top)
    assert c1["reduce_scatter"] == 2 * (cfg.n_layers + top)
