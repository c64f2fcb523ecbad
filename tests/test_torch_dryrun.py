"""The port's dry run (``launch/dryrun.py``), its op-level cost counter
(``launch/op_cost.py``) and the abstract half of ``launch/specs.py``, held
against the JAX package's.

  * ``batch_abstract`` / ``decode_abstract`` give the JAX package's names,
    shapes and dtypes for every arch x its shapes, as fake tensors.
  * ``analytic_memory`` equals the JAX package's residency and traffic to
    1e-12 relative for every arch x shape x mesh x style, decode cells with
    their cache placements. The JAX side runs in a subprocess that imports
    ``repro.launch.dryrun`` (its import sets ``XLA_FLAGS``) and lowers
    nothing.
  * ``OpCost`` on small CPU ops: a matmul's flops are 2MNK and its bytes as
    the module doc defines them; in a fake world of 4 (a subprocess) the wire
    bytes of an all-reduce, an all-gather and a reduce-scatter follow the
    ring formulas.
  * On a reduced minitron-4b train step and decode step outside a mesh, the
    counter under ``FakeTensorMode`` equals the counter on the real CPU step
    (flops and bytes exact); rank 0's flops on a fake (2, 2) mesh, times 4,
    are the unsharded step's within 1 %.
  * CLI cells, each its own process with its own timeout: whisper-base
    train_4k (pod), whisper-base decode_32k (multipod), minitron-4b
    long_500k (skipped), mixtral-8x7b long_500k (pod, the log-sum-exp merge
    gathered over all 256 ranks).

Anything that needs a fake process group runs in a subprocess: the test
process may hold other default groups.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.steps import make_serve_step, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
STYLES = ["tp", "tp_sp", "fsdp", "serve"]
MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}
CLI_CELLS = {"whisper-train": ("whisper-base", "train_4k", "pod"),
             "whisper-decode": ("whisper-base", "decode_32k", "multipod"),
             "minitron-long": ("minitron-4b", "long_500k", "pod"),
             "mixtral-long": ("mixtral-8x7b", "long_500k", "pod")}
B, S = 4, 16


def _python(code: str, timeout: float):
    """A subprocess running ``code`` with the packages on its path."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), timeout


def _joined(handle) -> str:
    proc, timeout = handle
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out


JAX_ANALYTIC = """
    import json
    from repro.configs import ARCH_IDS, get_config
    from repro.launch import specs as S
    from repro.launch.dryrun import analytic_memory
    from repro.launch.mesh import make_production_mesh
    from repro.models import build_model
    from repro.parallel.sharding import mesh_context

    out = {}
    meshes = {"pod": make_production_mesh(multi_pod=False),
              "multipod": make_production_mesh(multi_pod=True)}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, (seq, gb, kind) in cfg.shapes().items():
            cache = S.decode_abstract(cfg, build_model(cfg), shape)[0] if kind == "decode" \\
                else None
            for name, mesh in meshes.items():
                for style in %r:
                    with mesh_context(mesh, style=style):
                        specs = S.decode_pspecs(cfg, cache, shape, mesh)[0] if cache else None
                    n = mesh.devices.size
                    eff = tuple(mesh.devices.shape) if style != "fsdp" else (n, 1)
                    out[f"{arch}|{shape}|{name}|{style}"] = analytic_memory(
                        cfg, shape, kind, eff, cache_abs=cache, cache_specs=specs, style=style)
    print(json.dumps(out))
""" % (STYLES,)

COLLECTIVES = """
    import json
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_cost import OpCost
    dryrun.fake_world(4)
    x = torch.ones(6, 10)  # 240 bytes
    with OpCost() as c:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.empty(24, 10), x)
        dist.reduce_scatter_tensor(torch.empty(6, 10), torch.ones(24, 10))
    print(json.dumps({"bytes": dict(c.collective_bytes), "calls": dict(c.calls_by_group)}))
"""

SHARDED_FLOPS = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding
    dryrun.fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduced(get_config("minitron-4b"))
    api = build_model(cfg, device="cpu")
    out = {}
    with FakeTensorMode(), sharding.mesh_context(mesh, "tp"):
        params = api.init(0, mesh=mesh)
        opt = adamw_init(params)
        rows = {"tokens": torch.zeros((%d, %d), dtype=torch.int32),
                "labels": torch.zeros((%d, %d), dtype=torch.int32),
                "weights": torch.ones((%d,))}
        with OpCost() as c:
            make_train_step(api, AdamWConfig())(params, opt, rows)
        out["train"] = c.flops
        cache = api.init_cache(%d, %d)
        with OpCost() as c:
            make_serve_step(api)(params, cache, torch.zeros((%d, 1), dtype=torch.int32))
        out["decode"] = c.flops
    print(json.dumps(out))
""" % (B // 2, S, B // 2, S, B // 2, B, S, B // 2)


def _cli(arch: str, shape: str, mesh: str, out: Path):
    code = f"""
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", {arch!r}, "--shape", {shape!r}, "--mesh", {mesh!r},
                     "--out", {str(out)!r}])
    """
    return _python(code, timeout=300)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every subprocess at once: the JAX analytic model, the fake worlds and
    the CLI cells."""
    out = tmp_path_factory.mktemp("dryrun")
    return {"jax": _python(JAX_ANALYTIC, timeout=300),
            "collectives": _python(COLLECTIVES, timeout=120),
            "sharded": _python(SHARDED_FLOPS, timeout=300),
            "cli": {k: _cli(*cell, out) for k, cell in CLI_CELLS.items()}, "out": out}


# --------------------------------------------------------------------------
# The abstract inputs
# --------------------------------------------------------------------------

def _signature(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_inputs_match_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.shapes() == jcfg.shapes()
    api, jmodel = build_model(cfg, device="cpu"), j_build_model(jcfg)
    for shape, (_, _, kind) in cfg.shapes().items():
        if kind == "decode":
            cache, tok = specs.decode_abstract(cfg, api, shape)
            jcache, jtok = j_specs.decode_abstract(jcfg, jmodel, shape)
            assert _signature(cache) == _signature(jcache), shape
            assert _signature({"t": tok}) == _signature({"t": jtok})
            assert all(isinstance(v, torch._subclasses.FakeTensor) for v in cache.values())
        else:
            for k in ("train", "prefill"):
                got = specs.batch_abstract(cfg, shape, k)
                assert _signature(got) == _signature(j_specs.batch_abstract(jcfg, shape, k))
                assert all(isinstance(v, torch._subclasses.FakeTensor) for v in got.values())


# --------------------------------------------------------------------------
# The analytic model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_analytic(launched):
    return json.loads(_joined(launched["jax"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_memory_matches_jax(arch, jax_analytic):
    cfg = get_config(arch)
    api = build_model(cfg, device="cpu")
    n = 0
    for shape, (_, gb, kind) in cfg.shapes().items():
        cache = specs.decode_abstract(cfg, api, shape)[0] if kind == "decode" else None
        for name, sizes in MESHES.items():
            for style in STYLES:
                with sharding.mesh_context(sizes, style):
                    placed = specs.cache_pspecs(cfg, cache, sizes, gb) if cache else None
                chips = int(np.prod(list(sizes.values())))
                eff = tuple(sizes.values()) if style != "fsdp" else (chips, 1)
                got = dryrun.analytic_memory(cfg, shape, kind, eff, cache_abs=cache,
                                             cache_specs=placed, style=style)
                want = jax_analytic[f"{arch}|{shape}|{name}|{style}"]
                for key in ("residency_bytes", "traffic_bytes"):
                    assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), \
                        (shape, name, style, key)
                assert got["fits_hbm"] == (got["residency_bytes"] <= dryrun.HBM_BYTES)
                n += 1
    assert n == len(cfg.shapes()) * len(MESHES) * len(STYLES)


def test_card_constants_are_the_h100_data_sheet():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert (dryrun.NET_BW, dryrun.NVLINK_BW) == (50e9, 450e9)


# --------------------------------------------------------------------------
# The counter
# --------------------------------------------------------------------------

def test_matmul_flops_and_bytes():
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n)
    with OpCost() as c:
        c.track((a, b))
        y = a @ b  # new storage: m n x 4 bytes written, a and b read
        t = y.t()  # a view: nothing
        y.add_(1.0)  # in place: its result
        z = torch.relu(t)  # new storage
    assert c.flops == 2 * m * n * k
    assert c.dot_operand_bytes == (m * k + k * n) * 4
    assert c.bytes_written == 3 * m * n * 4
    assert c.memory_traffic == 2 * c.bytes_written + c.dot_operand_bytes
    assert c.peak_bytes == (m * k + k * n + 2 * m * n) * 4
    del z
    assert c.live_bytes == (m * k + k * n + m * n) * 4


def test_bmm_and_baddbmm_are_dots():
    a, b, bias = torch.randn(3, 5, 7), torch.randn(3, 7, 2), torch.randn(3, 5, 2)
    with OpCost() as c:
        torch.baddbmm(bias, a, b)
    assert c.flops == 2 * 3 * 5 * 7 * 2
    assert c.dot_operand_bytes == (bias.numel() + a.numel() + b.numel()) * 4


def test_ring_wire_bytes_in_a_fake_world_of_four(launched):
    got = json.loads(_joined(launched["collectives"]))
    payload = 6 * 10 * 4
    assert got["bytes"] == {"all-reduce": 2 * 3 / 4 * payload,
                            "all-gather": 3 / 4 * 4 * payload,
                            "reduce-scatter": 3 / 4 * 4 * payload}
    assert got["calls"] == {"all-reduce x4": 1, "all-gather x4": 1, "reduce-scatter x4": 1}


def _reduced_steps(fake: bool) -> dict:
    """The reduced minitron-4b train step and decode step outside a mesh,
    counted on real CPU tensors or under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = reduced(get_config("minitron-4b"))
    api = build_model(cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    out = {}
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = api.init(0)
        opt = adamw_init(params)
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32),
                 "labels": torch.as_tensor(np.roll(tokens, -1, 1), dtype=torch.int32),
                 "weights": torch.ones((B,))}
        with OpCost() as c:
            c.track((params, opt, batch))
            make_train_step(api, AdamWConfig())(params, opt, batch)
        out["train"] = c.summary()
        cache = api.init_cache(B, S)
        cache["pos"] = S - 1
        with OpCost() as c:
            c.track((params, cache))
            make_serve_step(api)(params, cache, batch["tokens"][:, :1])
        out["decode"] = c.summary()
    return out


@pytest.fixture(scope="module")
def reduced_counts():
    return {"real": _reduced_steps(False), "fake": _reduced_steps(True)}


@pytest.mark.parametrize("step", ["train", "decode"])
def test_fake_counts_equal_real_counts(step, reduced_counts):
    real, fake = reduced_counts["real"][step], reduced_counts["fake"][step]
    for key in ("flops", "bytes_written", "dot_operand_bytes", "ops", "peak_bytes"):
        assert fake[key] == real[key], key
    assert real["flops"] > 0 and real["collective_calls"] == {}


@pytest.mark.parametrize("step", ["train", "decode"])
def test_rank_flops_on_a_fake_two_by_two_mesh(step, launched, reduced_counts):
    """Rank 0 of (data 2, model 2) runs a quarter of the step's products:
    its flops times 4 are the unsharded step's within 1 %."""
    sharded = json.loads(_joined(launched["sharded"]))[step]
    whole = reduced_counts["real"][step]["flops"]
    assert 4 * sharded == pytest.approx(whole, rel=1e-2)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

def _record(launched, key: str) -> tuple[str, dict]:
    arch, shape, mesh = CLI_CELLS[key]
    out = _joined(launched["cli"][key])
    tag = f"{arch}_{shape}_{mesh}".replace(".", "_")
    return out, json.loads((launched["out"] / f"{tag}.json").read_text())


def test_cli_train_cell_whisper(launched):
    out, d = _record(launched, "whisper-train")
    assert out.startswith("OK whisper-base_train_4k_pod")
    assert d["kind"] == "train" and d["route"] == "plain"
    assert d["cost"]["flops_per_device"] > 1e12
    assert d["memory"]["peak_bytes"] > 0
    assert d["roofline"]["compute_s"] > 0 and d["roofline"]["collective_s"] >= 0


def test_cli_decode_cell_multipod(launched):
    out, d = _record(launched, "whisper-decode")
    assert out.startswith("OK ")
    assert d["mesh"] == "2x16x16" and d["n_chips"] == 512
    assert d["analytic_memory"]["fits_hbm"]


def test_cli_skip_rule(launched):
    out, d = _record(launched, "minitron-long")
    assert out.startswith("SKIP ") and d.get("skipped") is True


def test_cli_long_context_merges_over_every_rank(launched):
    """mixtral-8x7b at long_500k: a batch of 1 puts the 4,096-slot window
    ring on (data, model), 16 slots a rank, and each layer merges its
    partial softmax by one all-gather over all 256 ranks."""
    out, d = _record(launched, "mixtral-long")
    assert out.startswith("OK mixtral-8x7b_long_500k_pod")
    cfg = get_config("mixtral-8x7b")
    assert d["collective_calls_by_group"]["all-gather x256"] == cfg.n_layers
    assert d["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
