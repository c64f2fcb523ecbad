"""The port's checkpointing (``repro_torch.checkpoint``): the cases of
``tests/test_substrate.py::TestCheckpoint`` on torch trees (roundtrip,
retention, an interrupted write, resume), and snapshots in the JAX
package's key layout, so each package restores the other's: a training
snapshot ({"params", "opt"}) has the same npz keys from both."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import ArchConfig  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


def _tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.randn((3,), generator=g),
                       "c": torch.arange(5, dtype=torch.int32)}}


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(tmp_path, 7, tree, extra={"note": "hi"})
    out, meta = ckpt.restore(tmp_path, 7, tree)
    _equal(out, tree)
    assert meta == {"note": "hi"}
    assert out["nested"]["c"].dtype == np.int32


def test_latest_and_retention(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=1, keep=2)
    tree = _tree(1)
    for s in (1, 2, 3, 4):
        assert mgr.maybe_save(s, tree)
    assert not ckpt.CheckpointManager(str(tmp_path), every_steps=3).maybe_save(5, tree)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000003.npz",
                                                          "step_0000000004.npz"]
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_interrupted_write_keeps_previous(tmp_path):
    """A crash mid-write never corrupts the newest snapshot: the temporary
    file is left behind and the latest snapshot still loads."""
    tree = _tree(2)
    ckpt.save(tmp_path, 1, tree)
    (tmp_path / "garbage.tmp").write_bytes(b"\x00" * 100)  # simulated crash
    assert ckpt.latest_step(tmp_path) == 1
    out, _ = ckpt.restore(tmp_path, 1, tree)
    _equal(out, tree)


def test_failed_write_leaves_no_file(tmp_path):
    class Unsaveable:
        def __array__(self, *a, **k):
            raise RuntimeError("no")

    with pytest.raises(RuntimeError):
        ckpt.save(tmp_path, 3, {"x": Unsaveable()})
    assert list(tmp_path.iterdir()) == []


def test_resume_roundtrip_matches(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=1)
    assert mgr.resume(_tree(3)) is None
    tree = _tree(3)
    mgr.maybe_save(5, tree, extra={"step": 5})
    out, meta, s = mgr.resume(tree)
    assert s == 5 and meta["step"] == 5
    target = _tree(9)
    ckpt.load_into(target, out)
    _equal(out, target)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, 5, {"a": torch.zeros(2), "nested": tree["nested"]})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(tmp_path, 5, {**tree, "extra": torch.zeros(1)})


@pytest.fixture(scope="module")
def training_trees():
    """A reduced minitron-4b snapshot tree from each package: JAX params and
    AdamW state, and the port's model (bridged) and its bridged state."""
    jcfg = j_reduced(j_get_config("minitron-4b"))
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = j_adamw_init(jparams)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    model = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    opt = bridge.adamw_state_from_numpy(model, jax.tree.map(np.asarray, jopt), "cpu")
    return ({"params": jparams, "opt": jopt},
            {"params": dict(model.named_parameters()), "opt": opt})


def test_key_layout_is_the_jax_packages(tmp_path, training_trees):
    jtree, tree = training_trees
    ckpt.save(tmp_path / "port", 1, tree)
    jckpt.save(tmp_path / "jax", 1, jtree)
    with np.load(tmp_path / "port" / "step_0000000001.npz") as a, \
            np.load(tmp_path / "jax" / "step_0000000001.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt/.m/blocks/wq" in a.files and "params/blocks/wq" in a.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_the_others(tmp_path, training_trees, writer):
    jtree, tree = training_trees
    if writer == "port":
        ckpt.save(tmp_path, 4, tree, extra={"step": 4})
        out, meta = jckpt.restore(tmp_path, 4, jtree)
        want = jax.tree.map(np.asarray, jtree)
        jax.tree.map(np.testing.assert_array_equal, out, want)
    else:
        jckpt.save(tmp_path, 4, jtree, extra={"step": 4})
        out, meta = ckpt.restore(tmp_path, 4, tree)
        target = {"params": {k: torch.zeros_like(p) for k, p in tree["params"].items()},
                  "opt": adamw_init(tree["params"])}
        ckpt.load_into(target, out)
        for k, p in tree["params"].items():
            np.testing.assert_array_equal(target["params"][k].numpy(), p.detach().numpy())
    assert meta == {"step": 4}
