"""The port's paper evaluation (``repro_torch.paper``, the example
``repro_torch.examples.traffic_prediction``) against the JAX package's
``benchmarks/common.py``, ``benchmarks/fig7_accuracy.py`` and
``benchmarks/paper_figs.py``, imported unedited from the repo root.

  * The scenarios: the testbed and Fig. 9's five ``sim_config`` points
    equal the JAX ones field by field.
  * Fig. 7's model: ``TrafficMLP``'s forward, the clipped gradient and one
    and four ``train_batch`` steps from the JAX ``_mlp_init(PRNGKey(0))``
    weights on a numpy-seeded batch of 256 (clipping bound and not), within
    1e-5 relative plus 1e-6 of each leaf's scale.
  * Fig. 7 teacher-forced: 10 DS slots of the jitted JAX ``step`` at the
    testbed scale; each decision trains the JAX package's MLP (the body of
    its loop) and the port's (``draw_counts`` + ``train_slot``) from the
    same weights and fresh sources. The draw counts are equal slot by slot
    (zero-total slots keep the previous composition), the weights end
    within 1e-4 of each leaf's scale, and the held-out predictions fall on
    the same side of the 15 % cut except where the relative error is within
    1e-5 of it.
  * The example on the CPU in a subprocess that blocks JAX, the JAX package
    and ``benchmarks``, at 10 slots.

Figs. 5, 6, 8 and 9 are held against the JAX package in
``tests/test_torch_paper_figs.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))  # the JAX package's benchmarks/, not a package of the port

from benchmarks import common as j_common  # noqa: E402
from benchmarks import fig7_accuracy as j_fig7  # noqa: E402
from benchmarks import paper_figs as j_figs  # noqa: E402
import repro.core as J  # noqa: E402
from repro.data import TrafficSource as JTrafficSource  # noqa: E402
from test_torch_datasche import _jit_step  # noqa: E402

from repro_torch.core import Decision  # noqa: E402
from repro_torch.data import TrafficSource  # noqa: E402
from repro_torch.paper import common, paper_figs  # noqa: E402
from repro_torch.paper import fig7_accuracy as fig7  # noqa: E402

FIG9_POINTS = ((3, 20, 3), (5, 20, 5), (8, 20, 8), ("cu10", 10, 5), ("cu40", 40, 5))
CONFIGS = {"testbed": ((), {}), "testbed_eps0.4": ((), {"eps": 0.4}),
           **{f"sim_{n}x{m}": ((n, m), {}) for _, n, m in FIG9_POINTS}}
LEAVES = ("w1", "b1", "w2", "b2", "w3", "b3")
FORCED_SLOTS = 10


def _numpy(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _assert_leaves(model, params_j, rtol, of_scale):
    got = dict(model.named_parameters())
    for name in LEAVES:
        want = np.asarray(params_j[name], np.float64)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[name].detach().double().numpy(), want, rtol=rtol,
                                   atol=of_scale * scale + 1e-30, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_equals_jax(name):
    args, kw = CONFIGS[name]
    make = "sim_config" if args else "testbed_config"
    port, ref = getattr(common, make)(*args, **kw), getattr(j_common, make)(*args, **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_figure_constants_equal_jax():
    assert paper_figs.SLOTS == j_figs.SLOTS and paper_figs.FIG9_POINTS == FIG9_POINTS
    assert (fig7.SLOTS, fig7.HIDDEN) == (j_fig7.SLOTS, j_fig7.HIDDEN)
    assert [s.name for s in fig7.SPECS] == ["ds", "no-sdc", "no-slt", "no-lsa"]


def _batch(clip: bool):
    """A numpy-seeded batch of 256 records; targets far from the initial
    model's outputs make the clip bind, targets near them leave it free."""
    rng = np.random.default_rng(11 if clip else 12)
    x = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    y = rng.uniform(0.2, 0.8, 256).astype(np.float32) * (8.0 if clip else 0.05)
    w = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    return x, y, w


def _jax_clipped_grads(params, x, y, w):
    """``benchmarks/fig7_accuracy.py::_train_batch``'s loss and clipped
    gradient, before its SGD step."""
    def loss(p):
        pred = j_fig7._mlp(p, x)
        return jnp.sum(w * (pred - y) ** 2) / jnp.maximum(jnp.sum(w), 1e-9)

    l, g = jax.value_and_grad(loss)(params)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(gg)) for gg in jax.tree.leaves(g)))
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm, 1e-9))
    return l, gnorm, jax.tree.map(lambda gg: scale * gg, g)


@pytest.fixture(scope="module")
def init_j():
    return j_fig7._mlp_init(jax.random.PRNGKey(0))


def test_init_scales(init_j):
    model = fig7.TrafficMLP(generator=torch.Generator().manual_seed(0), device="cpu")
    for name, scale in (("w1", 0.3), ("w2", 0.08), ("w3", 0.08)):
        got = getattr(model, name).detach().numpy()
        assert got.shape == np.shape(init_j[name])
        assert abs(got.std() / scale - 1) < 0.25, name
    for name in ("b1", "b2", "b3"):
        assert getattr(model, name).shape == np.shape(init_j[name])
        assert not getattr(model, name).detach().any()


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
def test_forward_and_clipped_gradient(init_j, clip):
    x, y, w = _batch(clip)
    model = fig7.mlp_params_from_numpy(_numpy(init_j), "cpu")
    _assert_leaves(model, init_j, 0.0, 0.0)  # carried across exactly
    pred = model(torch.as_tensor(x)).detach().double().numpy()
    want = np.asarray(j_fig7._mlp(init_j, jnp.asarray(x)), np.float64)
    np.testing.assert_allclose(pred, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    loss, grads = fig7.clipped_grads(model, *map(torch.as_tensor, (x, y, w)))
    l_j, gnorm_j, g_j = _jax_clipped_grads(init_j, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(w))
    assert (float(gnorm_j) > 1.0) == clip
    np.testing.assert_allclose(float(loss), float(l_j), rtol=1e-5)
    for name, g in zip(LEAVES, grads):
        want = np.asarray(g_j[name], np.float64)
        np.testing.assert_allclose(g.double().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max() + 1e-30, err_msg=name)


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
def test_train_batch_steps(init_j, clip, steps):
    x, y, w = _batch(clip)
    model = fig7.mlp_params_from_numpy(_numpy(init_j), "cpu")
    params_j, xt, yt, wt = init_j, *map(torch.as_tensor, (x, y, w))
    for _ in range(steps):
        loss = fig7.train_batch(model, xt, yt, wt)
        params_j, l_j = j_fig7._train_batch(params_j, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(w))
        np.testing.assert_allclose(float(loss), float(l_j), rtol=1e-5)
    _assert_leaves(model, params_j, 1e-5, 1e-6)


def _jax_draw(x, y, n_draw):
    """``benchmarks/fig7_accuracy.py``'s composition rule (its loop's
    first lines) on one decision."""
    trained = x + y.sum(axis=1)
    per_cu = trained.sum(axis=1)
    total = per_cu.sum()
    if total > 0:
        n_draw = np.maximum((per_cu / total * 256).astype(int), 0)
    return n_draw


def _jax_train_slot(params, sources, n_draw):
    """The rest of that loop's body: draw, then four ``_train_batch`` steps."""
    if n_draw is not None and n_draw.sum() > 0:
        xs, ys, ws = [], [], []
        for i, n in enumerate(n_draw):
            if n == 0:
                continue
            x, y = sources[i].sample(int(n))
            xs.append(x)
            ys.append(y)
            ws.extend([1.0] * int(n))
        xj, yj = jnp.asarray(np.concatenate(xs)), jnp.asarray(np.concatenate(ys))
        wj = jnp.asarray(ws, jnp.float32)
        for _ in range(4):
            params, _ = j_fig7._train_batch(params, xj, yj, wj)
    return params


@pytest.fixture(scope="module")
def forced(init_j):
    """FORCED_SLOTS DS slots of the jitted JAX step at the testbed scale,
    each decision training both packages' models, the figure's held-out
    sets drawn first as the figure draws them."""
    cfg = j_common.testbed_config()
    src_j = [JTrafficSource(i, seed=7) for i in range(cfg.n_cu)]
    src_t = [TrafficSource(i, seed=7) for i in range(cfg.n_cu)]
    held = [s.sample(fig7.HELD_OUT) for s in src_j]
    for s in src_t:
        s.sample(fig7.HELD_OUT)
    params_j, model = init_j, fig7.mlp_params_from_numpy(_numpy(init_j), "cpu")
    state, n_j, n_t = J.init_state(cfg), None, None
    decisions, draws = [], []
    for _ in range(FORCED_SLOTS):
        state, _, dec = _jit_step(cfg, J.DS, state, None, None)
        x, y = np.asarray(dec.x), np.asarray(dec.y)
        n_j = _jax_draw(x, y, n_j)
        params_j = _jax_train_slot(params_j, src_j, n_j)
        n_t = fig7.draw_counts(x, y, n_t)
        fig7.train_slot(model, src_t, n_t)
        decisions.append((x, y))
        draws.append((n_j, n_t))
    return {"params_j": params_j, "model": model, "decisions": decisions, "draws": draws,
            "xs": np.concatenate([h[0] for h in held]),
            "ys": np.concatenate([h[1] for h in held])}


def test_draw_counts_equal_jax(forced):
    totals = [float((x + y.sum(axis=1)).sum()) for x, y in forced["decisions"]]
    assert min(totals) == 0.0 < max(totals), totals  # zero-total and training slots
    for (n_j, n_t), total in zip(forced["draws"], totals):
        if n_j is None:
            assert n_t is None and total == 0.0
        else:
            assert n_t.dtype == n_j.dtype and np.array_equal(n_t, n_j)
    x, y = forced["decisions"][-1]
    prev = forced["draws"][-1][1]
    assert fig7.draw_counts(np.zeros_like(x), np.zeros_like(y), prev) is prev


def test_draw_counts_from_the_host_copy():
    dec = Decision(alpha=None, theta=None, x=torch.arange(6.0).reshape(3, 2),
                     y=torch.arange(12.0).reshape(3, 2, 2), z=None)
    x, y = fig7.decision_on_host(dec)
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, dec.x.numpy())
    np.testing.assert_array_equal(y, dec.y.numpy())


def test_teacher_forced_weights(forced):
    assert any(n is not None and n.sum() > 0 for n, _ in forced["draws"])
    _assert_leaves(forced["model"], forced["params_j"], 0.0, 1e-4)


def test_teacher_forced_accuracy(forced):
    xs, ys, model, params_j = forced["xs"], forced["ys"], forced["model"], forced["params_j"]
    with torch.no_grad():
        pred = model(torch.as_tensor(xs)).numpy()
    pred_j = np.asarray(j_fig7._mlp(params_j, jnp.asarray(xs)))
    rel = np.abs(pred - ys) / np.maximum(np.abs(ys), 1e-3)
    rel_j = np.abs(pred_j - ys) / np.maximum(np.abs(ys), 1e-3)
    flips = (rel <= 0.15) != (rel_j <= 0.15)
    assert np.all(np.abs(rel_j[flips] - 0.15) <= 1e-5), rel_j[flips]
    acc, acc_j = fig7.accuracy(model, xs, ys), j_fig7._accuracy(params_j, xs, ys)
    assert abs(acc - acc_j) <= flips.sum() / len(ys)
    assert 0.0 < acc < 1.0


def test_example_runs_on_the_cpu():
    src = str(ROOT / "src")
    env = {**os.environ, "PYTHONPATH": src, "COCKTAIL_EXAMPLE_SLOTS": str(FORCED_SLOTS)}
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = sys.modules['benchmarks'] = None\n"
            "runpy.run_module('repro_torch.examples.traffic_prediction', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code, "--device", "cpu"], env=env,
                         capture_output=True, text=True, check=True, timeout=300).stdout
    lines = out.splitlines()
    assert lines[1] == "name,us_per_call,derived"
    names = [s.name for s in fig7.SPECS]
    for name in names:
        acc = [ln for ln in lines if ln.startswith(f"fig7/accuracy/{name},")]
        assert len(acc) == 1 and 0.0 <= float(acc[0].split(",")[2]) <= 1.0, out
        summary = [ln for ln in lines if ln.startswith(f"{name:8s} accuracy over slots: ")]
        assert len(summary) == 1 and summary[0].endswith("%"), out
    assert any(ln.startswith("fig7/ds_at_least_competitive,0.0,") for ln in lines)

