"""One scheduler slot of the PyTorch port held against the JAX package.

Teacher forcing: a warm ``SchedulerState`` made from a numpy seed and a
``NetworkState`` drawn by the JAX sampler go through the JAX ``step`` and,
via ``repro_torch.bridge.from_numpy``, through the port's ``step``; the
``Decision``, the ``SlotRecord`` and the next state are compared, for two
slots in a row (the second starts from the JAX package's next state).

0/1 decisions (alpha, theta = 1/n_j, z) must be equal. Floats must agree
within 1e-5 relative plus 1e-5 of each tensor's largest magnitude: XLA and
PyTorch reduce sums in different orders, round log/exp differently in the
last ulp and XLA may fuse multiply-adds, and updates such as
eta + eps * (served - dep_r) cancel to values far below the operands'
scale, where that last-bit noise is all that is left.

One defect is the reference's: when an EC's budget covers all of its active
queues, the JAX ``solo_waterfill`` finds the fill level only if its ``sum``
and ``cumsum`` round alike, and otherwise trains nothing there; the port
fills every such queue (ROADMAP.md, Queue 3). The JAX side therefore runs
with that one function repaired (``repaired_jax_waterfill``, which returns
the reference's own answer everywhere else), and every output is compared.
"""
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import datasche as JD  # noqa: E402
from repro.core.network import heterogeneity as j_heterogeneity  # noqa: E402
from repro.core.network import sample_network_state as j_sample  # noqa: E402
from repro.core import training_alloc as JTA  # noqa: E402
from repro.core.types import het_key_from_seed  # noqa: E402
from test_torch_training_alloc import repaired_jax_waterfill  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import metrics, oracle  # noqa: E402

N, M = 10, 4
CFG_J = J.CocktailConfig(n_cu=N, n_ec=M, seed=0)
CFG_T = T.CocktailConfig(n_cu=N, n_ec=M, seed=0)
SPECS = ["ds", "ds-exact", "l-ds", "no-sdc", "no-slt", "no-lsa", "ecfull", "ecself", "cufull"]


def _step_repaired(cfg, spec, state, net, params=None):
    """The JAX ``step``, traced with the slack-budget waterfill repaired."""
    with mock.patch.object(JTA, "solo_waterfill", repaired_jax_waterfill):
        return JD.step(cfg, spec, state, net, params)


_jit_step = jax.jit(_step_repaired, static_argnums=(0, 1))
_jit_sample = jax.jit(j_sample, static_argnums=(1,))
_jit_het = jax.jit(j_heterogeneity, static_argnums=(1, 2))


def _tree(obj):
    if hasattr(obj, "_fields"):
        return {f: _tree(getattr(obj, f)) for f in obj._fields}
    return None if obj is None else np.asarray(obj)


def _state_tree(state):
    """JAX state -> numpy tree for the port: het_key becomes the four
    heterogeneity arrays it draws."""
    tree = _tree(state)
    tree.pop("het_key")
    tree["het"] = _tree(_jit_het(state.het_key, N, M))
    return tree


def _warm_state(seed=0):
    """A mid-run state: backlogs, multipliers and empirical multipliers in
    the ranges a run reaches, so every policy has positive weights to use."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: jnp.asarray(rng.uniform(lo, hi, s), jnp.float32)  # noqa: E731

    def mults():
        return J.Multipliers(mu=u(800, 2500, N), eta=u(0, 400, N, M),
                             phi=u(0, 30, N, M), lam=u(0, 30, N, M))
    return J.SchedulerState(
        queues=J.QueueState(q=u(1000, 8000, N), r=u(0, 2500, N, M), omega=u(0, 5e4, N, M)),
        mults=mults(), emp_mults=mults(), t=jnp.asarray(5, jnp.int32),
        total_cost=u(1e6, 2e6), total_trained=u(1e4, 2e4), uploaded=u(0, 1e4, N),
        rng=jax.random.PRNGKey(seed), het_key=het_key_from_seed(seed))


def _assert_close(name, port, ref):
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    scale = np.abs(ref).max() if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5 * scale + 1e-30, err_msg=name)


def _assert_decisions_equal(dec_t, dec_j):
    for f in ("alpha", "theta", "z"):
        got, want = getattr(dec_t, f).numpy(), np.asarray(getattr(dec_j, f))
        flips = np.argwhere(got != want)
        assert flips.size == 0, (f"{f} flips at {flips.tolist()}: port "
                                 f"{got[tuple(flips.T)]}, JAX {want[tuple(flips.T)]}")


def _check_teacher_forced(name, spec_j, spec_t, params_j=None, params_t=None):
    """Two teacher-forced slots of ``spec_j`` (JAX) and ``spec_t`` (port),
    run on ``params_j`` / ``params_t`` (the config's when None)."""
    state = _warm_state()
    for slot in range(2):
        net = _jit_sample(jax.random.PRNGKey(100 + slot), CFG_J.shape, state.t, CFG_J.params,
                          het_key=state.het_key)
        # An exact spec calls its host-side oracles on concrete arrays: no jit.
        jax_step = _step_repaired if spec_j.exact else _jit_step
        new_j, rec_j, dec_j = jax_step(CFG_J, spec_j, state, net, params_j)
        new_t, rec_t, dec_t = T.step(CFG_T, spec_t, bridge.from_numpy(_state_tree(state), "cpu"),
                                     bridge.from_numpy(_tree(net), "cpu"), params_t)
        _assert_decisions_equal(dec_t, dec_j)
        assert float(dec_j.alpha.sum()) > 0 or name == "cufull"
        for f in ("x", "y"):
            _assert_close(f"slot {slot} dec.{f}", getattr(dec_t, f), getattr(dec_j, f))
        for f in rec_j._fields:
            _assert_close(f"slot {slot} rec.{f}", getattr(rec_t, f), getattr(rec_j, f))
        for grp in ("queues", "mults", "emp_mults"):
            for f in getattr(new_j, grp)._fields:
                _assert_close(f"slot {slot} {grp}.{f}", getattr(getattr(new_t, grp), f),
                              getattr(getattr(new_j, grp), f))
        for f in ("t", "total_cost", "total_trained", "uploaded"):
            _assert_close(f"slot {slot} {f}", getattr(new_t, f), getattr(new_j, f))
        state = new_j


@pytest.mark.parametrize("name", SPECS)
def test_teacher_forced_slots_match_jax(name):
    _check_teacher_forced(name, J.ALL_SPECS[name], T.ALL_SPECS[name])


JITTABLE = [n for n, s in T.ALL_SPECS.items() if not s.exact]
# SWITCHED_NOAID ignores the learning-aid leaf, so L-DS runs under SWITCHED only.
SWITCHED_CASES = ([(n, "switched") for n in JITTABLE]
                  + [(n, "switched-noaid") for n in JITTABLE if not T.ALL_SPECS[n].learning_aid])


@pytest.mark.parametrize("name, switch", SWITCHED_CASES)
def test_switched_teacher_forced_slots_match_jax(name, switch):
    """Per-slice dispatch: a slice whose policy leaves name ``name`` runs
    under SWITCHED / SWITCHED_NOAID as the JAX package's ``lax.switch``
    step does."""
    spec_j = J.SWITCHED if switch == "switched" else J.SWITCHED_NOAID
    spec_t = T.SWITCHED if switch == "switched" else T.SWITCHED_NOAID
    params_j = JD.with_policy(CFG_J.params, J.ALL_SPECS[name])
    params_t = T.with_policy(T.SliceParams.from_config(CFG_T, device="cpu"), T.ALL_SPECS[name])
    _check_teacher_forced(name, spec_j, spec_t, params_j, params_t)


def test_lds_virtual_step_moves_only_empirical_multipliers():
    state = bridge.from_numpy(_state_tree(_warm_state(1)), "cpu")
    ds, _, dec_ds = T.step(CFG_T, T.DS, state._replace(emp_mults=state.mults))
    # With Theta' = Theta the L-DS schedule uses Theta + Theta - pi; its
    # real queues evolve from its own decision, its Theta' from the virtual one.
    lds, _, _ = T.step(CFG_T, T.LDS, state)
    assert not torch.equal(lds.emp_mults.eta, state.emp_mults.eta)
    assert torch.equal(ds.emp_mults.eta, state.mults.eta)


def test_slot_network_is_the_network_step_samples():
    state = bridge.from_numpy(_state_tree(_warm_state(5)), "cpu")
    net = T.slot_network(CFG_T, state)
    again = T.slot_network(CFG_T, state)  # a pure function of the state
    for f in net._fields:
        assert torch.equal(getattr(net, f), getattr(again, f)), f
    _, rec_a, dec_a = T.step(CFG_T, T.LDS, state)
    _, rec_b, dec_b = T.step(CFG_T, T.LDS, state, net)
    for a, b in ((dec_a, dec_b), (rec_a, rec_b)):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_exact_spec_uses_the_oracle():
    state = bridge.from_numpy(_state_tree(_warm_state(2)), "cpu")
    net = T.sample_network_state(3, CFG_T, state.t, het=state.het, device="cpu")
    _, _, dec = T.step(CFG_T, T.DS_EXACT, state, net)
    w = T.collection_weights(net, state.mults)
    logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-9)), torch.tensor(float("-inf")))
    alpha, _ = oracle.exact_collection(logw.numpy())
    np.testing.assert_array_equal(dec.alpha.numpy(), alpha)


def test_run_on_cpu_is_finite_and_feasible():
    state, recs = T.run(CFG_T, T.LDS, 4, device="cpu")
    for f in recs._fields:
        v = getattr(recs, f)
        assert v.shape == (4,) and bool(torch.isfinite(v).all()), f
    s = metrics.summary(CFG_T, state)
    assert s["slots"] == 4 and s["total_trained"] > 0 and np.isfinite(s["unit_cost"])
    from repro_torch.configs.cocktail_paper import TESTBED
    st, _ = T.run(TESTBED, T.DS, 2, device="cpu")
    assert int(st.t) == 2


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() defaults to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run(CFG_T, T.DS, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_state(CFG_T)


def test_policy_ids_match_jax():
    assert T.COLLECTION_POLICIES.names == J.COLLECTION_POLICIES.names
    assert T.TRAINING_POLICIES.names == J.TRAINING_POLICIES.names
    assert set(T.ALL_SPECS) == set(J.ALL_SPECS)


def test_bridge_round_trip():
    tree = _state_tree(_warm_state(4))
    back = bridge.to_numpy(bridge.from_numpy(tree, "cpu"))
    for grp in ("queues", "mults", "emp_mults", "het"):
        for f, v in tree[grp].items():
            np.testing.assert_array_equal(back[grp][f], v)
    assert back["t"] == tree["t"] and back["t"].dtype == np.int32
    params = bridge.from_numpy(_tree(CFG_J.params), "cpu")
    assert isinstance(params, T.SliceParams)
    for f in params._fields:
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(CFG_J.params, f)))


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.core.metrics\n"
        "import repro_torch.kernels.matching.ops, repro_torch.configs.cocktail_paper\n"
        "import repro_torch.core.fleet, repro_torch.core.job\n"
        "import repro_torch.examples.fleet_multi_slice, repro_torch.examples.ragged_fleet\n"
        "import repro_torch.examples.mixed_policy_fleet\n"
        "from repro_torch.core import CocktailConfig, DS, FleetEngine, LDS, SliceJob, run\n"
        "run(CocktailConfig(n_cu=6, n_ec=3, pair_iters=10), DS, 1, device='cpu')\n"
        "cfg = CocktailConfig(n_cu=6, n_ec=3, pair_iters=10)\n"
        "FleetEngine.from_jobs([SliceJob(cfg), SliceJob(cfg, LDS)], device='cpu').run(1)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


@pytest.mark.parametrize("name", ["ds", "l-ds"])
@pytest.mark.parametrize("true, pad", [((10, 4), (12, 5)), ((7, 3), (16, 8))], ids=str)
def test_padded_run_matches_unpadded(name, true, pad):
    """A slice zero-padded to a larger shape runs as the slice itself: its
    draws are bit-identical on the true block (keyed sampler), so 4 slots
    of records and the final state agree within rtol 1e-6 (sums over the
    padded axes add exact zeros but may round in another order)."""
    spec = T.ALL_SPECS[name]
    cfg = T.CocktailConfig(n_cu=true[0], n_ec=true[1], seed=5,
                           zeta=np.linspace(300.0, 700.0, true[0]))
    params = T.SliceParams.from_config(cfg, pad_shape=T.ShapeConfig(*pad), device="cpu")
    st, recs = T.run(cfg, spec, 4, device="cpu")
    stp, recsp = T.run(T.ShapeConfig(*pad), spec, 4, params=params,
                       state=T.init_state(T.ShapeConfig(*pad), params, seed=cfg.seed))
    assert float(recs.r_backlog[-1]) > 0  # data was collected (DS may train none yet)
    for f in recs._fields:
        np.testing.assert_allclose(getattr(recsp, f).numpy(), getattr(recs, f).numpy(),
                                   rtol=1e-6, err_msg=f)
    for grp in ("queues", "mults", "emp_mults"):
        for f in getattr(st, grp)._fields:
            a = getattr(getattr(st, grp), f)
            b = getattr(getattr(stp, grp), f)[tuple(slice(0, s) for s in a.shape)]
            scale = float(a.abs().max())
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=f"{grp}.{f}")
