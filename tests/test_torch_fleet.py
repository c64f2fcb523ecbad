"""Fleets of the PyTorch port (``core/fleet.py``, ``core/job.py``) and its
per-slice (SWITCHED) dispatch.

Against the JAX package: teacher-forced fleet slots. The same stacked
state, network and params (made from a numpy seed and the JAX sampler) go
through ``jax.vmap`` of the JAX ``step`` and through the port's
``FleetEngine.step``, two slots in a row (the second from JAX's next
state), at the slot rule of ``tests/test_torch_datasche.py``: 0/1
decisions equal, floats within 1e-5 relative plus 1e-5 of each slice's
largest magnitude; the JAX side runs with the slack-budget waterfill
repaired, as there.

Inside the port: a fleet slice is its own single-slice run. The slot's
body is one function over a leading slice axis, so a K = 1 fleet and
``SWITCHED`` on one slice equal their single-slice runs bit for bit;
slices of a K = 3 fleet and padded slices are held within rtol 1e-6
(reductions over other shapes may round in another order).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import datasche as JD  # noqa: E402
from repro.core import training_alloc as JTA  # noqa: E402
from repro.core.network import heterogeneity as j_heterogeneity  # noqa: E402
from repro.core.network import sample_network_state as j_sample  # noqa: E402
from repro.core.types import het_key_from_seed  # noqa: E402
from test_torch_datasche import _assert_close, _assert_decisions_equal, _tree  # noqa: E402
from test_torch_training_alloc import repaired_jax_waterfill  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.core.fleet import slice_records, trim_state, unstack  # noqa: E402
from repro_torch.kernels.matching import ops as matching_ops  # noqa: E402

N, M = 10, 4
SLOTS = 6
JITTABLE = [n for n, s in T.ALL_SPECS.items() if not s.exact]


def _configs(core, n=N, m=M):
    """Three slices of one shape with different rates, costs, budgets and
    seeds (``core`` is either package)."""
    base = core.CocktailConfig(n_cu=n, n_ec=m, eps=0.1, pair_iters=15, seed=7)
    return [base,
            dataclasses.replace(base, eps=0.2, seed=11,
                                zeta=np.array([300.0] * (n // 2) + [900.0] * (n - n // 2))),
            dataclasses.replace(base, c_base=100.0, p_base=300.0, seed=12,
                                f_base=tuple(16000.0 + 4000.0 * j for j in range(m)))]


# Shared with JAX's tests/test_policy_switch.py: >= 3 specs, ragged shapes.
def _mixed_jobs(core):
    base = core.CocktailConfig(n_cu=6, n_ec=3, eps=0.1, pair_iters=15, seed=7,
                               f_base=(8000.0, 20000.0, 12000.0))
    return [core.SliceJob(base, core.DS, name="prod/ds"),
            core.SliceJob(core.CocktailConfig(n_cu=8, n_ec=4, pair_iters=15, seed=1,
                                              zeta=800.0), core.NO_SDC, name="canary/no-sdc"),
            core.SliceJob(dataclasses.replace(base, eps=0.2, seed=2), core.LDS),
            core.SliceJob(core.CocktailConfig(n_cu=5, n_ec=2, pair_iters=15, seed=3), core.NO_LSA),
            core.SliceJob(dataclasses.replace(base, seed=4), core.EC_SELF)]


def _noaid_jobs(core):
    base = core.CocktailConfig(n_cu=6, n_ec=3, eps=0.1, pair_iters=15, seed=7,
                               f_base=(8000.0, 20000.0, 12000.0))
    specs = (core.DS, core.NO_SDC, core.EC_SELF, core.CU_FULL, core.EC_FULL, core.NO_SLT)
    return [core.SliceJob(dataclasses.replace(base, seed=s), spec)
            for s, spec in enumerate(specs)]


# --------------------------------------------------------------------------
# Teacher-forced fleet slots against jax.vmap of the JAX step
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fleet_step(shape, spec):
    def one(params, state, net):
        with mock.patch.object(JTA, "solo_waterfill", repaired_jax_waterfill):
            return JD.step(shape, spec, state, net, params)
    return jax.jit(jax.vmap(one))


_jit_sample = jax.jit(j_sample, static_argnums=(1,))


def _warm_states(params_j, shape, true_shapes, seed=0):
    """A stacked mid-run JAX state: backlogs and multipliers in the ranges
    a run reaches on each slice's true block, zero on its padding."""
    rng = np.random.default_rng(seed)
    n, m = shape.n_cu, shape.n_ec
    states = []
    for k, (tn, tm) in enumerate(true_shapes):
        def u(lo, hi, *s):
            a = np.zeros(s, np.float32)
            a[tuple(slice(0, t) for t in (tn, tm)[:len(s)])] = \
                rng.uniform(lo, hi, (tn, tm)[:len(s)])
            return jnp.asarray(a)

        def mults():
            return J.Multipliers(mu=u(800, 2500, n), eta=u(0, 400, n, m),
                                 phi=u(0, 30, n, m), lam=u(0, 30, n, m))
        states.append(J.SchedulerState(
            queues=J.QueueState(q=u(1000, 8000, n), r=u(0, 2500, n, m), omega=u(0, 5e4, n, m)),
            mults=mults(), emp_mults=mults(), t=jnp.asarray(5 + k, jnp.int32),
            total_cost=jnp.asarray(rng.uniform(1e6, 2e6), jnp.float32),
            total_trained=jnp.asarray(rng.uniform(1e4, 2e4), jnp.float32),
            uploaded=u(0, 1e4, n), rng=jax.random.PRNGKey(seed + k),
            het_key=het_key_from_seed(seed + k)))
    return jax.tree.map(lambda *ls: jnp.stack(ls), *states)


def _state_tree(state, shape):
    """Stacked JAX state -> numpy tree for the port: each slice's het_key
    becomes the four heterogeneity arrays it draws."""
    tree = _tree(state)
    tree.pop("het_key")
    het = jax.vmap(lambda key: j_heterogeneity(key, shape.n_cu, shape.n_ec))(state.het_key)
    tree["het"] = _tree(het)
    return tree


def _check_fleet_slots(shape, spec_j, spec_t, params_j, true_shapes):
    """Two teacher-forced fleet slots: the port's FleetEngine.step against
    the JAX step vmapped over the slices, slice by slice."""
    k_slices = len(true_shapes)
    params_t = bridge.from_numpy(_tree(params_j), "cpu")
    engine = T.FleetEngine.from_params(T.ShapeConfig(shape.n_cu, shape.n_ec, shape.pair_iters),
                                       params_t, spec_t)
    state = _warm_states(params_j, shape, true_shapes)
    jstep = _jax_fleet_step(shape, spec_j)
    for slot in range(2):
        nets = [_jit_sample(jax.random.PRNGKey(100 + 10 * k + slot), shape, state.t[k],
                            jax.tree.map(lambda leaf: leaf[k], params_j),
                            het_key=state.het_key[k]) for k in range(k_slices)]
        net = jax.tree.map(lambda *ls: jnp.stack(ls), *nets)
        new_j, rec_j, dec_j = jstep(params_j, state, net)
        new_t, rec_t, dec_t = engine.step(bridge.from_numpy(_state_tree(state, shape), "cpu"),
                                          bridge.from_numpy(_tree(net), "cpu"))
        for k in range(k_slices):
            tag = f"slot {slot} slice {k}"
            _assert_decisions_equal(unstack(dec_t, k), jax.tree.map(lambda x: x[k], dec_j))
            for f in ("x", "y"):
                _assert_close(f"{tag} dec.{f}", getattr(dec_t, f)[k], getattr(dec_j, f)[k])
            for f in rec_j._fields:
                _assert_close(f"{tag} rec.{f}", getattr(rec_t, f)[k], getattr(rec_j, f)[k])
            for grp in ("queues", "mults", "emp_mults"):
                for f in getattr(new_j, grp)._fields:
                    _assert_close(f"{tag} {grp}.{f}", getattr(getattr(new_t, grp), f)[k],
                                  getattr(getattr(new_j, grp), f)[k])
            for f in ("t", "total_cost", "total_trained", "uploaded"):
                _assert_close(f"{tag} {f}", getattr(new_t, f)[k], getattr(new_j, f)[k])
        assert float(jnp.sum(dec_j.alpha)) > 0
        state = new_j


@pytest.mark.parametrize("name", JITTABLE)
def test_teacher_forced_fleet_slots_match_jax_vmap(name):
    cfgs = _configs(J)
    params_j = J.stack_slice_params([c.params for c in cfgs])
    _check_fleet_slots(cfgs[0].shape, J.ALL_SPECS[name], T.ALL_SPECS[name], params_j,
                       [(N, M)] * len(cfgs))


@pytest.mark.parametrize("jobs, switch", [(_mixed_jobs, "switched"),
                                          (_noaid_jobs, "switched-noaid")],
                         ids=["mixed_ragged", "mixed_noaid"])
def test_teacher_forced_switched_fleet_slots_match_jax_vmap(jobs, switch):
    """A mixed-policy fleet (ragged, with an L-DS slice: SWITCHED; or six
    policies and no L-DS: SWITCHED_NOAID) against JAX's vmapped
    ``lax.switch`` step. The port's from_jobs builds the params and picks
    the dispatch as JAX's does."""
    eng_j = J.FleetEngine.from_jobs(jobs(J))
    eng_t = T.FleetEngine.from_jobs(jobs(T), device="cpu")
    assert eng_j.spec.name == eng_t.spec.name == switch
    for f, a in zip(T.SliceParams._fields, eng_t.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(eng_j.params, f)), err_msg=f)
    spec_t = T.SWITCHED if switch == "switched" else T.SWITCHED_NOAID
    _check_fleet_slots(eng_j.shape, eng_j.spec, spec_t, eng_j.params,
                       [(j.config.n_cu, j.config.n_ec) for j in jobs(J)])


# --------------------------------------------------------------------------
# Fleets against the port's own single-slice runs
# --------------------------------------------------------------------------

def _assert_records(got, want, exact, what):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if exact:
            assert torch.equal(a, b), f"{what}: record {f}"
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=f"{what}: {f}")


def _assert_states(got, want, exact, what):
    for grp in ("queues", "mults", "emp_mults"):
        for f in getattr(want, grp)._fields:
            a, b = getattr(getattr(got, grp), f), getattr(getattr(want, grp), f)
            if exact:
                assert torch.equal(a, b), f"{what}: {grp}.{f}"
            else:
                scale = float(b.abs().max())
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6 * scale,
                                           err_msg=f"{what}: {grp}.{f}")
    for f in ("t", "total_cost", "total_trained", "uploaded"):
        a, b = getattr(got, f), getattr(want, f)
        if exact:
            assert torch.equal(a, b), f"{what}: {f}"
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("name", ["ds", "l-ds", "no-lsa"])
def test_k1_fleet_equals_run(name):
    cfg = _configs(T)[1]
    spec = T.ALL_SPECS[name]
    st, recs = T.FleetEngine.from_configs([cfg], spec, device="cpu").run(SLOTS)
    assert recs.cost.shape == (SLOTS, 1)
    st_ref, recs_ref = T.run(cfg, spec, SLOTS, device="cpu")
    _assert_records(slice_records(recs, 0), recs_ref, True, name)
    _assert_states(unstack(st, 0), st_ref, True, name)


@pytest.mark.parametrize("name", ["ds", "l-ds"])
def test_k3_fleet_slices_equal_standalone_runs(name):
    cfgs = _configs(T)
    spec = T.ALL_SPECS[name]
    eng = T.FleetEngine.from_configs(cfgs, spec, device="cpu")
    assert eng.spec == spec and eng.plan is None and eng.n_slices == 3
    st, recs = eng.run(SLOTS)
    assert recs.cost.shape == (SLOTS, 3)
    for k, cfg in enumerate(cfgs):
        st_ref, recs_ref = T.run(cfg, spec, SLOTS, device="cpu")
        assert float(recs_ref.r_backlog[-1]) > 0  # data was collected
        _assert_records(slice_records(recs, k), recs_ref, False, f"slice {k}")
        _assert_states(eng.slice_state(st, k), st_ref, False, f"slice {k}")


@pytest.mark.parametrize("name", ["ds", "l-ds"])
def test_ragged_fleet_slices_equal_unpadded_runs(name):
    spec = T.ALL_SPECS[name]
    cfgs = [T.CocktailConfig(n_cu=n, n_ec=m, pair_iters=15, seed=s, zeta=400.0 + 50 * s)
            for s, (n, m) in enumerate([(10, 4), (7, 3), (4, 2)])]
    eng = T.FleetEngine.from_ragged_configs(cfgs, spec, device="cpu")
    assert eng.shape == T.ShapeConfig(10, 4, 15)
    st, recs = eng.run(SLOTS)
    for k, cfg in enumerate(cfgs):
        st_ref, recs_ref = T.run(cfg, spec, SLOTS, device="cpu")
        _assert_records(slice_records(recs, k), recs_ref, False, f"slice {k}")
        sk = eng.slice_state(st, k)
        assert sk.queues.r.shape == (cfg.n_cu, cfg.n_ec)
        _assert_states(sk, st_ref, False, f"slice {k}")
        for a, b in zip(sk.het, st_ref.het):  # the true block of the padded draw
            assert torch.equal(a, b)


def test_mixed_policy_ragged_fleet_slices_equal_standalone_runs():
    jobs = _mixed_jobs(T)
    eng = T.FleetEngine.from_jobs(jobs, device="cpu")
    assert eng.spec == T.SWITCHED and eng.shape == T.ShapeConfig(8, 4, 15)
    assert eng.plan == ((0, 1, 0, 0, 0), (0, 0, 0, 0, 2), (False, False, True, False, False))
    st, recs = eng.run(SLOTS)
    for k, job in enumerate(jobs):
        st_ref, recs_ref = T.run(job.config, job.spec, SLOTS, device="cpu")
        _assert_records(slice_records(recs, k), recs_ref, False, job.spec.name)
        _assert_states(eng.slice_state(st, k), st_ref, False, job.spec.name)


def test_mixed_noaid_fleet_slices_equal_standalone_runs():
    jobs = _noaid_jobs(T)
    eng = T.FleetEngine.from_jobs(jobs, device="cpu")
    assert eng.spec == T.SWITCHED_NOAID
    st, recs = eng.run(SLOTS)
    for k, job in enumerate(jobs):
        st_ref, recs_ref = T.run(job.config, job.spec, SLOTS, device="cpu")
        _assert_records(slice_records(recs, k), recs_ref, False, job.spec.name)
        _assert_states(eng.slice_state(st, k), st_ref, False, job.spec.name)


def _switched_run(cfg, spec, switch=T.SWITCHED, pad=None):
    shape = cfg.shape if pad is None else pad
    params = T.with_policy(T.SliceParams.from_config(cfg, pad_shape=pad, device="cpu"), spec)
    return T.run(shape, switch, SLOTS, state=T.init_state(shape, params, seed=cfg.seed),
                 params=params)


@pytest.mark.parametrize("name", JITTABLE)
def test_switched_single_slice_equals_static_bitexact(name):
    cfg, spec = _configs(T)[1], T.ALL_SPECS[name]
    st_ref, recs_ref = T.run(cfg, spec, SLOTS, device="cpu")
    for switch in (T.SWITCHED, T.SWITCHED_NOAID) if not spec.learning_aid else (T.SWITCHED,):
        st, recs = _switched_run(cfg, spec, switch)
        _assert_records(recs, recs_ref, True, f"{name} {switch.name}")
        _assert_states(st, st_ref, True, f"{name} {switch.name}")


@pytest.mark.parametrize("name", ["ds", "l-ds", "no-lsa"])
def test_switched_composes_with_padding(name):
    """SWITCHED on a padded slice equals the static spec on the same padded
    slice bit for bit, and the unpadded run within rtol 1e-6."""
    cfg, spec = _configs(T)[0], T.ALL_SPECS[name]
    pad = T.ShapeConfig(13, 6, cfg.pair_iters)
    st, recs = _switched_run(cfg, spec, pad=pad)
    params = T.SliceParams.from_config(cfg, pad_shape=pad, device="cpu")
    st_pad, recs_pad = T.run(pad, spec, SLOTS, state=T.init_state(pad, params, seed=cfg.seed),
                             params=params)
    _assert_records(recs, recs_pad, True, name)
    _assert_states(st, st_pad, True, name)
    st_ref, recs_ref = T.run(cfg, spec, SLOTS, device="cpu")
    _assert_records(recs, recs_ref, False, name)
    _assert_states(trim_state(st, cfg.shape), st_ref, False, name)


def test_switched_requires_policy_leaves():
    cfg = _configs(T)[0]
    params = T.SliceParams.from_config(cfg, device="cpu")._replace(
        collect_id=None, train_id=None, use_lsa=None, learning_aid=None)
    state = T.init_state(cfg.shape, params, seed=0)
    with pytest.raises(TypeError, match="policy leaves"):
        T.step(cfg.shape, T.SWITCHED, state, params=params)


def test_with_policy_leaves():
    p = T.with_policy(T.SliceParams.from_config(_configs(T)[0], device="cpu"), T.NO_SDC)
    assert (int(p.collect_id), int(p.train_id)) == (1, 0)
    assert float(p.use_lsa) == 1.0 and float(p.learning_aid) == 0.0
    with pytest.raises(ValueError, match="exact"):
        T.with_policy(p, T.DS_EXACT)
    with pytest.raises(ValueError, match="concrete"):
        T.with_policy(p, T.SWITCHED)


# --------------------------------------------------------------------------
# The sampler over a (K,) seed tensor
# --------------------------------------------------------------------------

def test_stacked_sampler_draws_each_slice_bit_for_bit():
    """Slice k of a (K,)-seeded draw is its single-slice draw: the 32-bit
    words, the heterogeneity and the network state, at the padded shape
    too (true block)."""
    seeds, ts = [3, 2 ** 40 + 5, 17], [0, 4, 9]
    draws = network.slot_draws(N, M)
    bits = network.uniform_bits(torch.tensor(seeds), torch.tensor(ts), draws)
    assert bits.shape[0] == 3
    het = network.heterogeneity(torch.tensor(seeds), N, M)
    cfgs = _configs(T)
    pad = T.ShapeConfig(N + 3, M + 2)
    params = T.stack_slice_params([T.SliceParams.from_config(c, pad_shape=pad, device="cpu")
                                   for c in cfgs])
    het_pad = network.heterogeneity(torch.tensor(seeds), pad.n_cu, pad.n_ec)
    net = network.sample_network_state(torch.tensor(seeds), pad, torch.tensor(ts), params,
                                       het=het_pad)
    for k, (seed, t) in enumerate(zip(seeds, ts)):
        assert torch.equal(bits[k], network.uniform_bits(seed, t, draws, device="cpu"))
        one_het = network.heterogeneity(seed, N, M, device="cpu")
        for a, b in zip(unstack(het, k), one_het):
            assert torch.equal(a, b)
        one = network.sample_network_state(seed, cfgs[k], torch.tensor(t), het=one_het,
                                           device="cpu")
        for f in one._fields:
            a, b = getattr(net, f)[k], getattr(one, f)
            assert torch.equal(a[tuple(slice(0, s) for s in b.shape)], b), f


# --------------------------------------------------------------------------
# One matcher call per policy group, whatever K is
# --------------------------------------------------------------------------

def _count_matcher_calls(run):
    counts = {"greedy_collection": 0, "greedy_assignment": 0, "greedy_pairing": 0}
    patches = []
    for name in counts:
        def counted(*args, _name=name, _fn=getattr(matching_ops, name), **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        patches.append(mock.patch.object(matching_ops, name, counted))
    for p in patches:
        p.start()
    try:
        run()
    finally:
        for p in patches:
            p.stop()
    return counts


@pytest.mark.parametrize("name, per_slot", [
    ("ds", {"greedy_collection": 1, "greedy_assignment": 0, "greedy_pairing": 1}),
    ("l-ds", {"greedy_collection": 1, "greedy_assignment": 1, "greedy_pairing": 2})])
def test_matcher_calls_per_slot_do_not_depend_on_k(name, per_slot):
    spec = T.ALL_SPECS[name]
    for k in (1, 3):
        eng = T.FleetEngine.from_configs(_configs(T)[:k], spec, device="cpu")
        got = _count_matcher_calls(lambda: eng.run(2))
        assert got == {op: 2 * c for op, c in per_slot.items()}, k


def test_matcher_calls_of_a_mixed_fleet_are_one_per_policy_group():
    """Eight slices, one per spec but ecfull: collection groups skew (6
    slices), plain (no-sdc) and cufull (no matcher); training groups skew
    (6), linear (no-slt) and solo (ecself); the L-DS virtual path. Twice the
    slices, the same calls."""
    base = T.CocktailConfig(n_cu=6, n_ec=3, pair_iters=10)
    names = ["ds", "l-ds", "no-sdc", "no-slt", "no-lsa", "greedy", "ecself", "cufull"]
    want = {"greedy_collection": 1, "greedy_assignment": 2, "greedy_pairing": 3}
    for copies in (1, 2):
        jobs = [T.SliceJob(dataclasses.replace(base, seed=s), T.ALL_SPECS[n])
                for s, n in enumerate(names * copies)]
        eng = T.FleetEngine.from_jobs(jobs, device="cpu")
        assert _count_matcher_calls(lambda: eng.run(1)) == want


# --------------------------------------------------------------------------
# Construction and validation (JAX tests/test_policy_switch.py, test_fleet.py)
# --------------------------------------------------------------------------

def test_from_jobs_homogeneous_policy_stays_static():
    cfgs = _configs(T)[:2]
    eng = T.FleetEngine.from_jobs([T.SliceJob(cfgs[0], T.DS), T.SliceJob(cfgs[1], T.GREEDY)],
                                  device="cpu")
    assert eng.spec == T.DS and eng.plan is None
    shim = T.FleetEngine.from_configs(cfgs, T.DS, device="cpu")
    for a, b in zip(eng.params, shim.params):
        assert torch.equal(a, b)


def test_from_jobs_accepts_bare_configs_and_rejects_bad_jobs():
    cfgs = _configs(T)[:2]
    eng = T.FleetEngine.from_jobs(cfgs, T.NO_LSA, device="cpu")
    assert eng.spec == T.NO_LSA and eng.n_slices == 2 and eng.seeds == (7, 11)
    with pytest.raises(ValueError):
        T.FleetEngine.from_jobs([], device="cpu")
    with pytest.raises(ValueError, match="exact"):
        T.SliceJob(cfgs[0], T.DS_EXACT)
    with pytest.raises(ValueError, match="concrete"):
        T.SliceJob(cfgs[0], T.SWITCHED)
    with pytest.raises(TypeError):
        T.FleetEngine.from_jobs(["not-a-job"], device="cpu")
    with pytest.raises(ValueError, match="share one ShapeConfig"):
        T.FleetEngine.from_configs([cfgs[0], dataclasses.replace(cfgs[0], n_cu=N + 1)],
                                   device="cpu")
    with pytest.raises(ValueError, match="exact"):
        T.FleetEngine.from_configs(cfgs, T.DS_EXACT, device="cpu")
    assert T.SliceJob(cfgs[0], seed=42).resolved_seed == 42
    assert T.FleetEngine.from_jobs([T.SliceJob(cfgs[0], seed=42)], device="cpu").seeds == (42,)


def test_ragged_fleet_rejects_mismatched_pair_iters():
    a = T.CocktailConfig(n_cu=6, n_ec=3, pair_iters=15)
    with pytest.raises(ValueError, match="pair_iters"):
        T.FleetEngine.from_ragged_configs([a, dataclasses.replace(a, n_cu=8, pair_iters=20)],
                                          device="cpu")


def test_from_params_validation():
    params = [T.SliceParams.from_config(c, device="cpu") for c in _configs(T)[:2]]
    shape = T.ShapeConfig(N, M, 15)
    with pytest.raises(ValueError, match="unstacked"):
        T.FleetEngine.from_params(shape, params[0], T.DS)
    stacked = T.stack_slice_params(params)
    with pytest.raises(ValueError, match="zeta"):
        T.FleetEngine.from_params(shape, stacked._replace(zeta=stacked.zeta[:1]), T.DS)
    with pytest.raises(ValueError, match="seeds"):
        T.FleetEngine.from_params(shape, stacked, T.DS, seeds=(1,))
    eng = T.FleetEngine.from_params(shape, stacked, T.DS, seeds=(1, 2))
    st, recs = eng.run(2)
    assert recs.cost.shape == (2, 2)
    np.testing.assert_allclose(eng.params.eps.numpy(), [0.1, 0.2], rtol=1e-6)
    switched = T.FleetEngine.from_params(shape, T.stack_slice_params(
        [T.with_policy(params[0], T.NO_SDC), T.with_policy(params[1], T.LDS)]), T.SWITCHED)
    assert switched.plan == ((1, 0), (0, 0), (False, True))


def test_run_with_a_mesh_raises():
    """A mesh axis whose size does not divide K raises before any slot (the
    sharded run itself: tests/test_torch_distributed.py)."""
    eng = T.FleetEngine.from_configs(_configs(T), device="cpu")  # K = 3
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 1))
    with pytest.raises(ValueError, match="3 slices do not divide over the 2 ranks"):
        eng.run(1, mesh=mesh)


def test_fleet_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: from_jobs defaults to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.FleetEngine.from_jobs(_configs(T))


def test_bridge_converts_stacked_jax_states():
    """A stacked (K, 2) JAX key becomes K run seeds, one per slice, as each
    slice's own key converts alone; other leaves keep their K axis."""
    cfgs = _configs(J)
    params_j = J.stack_slice_params([c.params for c in cfgs])
    state = _warm_states(params_j, cfgs[0].shape, [(N, M)] * 3)
    st = bridge.from_numpy(_state_tree(state, cfgs[0].shape), "cpu")
    assert st.rng.shape == (3,) and st.het.link_het.shape == (3, N, M)
    tree = _state_tree(state, cfgs[0].shape)

    def take(t, k):
        return {f: take(v, k) if isinstance(v, dict) else np.asarray(v)[k]
                for f, v in t.items()}
    for k in range(3):
        one = bridge.from_numpy(take(tree, k), "cpu")
        assert one.rng.shape == () and int(st.rng[k]) == int(one.rng)
    back = bridge.to_numpy(st)
    assert back["rng"].dtype == np.int64 and back["rng"].shape == (3,)
    assert torch.equal(bridge.from_numpy(back, "cpu").rng, st.rng)


# --------------------------------------------------------------------------
# The port's examples
# --------------------------------------------------------------------------

@pytest.mark.parametrize("example", ["fleet_multi_slice", "ragged_fleet", "mixed_policy_fleet"])
def test_example_runs_on_the_cpu(example):
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src, "COCKTAIL_EXAMPLE_SLOTS": "2"}
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{example}",
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         check=True, timeout=300).stdout
    assert "x 2 slots on cpu" in out and out.splitlines()[-1].endswith(("(2, 5)", "(2, 3)"))
