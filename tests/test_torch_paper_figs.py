"""Figs. 5, 6, 8 and 9 of the port (``repro_torch.paper.paper_figs``) held
against the JAX package on the same inputs.

  * Paired runs: the jitted JAX ``step`` (``tests/test_torch_datasche.py``'s
    ``_jit_step``, slack-budget waterfill repaired) and the port's ``step``
    run side by side from the JAX initial state (its heterogeneity bridged
    into the port) on the same per-slot network, drawn by the JAX sampler
    from the JAX state as its ``run`` draws it: each figure's specs at the
    testbed scale (eps 0.1 and 0.4; 60 slots, the figures' own count) and
    Fig. 9's specs at ``sim_config(10, 5)`` (20 slots). Each run's 0/1
    decisions (alpha, theta, z) are equal slot by slot; each figure's
    metrics agree within 1e-5 relative plus 1e-5 of the scale of the state
    tensor they read (``tests/test_torch_datasche.py``'s tolerances); the
    figures' checks come out the same in both packages.
  * Whole figures on the port's own random streams at 20 slots, gated only
    on the orderings that hold by a wide margin in the JAX package's own
    60-slot run: NO-LSA's mean per-EC training stdev above DS's (Fig. 6,
    about 4x), DS's unit cost below CU_FULL's at ``sim_config(10, 5)``
    (Fig. 9, 19 %); the paired JAX runs at 20 slots show them too. The two
    packages' streams differ there, so only orderings are compared.

NO-LSA at the testbed scale is ill-conditioned: at slot 14 a one-ulp change
of the slot's inputs moves the port's trained amounts by 1.5e-5 of their
scale, and the JAX package's differ from the port's by 3e-5. The paired run
carries such gaps forward; its decisions stay equal, and the figure metrics
it feeds (the stdevs) stay within the tolerance above.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))  # the JAX package's benchmarks/, not a package of the port

from benchmarks import common as j_common  # noqa: E402
import repro.core as J  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from test_torch_datasche import _jit_het, _jit_sample, _jit_step, _tree  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import CU_FULL, DS, metrics  # noqa: E402
from repro_torch.paper import common, paper_figs  # noqa: E402

FIG_SLOTS = 20
EVENNESS = ("ds", "no-sdc", "no-slt", "no-lsa")  # Figs. 5 and 6
FIG9 = ("ds", "ecfull", "ecself", "cufull")
# (config label, spec): slots of each paired run.
RUNS = {**{("testbed", s): paper_figs.SLOTS for s in EVENNESS + ("l-ds",)},
        **{("testbed_eps0.4", s): paper_figs.SLOTS for s in ("ds", "l-ds")},
        **{("sim_10x5", s): FIG_SLOTS for s in FIG9}}
CONFIGS = {"testbed": ("testbed_config", (), {}),
           "testbed_eps0.4": ("testbed_config", (), {"eps": 0.4}),
           "sim_10x5": ("sim_config", (10, 5), {})}


def _configs(label):
    make, args, kw = CONFIGS[label]
    return getattr(j_common, make)(*args, **kw), getattr(common, make)(*args, **kw)


def _state_tree(state, n_cu, n_ec):
    """JAX state -> numpy tree for the port, the heterogeneity drawn."""
    tree = _tree(state)
    tree.pop("het_key")
    tree["het"] = _tree(_jit_het(state.het_key, n_cu, n_ec))
    return tree


@functools.cache
def _paired(label, name):
    """The paired run of ``name`` at ``label``: (JAX state, port state)
    after the run and after FIG_SLOTS slots, and the decision fields that
    differed, as (slot, field)."""
    cfg_j, cfg_t = _configs(label)
    spec_j, spec_t = J.ALL_SPECS[name], T.ALL_SPECS[name]
    state_j = J.init_state(cfg_j)
    state_t = bridge.from_numpy(_state_tree(state_j, cfg_j.n_cu, cfg_j.n_ec), "cpu")
    flips, at_fig = [], None
    for slot in range(RUNS[(label, name)]):
        _, k_net = jax.random.split(state_j.rng)  # what the JAX step draws with
        net = _jit_sample(k_net, cfg_j.shape, state_j.t, cfg_j.params, het_key=state_j.het_key)
        state_j, _, dec_j = _jit_step(cfg_j.shape, spec_j, state_j, net, cfg_j.params)
        state_t, _, dec_t = T.step(cfg_t, spec_t, state_t, bridge.from_numpy(_tree(net), "cpu"))
        flips += [(slot, f) for f in ("alpha", "theta", "z")
                  if not np.array_equal(getattr(dec_t, f).numpy(), np.asarray(getattr(dec_j, f)))]
        if slot + 1 == FIG_SLOTS:
            at_fig = (state_j, state_t)
    return (state_j, state_t), at_fig, flips


def _figure_metrics(label, name, st, mod, cfg):
    """The metrics the figures read from the run's state ``st`` (package
    ``mod``), each with the scale of the state tensor behind it."""
    omega, uploaded = (np.abs(np.asarray(v, np.float64)).max()
                       for v in (st.queues.omega, st.uploaded))
    out = {}
    if label == "testbed" and name in EVENNESS:  # Figs. 5 and 6
        out["stdev_collection"] = (mod.stdev_collection(st), uploaded)
        out["stdev_training"] = (mod.stdev_training_per_ec(st), omega)
    if label.startswith("testbed") and name in ("ds", "l-ds"):  # Fig. 8
        s = mod.summary(cfg, st)
        out.update({k: (s[k], abs(s[k])) for k in ("avg_cost", "total_trained", "q_backlog",
                                                    "r_backlog", "skew_degree")})
    if label == "sim_10x5":  # Fig. 9
        uc = mod.unit_cost(st)
        out["unit_cost"] = (uc, abs(uc))
    return out


@pytest.mark.parametrize("label,name", list(RUNS), ids=[f"{lb}-{n}" for lb, n in RUNS])
def test_paired_run_matches_jax(label, name):
    (st_j, st_t), _, flips = _paired(label, name)
    assert not flips, f"decisions differ (slot, field): {flips}"
    cfg_j, cfg_t = _configs(label)
    want = _figure_metrics(label, name, st_j, j_metrics, cfg_j)
    got = _figure_metrics(label, name, st_t, metrics, cfg_t)
    assert set(got) == set(want) and want
    for key, (value, scale) in want.items():
        np.testing.assert_allclose(np.asarray(got[key][0], np.float64),
                                   np.asarray(value, np.float64), rtol=1e-5,
                                   atol=1e-5 * scale + 1e-30, err_msg=key)


def _checks(states, mod, label):
    """The figures' checks (``paper_figs``' expressions) on one package's
    paired-run states."""
    if label == "fig5":
        v = {s: mod.stdev_collection(states[("testbed", s)]) for s in EVENNESS}
        return all(v["ds"] < v[k] for k in ("no-sdc", "no-slt", "no-lsa"))
    if label == "fig6":
        v = {s: np.mean(mod.stdev_training_per_ec(states[("testbed", s)])) for s in EVENNESS}
        return bool(v["ds"] <= min(v[k] for k in ("no-sdc", "no-lsa")))
    cfgs = {lb: _configs(lb) for lb in ("testbed", "testbed_eps0.4")}
    s = {(lb, n): mod.summary(cfgs[lb][1 if mod is metrics else 0], states[(lb, n)])
         for lb in cfgs for n in ("ds", "l-ds")}
    return sum([s[("testbed_eps0.4", "ds")]["q_backlog"] < s[("testbed", "ds")]["q_backlog"],
                s[("testbed", "l-ds")]["q_backlog"] < s[("testbed", "ds")]["q_backlog"],
                s[("testbed", "l-ds")]["total_trained"]
                > s[("testbed", "ds")]["total_trained"]])


@pytest.mark.parametrize("fig", ["fig5", "fig6", "fig8"])
def test_figure_checks_equal_jax_on_equal_inputs(fig):
    runs = [r for r in RUNS if r[0].startswith("testbed")]
    states = {r: _paired(*r)[0] for r in runs}
    got = _checks({r: st[1] for r, st in states.items()}, metrics, fig)
    want = _checks({r: st[0] for r, st in states.items()}, j_metrics, fig)
    assert got == want


def test_fig6_no_lsa_less_even_than_ds():
    vals = paper_figs.fig6_training_evenness("cpu", FIG_SLOTS)
    assert set(vals) == set(EVENNESS)
    assert np.mean(vals["no-lsa"]) > np.mean(vals["ds"])
    ref = {s: np.mean(j_metrics.stdev_training_per_ec(_paired("testbed", s)[1][0]))
           for s in ("ds", "no-lsa")}
    assert ref["no-lsa"] > ref["ds"]


def test_fig9_ds_below_cufull():
    costs = paper_figs.fig9_point(common.sim_config(10, 5), "cu10", (DS, CU_FULL), "cpu",
                                  FIG_SLOTS)
    assert np.isfinite(costs["ds"]) and costs["ds"] < costs["cufull"]
    ref = {s: j_metrics.unit_cost(_paired("sim_10x5", s)[1][0]) for s in ("ds", "cufull")}
    assert ref["ds"] < ref["cufull"]
