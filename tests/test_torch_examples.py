"""The port's quickstart (``repro_torch.examples.quickstart``) against the
JAX package's ``examples/quickstart.py``.

  * The example itself, on the CPU in a subprocess that blocks JAX and the
    JAX package, at 20 slots: one line a spec and DataSche's unit cost
    below CU_FULL's, the example's claim.
  * The JAX package's ``run`` at the same config and slot count shows the
    same ordering. The two packages' random streams differ, so only the
    ordering is compared, not the numbers.
  * One teacher-forced slot of each of the example's specs (DS, L-DS,
    CU_FULL) at the example's config against the JAX ``step``, by
    ``tests/test_torch_datasche.py``'s slot rule: 0/1 decisions equal,
    floats within 1e-5 relative plus 1e-5 of each tensor's scale.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from repro.core.network import heterogeneity as j_heterogeneity  # noqa: E402
from repro.core.network import sample_network_state as j_sample  # noqa: E402
from repro.core.types import het_key_from_seed  # noqa: E402
from test_torch_datasche import (_assert_close, _assert_decisions_equal,  # noqa: E402
                                 _jit_step, _tree)

import repro_torch.core as T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

SLOTS = 20
CFG_J = J.CocktailConfig(**{f.name: getattr(quickstart.CFG, f.name)
                            for f in dataclasses.fields(J.CocktailConfig)})
N, M = CFG_J.n_cu, CFG_J.n_ec
SPEC_NAMES = [s.name for s in quickstart.SPECS]


def test_config_is_the_jax_examples():
    assert (N, M) == (6, 3) and SPEC_NAMES == ["ds", "l-ds", "cufull"]
    assert dataclasses.asdict(quickstart.CFG) == dataclasses.asdict(CFG_J)


@pytest.fixture(scope="module")
def printed():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src, "COCKTAIL_EXAMPLE_SLOTS": str(SLOTS)}
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None  # the port imports neither\n"
            "runpy.run_module('repro_torch.examples.quickstart', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code, "--device", "cpu"], env=env,
                          capture_output=True, text=True, check=True, timeout=300).stdout


def _unit_costs(out: str) -> dict[str, float]:
    return {m[1]: float(m[2]) for m in re.finditer(r"^(\S+)\s+unit_cost=\s*([0-9.]+) ",
                                                   out, re.MULTILINE)}


def test_quickstart_runs_on_the_cpu(printed):
    assert f"{SLOTS} slots" in printed.splitlines()[0]
    costs = _unit_costs(printed)
    assert list(costs) == SPEC_NAMES
    assert costs["ds"] < costs["cufull"]
    assert "DataSche cost reduction vs CUFull" in printed
    assert '"unit_cost"' in printed


def test_jax_quickstart_shows_the_same_ordering(printed):
    j_costs = {spec.name: j_metrics.unit_cost(J.run(CFG_J, spec, SLOTS)[0])
               for spec in (J.DS, J.CU_FULL)}
    costs = _unit_costs(printed)
    assert (j_costs["ds"] < j_costs["cufull"]) == (costs["ds"] < costs["cufull"]) is True


def _warm_state(seed=0):
    """A mid-run state of the example's shape, in the ranges a run reaches
    (``tests/test_torch_datasche.py``'s warm state at N = 6, M = 3)."""
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


def _state_tree(state):
    tree = _tree(state)
    tree.pop("het_key")
    tree["het"] = _tree(j_heterogeneity(state.het_key, N, M))
    return tree


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_teacher_forced_slot_matches_jax(name):
    state = _warm_state()
    net = j_sample(jax.random.PRNGKey(100), CFG_J.shape, state.t, CFG_J.params,
                   het_key=state.het_key)
    new_j, rec_j, dec_j = _jit_step(CFG_J, J.ALL_SPECS[name], state, net, None)
    new_t, rec_t, dec_t = T.step(quickstart.CFG, T.ALL_SPECS[name],
                                 bridge.from_numpy(_state_tree(state), "cpu"),
                                 bridge.from_numpy(_tree(net), "cpu"))
    _assert_decisions_equal(dec_t, dec_j)
    assert float(dec_j.alpha.sum()) > 0 or name == "cufull"
    for f in ("x", "y"):
        _assert_close(f"dec.{f}", getattr(dec_t, f), getattr(dec_j, f))
    for f in rec_j._fields:
        _assert_close(f"rec.{f}", getattr(rec_t, f), getattr(rec_j, f))
    for grp in ("queues", "mults", "emp_mults"):
        for f in getattr(new_j, grp)._fields:
            _assert_close(f"{grp}.{f}", getattr(getattr(new_t, grp), f),
                          getattr(getattr(new_j, grp), f))
    for f in ("t", "total_cost", "total_trained", "uploaded"):
        _assert_close(f, getattr(new_t, f), getattr(new_j, f))
