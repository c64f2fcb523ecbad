"""The paper's scenarios and the figures' output line; the port's copies of
``benchmarks/common.py``'s ``testbed_config``, ``sim_config`` and ``emit``."""
from __future__ import annotations

import numpy as np

from ..core import CocktailConfig


def testbed_config(**overrides) -> CocktailConfig:
    """Paper Sec. IV-A testbed scale: 6 CUs, 3 heterogeneous ECs.

    Unit calibration: the simulator expresses capacities in samples a slot
    rather than kbps, so the paper's raw cost constants (c = 250) would
    price transmission above the queue-relief utility and suppress
    collection entirely; c_base = 50 puts the cost / utility ratio in the
    paper's operating regime (all mechanisms bind)."""
    base = dict(n_cu=6, n_ec=3, delta=0.02, eps=0.1, q0=5000.0, zeta=500.0,
                d_base=2000.0, cap_d_base=8000.0,
                f_base=(8000.0, 20000.0, 8000.0),
                c_base=50.0, e_base=50.0, p_base=200.0,
                pair_iters=30, seed=0)
    base.update(overrides)
    return CocktailConfig(**base)


def sim_config(n_cu=20, n_ec=5, **overrides) -> CocktailConfig:
    """Paper Sec. IV-C simulation scale; the EC speeds are drawn from
    ``default_rng(0)`` over the four EC classes, as the JAX package draws
    them."""
    base = dict(n_cu=n_cu, n_ec=n_ec, delta=0.0001, eps=0.2, q0=5000.0,
                zeta=500.0, d_base=2000.0, cap_d_base=8000.0,
                f_base=tuple(float(f) for f in np.random.default_rng(0).choice(
                    [8000, 14000, 20000, 48000], n_ec)),
                c_base=500.0, e_base=30.0, p_base=100.0,
                pair_iters=30, seed=0)
    base.update(overrides)
    return CocktailConfig(**base)


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")

