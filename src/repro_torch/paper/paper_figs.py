"""The paper's figures (Sec. IV) on the port, one function a figure; the
counterpart of ``benchmarks/paper_figs.py`` (Fig. 7 is ``fig7_accuracy``).

Validation targets from the paper:
  Fig. 5  DS collection STDEV far below NO-SDC / NO-SLT / NO-LSA
          (paper testbed: 308 vs 914 / 1044 / 1433)
  Fig. 6  DS per-EC training STDEV below ablations; NO-LSA worst skew
  Fig. 8  cost up / backlog down as eps grows; L-DS: lower backlog + more
          data trained + slightly worse skew than DS at the same eps
  Fig. 9  DS unit cost below ECFull / ECSelf / CUFull (paper: up to 43.7%
          reduction vs CUFull)

    PYTHONPATH=src python -m repro_torch.paper.paper_figs [--device cpu]

Each function runs its scheduler runs on CUDA unless ``device`` names
another device (the command line: ``COCKTAIL_EXAMPLE_SLOTS`` sets the slots
of each run, ``SLOTS`` when unset), and prints the JAX package's lines; ``us_per_call`` is the
host time a slot of ``run`` up to the device's synchronise.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import CU_FULL, DS, EC_FULL, EC_SELF, LDS, NO_LSA, NO_SDC, NO_SLT, metrics, run
from ..core.types import CocktailConfig, DeviceLike
from ..examples import example_args
from .common import emit, sim_config, testbed_config

SLOTS = 60
EVENNESS_SPECS = (DS, NO_SDC, NO_SLT, NO_LSA)  # Figs. 5 and 6
FIG9_SPECS = (DS, EC_FULL, EC_SELF, CU_FULL)
# Fig. 9's sweep: (key of the returned rows, n_cu, n_ec); M at N = 20, then
# N at M = 5.
FIG9_POINTS = ((3, 20, 3), (5, 20, 5), (8, 20, 8), ("cu10", 10, 5), ("cu40", 40, 5))


def timed_run(cfg: CocktailConfig, spec, slots: int, device: DeviceLike):
    """``run(cfg, spec, slots)``: (final state, host us a slot up to the
    device's synchronise)."""
    t0 = time.perf_counter()
    st, _ = run(cfg, spec, slots, device=device)
    if st.t.is_cuda:
        torch.cuda.synchronize(st.t.device)
    return st, (time.perf_counter() - t0) * 1e6 / slots


def fig5_collection_evenness(device: DeviceLike = None, slots: int = SLOTS) -> dict:
    cfg = testbed_config()
    vals = {}
    for spec in EVENNESS_SPECS:
        st, us = timed_run(cfg, spec, slots, device)
        vals[spec.name] = metrics.stdev_collection(st)
        emit(f"fig5/stdev_collection/{spec.name}", us, f"{vals[spec.name]:.1f}")
    ok = all(vals["ds"] < vals[k] for k in ("no-sdc", "no-slt", "no-lsa"))
    emit("fig5/ds_most_even", 0, str(ok).lower())
    return vals


def fig6_training_evenness(device: DeviceLike = None, slots: int = SLOTS) -> dict:
    cfg = testbed_config()
    vals = {}
    for spec in EVENNESS_SPECS:
        st, us = timed_run(cfg, spec, slots, device)
        vals[spec.name] = stdev = metrics.stdev_training_per_ec(st)
        emit(f"fig6/stdev_training/{spec.name}", us, ";".join(f"{v:.0f}" for v in stdev))
    emit("fig6/ds_mean_below_ablations", 0,
         str(bool(np.mean(vals["ds"]) <= min(np.mean(vals[k]) for k in
                                             ("no-sdc", "no-lsa")))).lower())
    return vals


def fig8_ds_vs_lds(device: DeviceLike = None, slots: int = SLOTS) -> dict:
    out = {}
    for eps in (0.1, 0.4):
        for spec in (DS, LDS):
            cfg = testbed_config(eps=eps)
            st, us = timed_run(cfg, spec, slots, device)
            s = metrics.summary(cfg, st)
            key = f"{spec.name}@eps={eps}"
            out[key] = s
            emit(f"fig8/{key}", us,
                 f"cost={s['avg_cost']:.0f};trained={s['total_trained']:.0f};"
                 f"Q={s['q_backlog']:.0f};R={s['r_backlog']:.0f};"
                 f"skew={s['skew_degree']:.4f}")
    checks = [
        out["ds@eps=0.4"]["q_backlog"] < out["ds@eps=0.1"]["q_backlog"],  # O(1/eps)
        out["l-ds@eps=0.1"]["q_backlog"] < out["ds@eps=0.1"]["q_backlog"],
        out["l-ds@eps=0.1"]["total_trained"] > out["ds@eps=0.1"]["total_trained"],
    ]
    emit("fig8/theory_checks", 0, f"{sum(checks)}/3")
    return out


def fig9_point(cfg: CocktailConfig, key, specs, device: DeviceLike = None,
               slots: int = SLOTS) -> dict[str, float]:
    """Unit cost of each of ``specs`` at one point of Fig. 9's sweep
    (``key``: n_ec, or ``"cu<n_cu>"``), one line each."""
    label = f"ec{key}" if isinstance(key, int) else key
    costs = {}
    for spec in specs:
        st, us = timed_run(cfg, spec, slots, device)
        costs[spec.name] = uc = metrics.unit_cost(st)
        emit(f"fig9/unit_cost/{label}/{spec.name}", us, f"{uc:.2f}")
    return costs


def fig9_unit_cost(device: DeviceLike = None, slots: int = SLOTS) -> dict:
    """Fig. 9's sweep of ``FIG9_SPECS`` over ``FIG9_POINTS``; rows keyed
    (point key, spec name)."""
    rows = {}
    for key, n_cu, n_ec in FIG9_POINTS:
        costs = fig9_point(sim_config(n_cu=n_cu, n_ec=n_ec), key, FIG9_SPECS, device, slots)
        rows.update({(key, name): uc for name, uc in costs.items()})
    # headline: max reduction vs CUFull across sweeps
    reds = [100 * (rows[(key, "cufull")] - rows[(key, "ds")]) / rows[(key, "cufull")]
            for key, _, _ in FIG9_POINTS]
    emit("fig9/max_cost_reduction_vs_cufull_pct", 0, f"{max(reds):.1f}")
    return rows


def main(argv=None) -> dict:
    device, slots = example_args(__doc__, argv, default_slots=SLOTS)
    return {"fig5": fig5_collection_evenness(device, slots),
            "fig6": fig6_training_evenness(device, slots),
            "fig8": fig8_ds_vs_lds(device, slots),
            "fig9": fig9_unit_cost(device, slots)}


if __name__ == "__main__":
    main()
