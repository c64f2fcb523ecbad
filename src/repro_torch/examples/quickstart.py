"""Quickstart: run the Cocktail scheduler for 60 slots on the paper's
testbed topology (6 CUs / 3 heterogeneous ECs) and compare DataSche with the
CU-full-connection strawman (the port's copy of the JAX package's
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the CUDA card unless given ``--device``; ``COCKTAIL_EXAMPLE_SLOTS``
sets the number of slots.
"""
import json

from repro_torch.core import CU_FULL, DS, LDS, CocktailConfig, metrics, run
from repro_torch.examples import example_args

CFG = CocktailConfig(
    n_cu=6, n_ec=3, delta=0.02, eps=0.1,
    f_base=(8000.0, 20000.0, 8000.0),  # one fast EC, two slow (paper testbed)
    c_base=250.0, e_base=50.0, p_base=200.0, pair_iters=30, seed=0,
)
SPECS = (DS, LDS, CU_FULL)


def main(argv=None) -> dict:
    """Prints one line a spec, DataSche's cost reduction against CU_FULL and
    DataSche's summary as JSON; returns the summaries by spec name."""
    device, slots = example_args(__doc__, argv)
    print(f"slot-by-slot online scheduling, {slots} slots "
          f"(~{slots * 5 / 60:.1f}h of 5-min slots)\n")
    states, out = {}, {}
    for spec in SPECS:
        states[spec.name], _ = run(CFG, spec, slots, device=device)
        out[spec.name] = s = metrics.summary(CFG, states[spec.name])
        print(f"{spec.name:8s} unit_cost={s['unit_cost']:8.2f} "
              f"trained={s['total_trained']:9.0f} samples  "
              f"skew_degree={s['skew_degree']:.4f}  "
              f"collection_stdev={s['stdev_collection']:7.1f}")

    ds, cf = metrics.unit_cost(states[DS.name]), metrics.unit_cost(states[CU_FULL.name])
    print(f"\nDataSche cost reduction vs CUFull: {100 * (cf - ds) / cf:.1f}% "
          "(paper reports up to 43.7% across scenarios)")
    print(json.dumps(out[DS.name], indent=2))
    return out


if __name__ == "__main__":
    main()
