"""Mixed-policy fleet: a different algorithm per slice, one fleet.

A staged rollout: most slices run the full skew-aware DataSche in
production, while a few canaries run ablated baselines (plain greedy
collection, LSA off) as a live reference. ``FleetEngine.from_jobs`` runs
them under ``SWITCHED`` dispatch: the slices are grouped by the policies
their ``SliceParams`` leaves name, each group runs its policies once a slot
(one matcher launch per group), and each slice reproduces its own
single-spec ``run`` (tests/test_torch_fleet.py).

    PYTHONPATH=src python -m repro_torch.examples.mixed_policy_fleet [--device cpu]
"""
import dataclasses

from repro_torch.core import DS, NO_LSA, NO_SDC, CocktailConfig, FleetEngine, SliceJob
from repro_torch.examples import example_args, print_slices

# Production profile: paper-testbed-like regional slice under full DataSche.
PROD = CocktailConfig(
    n_cu=8, n_ec=3, delta=0.02, eps=0.1, zeta=500.0,
    d_base=2000.0, cap_d_base=8000.0, f_base=(8000.0, 20000.0, 12000.0),
    c_base=50.0, e_base=50.0, p_base=200.0, pair_iters=30, seed=0,
)

# Canary profile: a smaller slice (ragged: from_jobs pads it), used to A/B
# the ablated baselines against production on live traffic.
CANARY = dataclasses.replace(PROD, n_cu=6, f_base=(8000.0, 20000.0, 8000.0))

JOBS = [
    SliceJob(PROD, DS, name="prod/region-0"),
    SliceJob(dataclasses.replace(PROD, zeta=700.0, seed=1), DS, name="prod/region-1"),
    SliceJob(dataclasses.replace(PROD, zeta=350.0, seed=2), DS, name="prod/region-2"),
    SliceJob(dataclasses.replace(CANARY, seed=3), NO_SDC, name="canary/no-sdc"),
    SliceJob(dataclasses.replace(CANARY, seed=4), NO_LSA, name="canary/no-lsa"),
]


def main() -> None:
    device, slots = example_args(__doc__)
    engine = FleetEngine.from_jobs(JOBS, device=device)
    print(f"mixed-policy fleet: {engine.n_slices} slices x {slots} slots on {engine.device}, "
          f"dispatch={engine.spec.name}, padded to N={engine.shape.n_cu} M={engine.shape.n_ec}")
    print("slice specs:", ", ".join(j.spec.name for j in JOBS), "\n")
    state, recs = engine.run(slots)
    print_slices(engine, JOBS, state, with_spec=True)
    print("\nper-slot fleet records are time-major (T, K):", tuple(recs.cost.shape))


if __name__ == "__main__":
    main()
