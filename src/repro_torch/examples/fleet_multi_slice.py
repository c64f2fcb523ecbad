"""Fleet scheduling: many network slices in one batched pass a slot.

A 5G operator runs heterogeneous incremental-learning jobs at once:
regional traffic-prediction slices (modest arrival rates, cheap
transmission, testbed-like EC budgets) next to tenant LM-training slices
(heavy arrivals, pricier compute, fat ECs). Each slice is a ``SliceJob``
(config + algorithm + seed); ``FleetEngine.from_jobs`` stacks them on a
leading K axis, and every slot is one pass over all K slices, each matcher
launched once for the whole fleet.

    PYTHONPATH=src python -m repro_torch.examples.fleet_multi_slice [--device cpu]
"""
import dataclasses

from repro_torch.core import DS, CocktailConfig, FleetEngine, SliceJob
from repro_torch.examples import example_args, print_slices

N_CU, N_EC = 12, 4

# Profile A: regional traffic prediction (paper testbed scaled up).
TRAFFIC = CocktailConfig(
    n_cu=N_CU, n_ec=N_EC, delta=0.02, eps=0.1, zeta=500.0,
    d_base=2000.0, cap_d_base=8000.0,
    f_base=(8000.0, 20000.0, 8000.0, 14000.0),
    c_base=50.0, e_base=50.0, p_base=200.0, pair_iters=30, seed=0,
)

# Profile B: tenant LM training: heavier arrivals, fatter ECs, pricier
# compute, looser skew tolerance.
LM = dataclasses.replace(
    TRAFFIC, zeta=1200.0, delta=0.05, eps=0.15,
    f_base=(48000.0, 48000.0, 20000.0, 20000.0),
    c_base=80.0, p_base=120.0, seed=1,
)

JOBS = [
    SliceJob(TRAFFIC, DS, name="traffic/region-0"),
    SliceJob(dataclasses.replace(TRAFFIC, zeta=350.0, seed=2), DS, name="traffic/region-1"),
    SliceJob(dataclasses.replace(TRAFFIC, zeta=800.0, seed=3), DS, name="traffic/region-2"),
    SliceJob(LM, DS, name="lm/tenant-a"),
    SliceJob(dataclasses.replace(LM, zeta=900.0, eps=0.2, seed=4), DS, name="lm/tenant-b"),
]


def main() -> None:
    device, slots = example_args(__doc__)
    engine = FleetEngine.from_jobs(JOBS, device=device)
    print(f"fleet: {engine.n_slices} slices x {slots} slots on {engine.device}, shape "
          f"N={engine.shape.n_cu} M={engine.shape.n_ec}, one batched pass a slot\n")
    state, recs = engine.run(slots)
    print_slices(engine, JOBS, state)
    print("\nper-slot fleet cost (records are time-major (T, K)):", tuple(recs.cost.shape))


if __name__ == "__main__":
    main()
