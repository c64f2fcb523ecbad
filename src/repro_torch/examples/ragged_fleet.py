"""Ragged fleet: slices of different shapes in one batched pass a slot.

An operator's slices differ in shape: a rural region with a handful of CUs
and two ECs schedules next to a metro slice with dozens of CUs and a fat EC
pool. ``FleetEngine.from_jobs`` pads every slice to the elementwise-max
shape, and the ``cu_mask`` / ``ec_mask`` entity masks of ``SliceParams``
keep the padding inert: each slice's schedule is the one it gets alone,
unpadded (tests/test_torch_fleet.py holds it to 1e-6).

    PYTHONPATH=src python -m repro_torch.examples.ragged_fleet [--device cpu]
"""
from repro_torch.core import DS, CocktailConfig, FleetEngine, SliceJob
from repro_torch.examples import example_args, print_slices

# Small rural slice: paper-testbed scale, 6 CUs on 3 modest ECs.
RURAL = CocktailConfig(
    n_cu=6, n_ec=3, delta=0.02, eps=0.1, zeta=400.0,
    d_base=2000.0, cap_d_base=8000.0, f_base=(8000.0, 20000.0, 8000.0),
    c_base=50.0, e_base=50.0, p_base=200.0, pair_iters=30, seed=0,
)

# Large metro slice: 16 CUs, 5 ECs, heavier arrivals and fatter compute.
METRO = CocktailConfig(
    n_cu=16, n_ec=5, delta=0.03, eps=0.15, zeta=900.0,
    d_base=2500.0, cap_d_base=10000.0,
    f_base=(48000.0, 32000.0, 20000.0, 20000.0, 14000.0),
    c_base=60.0, e_base=40.0, p_base=150.0, pair_iters=30, seed=1,
)

# Mid-size suburban slice riding along.
SUBURB = CocktailConfig(
    n_cu=10, n_ec=4, delta=0.02, eps=0.1, zeta=600.0,
    d_base=2000.0, cap_d_base=8000.0,
    f_base=(8000.0, 14000.0, 20000.0, 14000.0),
    c_base=50.0, e_base=50.0, p_base=180.0, pair_iters=30, seed=2,
)

JOBS = [SliceJob(RURAL, DS, name="rural/6x3"),
        SliceJob(METRO, DS, name="metro/16x5"),
        SliceJob(SUBURB, DS, name="suburb/10x4")]


def main() -> None:
    device, slots = example_args(__doc__)
    engine = FleetEngine.from_jobs(JOBS, device=device)
    print(f"ragged fleet: {engine.n_slices} slices x {slots} slots on {engine.device}, "
          f"padded to N={engine.shape.n_cu} M={engine.shape.n_ec}")
    print("true shapes:", ", ".join(f"{j.config.n_cu}x{j.config.n_ec}" for j in JOBS), "\n")
    state, recs = engine.run(slots)
    print_slices(engine, JOBS, state)
    print("\nper-slot fleet records are time-major (T, K):", tuple(recs.cost.shape))


if __name__ == "__main__":
    main()
