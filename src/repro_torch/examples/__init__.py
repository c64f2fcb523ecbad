"""Runnable examples of the port, counterparts of the JAX package's
``examples/*.py``. Each runs on the CUDA card unless given ``--device cpu``;
``COCKTAIL_EXAMPLE_SLOTS`` sets the number of slots of the scheduler examples:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.fleet_multi_slice [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.ragged_fleet [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.mixed_policy_fleet [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm_cocktail [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.traffic_prediction [--device cpu]
"""
import argparse
import os


def example_args(doc: str, argv=None, default_slots: int = 60) -> tuple[str | None, int]:
    """(device, slots) of an example: ``--device`` (CUDA when not given) of
    ``argv`` (the command line when None) and ``COCKTAIL_EXAMPLE_SLOTS``
    (``default_slots`` when unset)."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    slots = int(os.environ.get("COCKTAIL_EXAMPLE_SLOTS", default_slots))
    return parser.parse_args(argv).device, slots


def print_slices(engine, jobs, state, with_spec: bool = False) -> None:
    """One line of metrics per slice of a finished fleet run."""
    from ..core import metrics

    width = max(len(j.name) for j in jobs)
    spec_col = f" {'spec':8s}" if with_spec else ""
    print(f"{'slice':{width}s}{spec_col} {'unit_cost':>9s} {'trained':>10s} "
          f"{'skew':>7s} {'q_backlog':>10s}")
    for k, job in enumerate(jobs):
        # slice_state trims a ragged slice's padding: metrics read its true shape.
        s = metrics.summary(job.config, engine.slice_state(state, k))
        spec = f" {job.spec.name:8s}" if with_spec else ""
        print(f"{job.name:{width}s}{spec} {s['unit_cost']:9.2f} {s['total_trained']:10.0f} "
              f"{s['skew_degree']:7.4f} {s['q_backlog']:10.0f}")
