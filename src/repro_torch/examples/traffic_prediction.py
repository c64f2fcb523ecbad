"""The paper's own testbed scenario end to end (Sec. IV-A/B): cooperative
traffic-prediction training across 3 edge clouds fed by 6 CUs, scheduled by
DataSche; compares the final model accuracy (the within-15 % criterion)
under DS and the skew ablations (the port's copy of the JAX package's
``examples/traffic_prediction.py``).

    PYTHONPATH=src python -m repro_torch.examples.traffic_prediction [--device cpu]

Runs on the CUDA card unless given ``--device``; ``COCKTAIL_EXAMPLE_SLOTS``
sets the number of slots (40 when unset, at least 10).
"""
from repro_torch.examples import example_args
from repro_torch.paper import fig7_accuracy


def main(argv=None) -> dict[str, list[float]]:
    """Prints Fig. 7's lines, then each spec's accuracy over the slots;
    returns the accuracies by spec name."""
    device, slots = example_args(__doc__, argv, default_slots=fig7_accuracy.SLOTS)
    print("training traffic predictors under 4 scheduling policies "
          "(paper Fig. 7 reproduction)...")
    print("name,us_per_call,derived")
    results = fig7_accuracy.fig7_accuracy(device, slots)
    print()
    for name, accs in results.items():
        print(f"{name:8s} accuracy over slots: "
              + " -> ".join(f"{a:.1%}" for a in accs))
    return results


if __name__ == "__main__":
    main()
