"""The paper's own evaluation (Sec. IV) on the port: the counterparts of the
JAX package's ``benchmarks/paper_figs.py`` (Figs. 5, 6, 8 and 9) and
``benchmarks/fig7_accuracy.py`` (Fig. 7, the traffic predictor trained on
the scheduled data). Each module runs on the CUDA card unless given
``--device cpu``; ``COCKTAIL_EXAMPLE_SLOTS`` sets the slots of each run (the
JAX files' counts when unset):

    PYTHONPATH=src python -m repro_torch.paper.fig7_accuracy [--device cpu]
    PYTHONPATH=src python -m repro_torch.paper.paper_figs [--device cpu]

Both print the JAX package's ``name,us_per_call,derived`` lines, so the two
packages' outputs can be compared line for line.
"""
