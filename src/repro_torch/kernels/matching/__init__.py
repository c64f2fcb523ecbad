"""Greedy matching: CUDA kernels (``kernel.py``, ``csrc/``), plain PyTorch
versions (``ref.py``) and the dispatch the scheduler calls (``ops.py``)."""
