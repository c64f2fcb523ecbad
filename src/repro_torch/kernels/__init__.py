"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``ref.py``) and a dispatch layer (``ops.py``).

  matching -- the scheduler's three greedy matchers (collection, assignment,
              pairing), CUDA C++ for sm_90a in ``matching/csrc/``.
"""
