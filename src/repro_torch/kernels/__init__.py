"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``ref.py``) and a dispatch layer (``ops.py``).

  matching        -- the scheduler's three greedy matchers (collection,
                     assignment, pairing), ``matching/csrc/``.
  flash_attention -- forward attention with an online softmax (GQA, causal /
                     window / prefix masks, soft-cap), ``flash_attention/csrc/``.
  mamba_scan      -- the Mamba-1 selective scan, ``mamba_scan/csrc/``.

All are CUDA C++ for sm_90a, built by ``_build.py`` at first launch.
"""
