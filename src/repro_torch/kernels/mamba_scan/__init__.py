"""Mamba-1 selective scan: the sequential reference (``ref.py``), the plain
chunked version and the dispatch (``ops.py``), and the CUDA kernel
(``kernel.py``, ``csrc/mamba1_scan.cu``)."""
