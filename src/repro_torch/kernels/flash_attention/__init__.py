"""Attention: the exact reference (``ref.py``), the plain online-softmax
version and the dispatch (``ops.py``), and the CUDA kernel (``kernel.py``,
``csrc/flash_attention.cu``)."""
