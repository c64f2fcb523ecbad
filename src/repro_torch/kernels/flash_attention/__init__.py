"""Attention: the exact reference and the decode kernel's split-and-merge
plain version (``ref.py``), the plain online-softmax version and the
dispatch (``ops.py``), and the three CUDA kernels (``kernel.py``;
``csrc/flash_attention.cu`` on the float32 cores, ``csrc/flash_attention_sm90.cu``
on wgmma tensor cores for bf16 prefill, ``csrc/flash_decode_sm90.cu`` for
decode)."""
