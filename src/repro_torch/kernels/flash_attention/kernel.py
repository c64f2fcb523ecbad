"""ctypes wrapper of the flash-attention CUDA kernel (``csrc/``).

``flash_attention_cuda`` takes CUDA tensors in the layout of the models --
q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd) of one type (float32 or
bfloat16), q_pos (B, Sq), kv_pos (B, Skv) and kv_valid (B, Skv) or None --
allocates the output, launches the kernel on PyTorch's current stream and
raises if the launch fails. Each launch adds one to ``launches``. The
library is built by ``nvcc`` on the first launch (``kernels/_build.py``),
never at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import AttnSpec

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

launches = {"flash_attention": 0}

_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("flash_attention", SOURCES)
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.flash_attention_launch.argtypes = [vp] * 7 + [i] * 7 + [f, i, i, i, f, vp]
            lib.flash_attention_launch.restype = i
            lib.flash_attention_error_string.argtypes = [i]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def reset_launch_counts() -> None:
    launches["flash_attention"] = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                         kv_valid: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q over (k, v) -> (B, Sq, H, hd) in q.dtype (see ref.py)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: the CUDA kernel needs CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B,Sq,H,hd) and k, v (B,Skv,Hkv,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} is not in 1..{MAX_HEAD_DIM}")
    if q_pos.shape != (b, sq) or kv_pos.shape != (b, skv):
        raise ValueError("flash_attention: q_pos must be (B, Sq) and kv_pos (B, Skv)")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    valid_ptr = None
    if kv_valid is not None:
        if kv_valid.shape != (b, skv) or kv_valid.device != q.device:
            raise ValueError("flash_attention: kv_valid must be (B, Skv) on q's device")
        kv_valid = kv_valid.to(torch.bool).contiguous()
        valid_ptr = kv_valid.data_ptr()
    scale = hd ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        lib = _library()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            valid_ptr, out.data_ptr(), b, sq, skv, h, hkv, hd, DTYPES[q.dtype],
            float(scale), int(spec.causal), int(spec.window), int(spec.prefix_len),
            float(spec.softcap), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} ({msg})")
    launches["flash_attention"] += 1
    return out
