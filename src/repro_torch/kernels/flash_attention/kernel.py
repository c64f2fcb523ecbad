"""ctypes wrapper of the two flash-attention CUDA kernels (``csrc/``).

``flash_attention_cuda`` takes CUDA tensors in the layout of the models --
q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd) of one type (float32 or
bfloat16), q_pos (B, Sq), kv_pos (B, Skv) and kv_valid (B, Skv) or None --
allocates the output, launches a kernel on PyTorch's current stream and
raises if the launch fails. ``variant`` picks the kernel: bf16 prefill with
hd 64 or 128 and Sq >= 64 takes the Hopper kernel of
``flash_attention_sm90.cu`` (both products on wgmma tensor cores), every
other call the kernel of ``flash_attention.cu`` (float32 cores). Each launch
adds one to ``launches["flash_attention"]``, and a launch of the wgmma kernel
also to ``launches["flash_attention_wgmma"]``. Both kernels are in one
library, built by ``nvcc`` on the first launch (``kernels/_build.py``),
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

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",
           Path(__file__).parent / "csrc" / "flash_attention_sm90.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_SQ = 64  # fewer query rows (decode) stay on the SIMT kernel
# ptxas reports each kernel's registers and spills into the build log.
EXTRA_FLAGS = ("-Xptxas", "-v")

launches = {"flash_attention": 0, "flash_attention_wgmma": 0}

_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(_build.load("flash_attention", SOURCES, EXTRA_FLAGS))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``SOURCES``."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.flash_attention_launch.argtypes = [vp] * 7 + [i] * 7 + [f, i, i, i, f, vp]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_wgmma_launch.argtypes = [vp] * 7 + [i] * 6 + [f, i, i, i, f, vp]
    lib.flash_attention_wgmma_launch.restype = i
    lib.flash_attention_wgmma_occupancy.argtypes = [i, i, ip, ip]
    lib.flash_attention_wgmma_occupancy.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def library_path() -> Path:
    return _build.library_path("flash_attention", SOURCES, EXTRA_FLAGS)


def wgmma_occupancy(hd: int, skv: int) -> dict:
    """Shared memory per block and blocks per SM of the wgmma kernel on the
    current card at (hd, Skv)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().flash_attention_wgmma_occupancy(hd, skv, ctypes.byref(smem),
                                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"flash_attention_wgmma_occupancy failed: CUDA error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def variant(dtype: torch.dtype, hd: int, sq: int) -> str:
    """The kernel a call takes: ``"wgmma"`` for bf16 with hd 64 or 128 and at
    least ``WGMMA_MIN_SQ`` query rows, else ``"simt"``."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and sq >= WGMMA_MIN_SQ:
        return "wgmma"
    return "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                         kv_valid: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         force_simt: bool = False) -> torch.Tensor:
    """Attention of q over (k, v) -> (B, Sq, H, hd) in q.dtype (see ref.py).

    ``force_simt`` launches the kernel of ``flash_attention.cu`` where
    ``variant`` would pick the wgmma one, to time the two on the same
    inputs."""
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
    route = "simt" if force_simt else variant(q.dtype, hd, sq)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
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
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
                valid_ptr, out.data_ptr(), b, sq, skv, h, hkv, hd)
        mask = (float(scale), int(spec.causal), int(spec.window), int(spec.prefix_len),
                float(spec.softcap))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "simt":
            err = lib.flash_attention_launch(*args, DTYPES[q.dtype], *mask, stream)
        else:
            err = lib.flash_attention_wgmma_launch(*args, *mask, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {route} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    launches["flash_attention"] += 1
    if route == "wgmma":
        launches["flash_attention_wgmma"] += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes (a view
    at an offset): the wgmma kernel copies rows in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
