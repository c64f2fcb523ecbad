"""ctypes wrapper of the Mamba-1 selective-scan CUDA kernel (``csrc/``).

``mamba1_scan_cuda`` takes CUDA tensors -- x and dt (B, S, DI) of one type
(float32 or bfloat16), a (DI, N), b and c (B, S, N) of one type (float32 or
bfloat16), h0 (B, DI, N) or None -- allocates y (B, S, DI) in x's type and
the final state (B, DI, N) in float32, launches the kernel on PyTorch's
current stream and raises if the launch fails. x and dt are made
contiguous, a and h0 float32 and contiguous (no copy where they already
are, as on the models' path). b and c are read in their own type and with
their own strides along B and S, so the models' strided slices of the
``x_proj`` product go in as they are; they need a unit stride along N, and
the wrapper raises on any other. Each launch adds one to ``launches``. The
library is built by ``nvcc`` on the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import _build

SOURCES = (Path(__file__).parent / "csrc" / "mamba1_scan.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32
# ptxas reports the kernel's registers and spills into the build log.
EXTRA_FLAGS = ("-Xptxas", "-v")

launches = {"mamba1_scan": 0}

_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("mamba1_scan", SOURCES, EXTRA_FLAGS)
            vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.mamba1_scan_launch.argtypes = [vp] * 8 + [i] * 4 + [i64] * 4 + [i] * 2 + [vp]
            lib.mamba1_scan_launch.restype = i
            lib.mamba1_scan_error_string.argtypes = [i]
            lib.mamba1_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def library_path() -> Path:
    return _build.library_path("mamba1_scan", SOURCES, EXTRA_FLAGS)


def reset_launch_counts() -> None:
    launches["mamba1_scan"] = 0


def mamba1_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan -> (y (B, S, DI) in x.dtype, h (B, DI, N) float32)."""
    if x.dtype not in DTYPES or dt.dtype != x.dtype:
        raise TypeError(f"mamba1_scan: x and dt must share float32 or bfloat16, "
                        f"got {x.dtype}, {dt.dtype}")
    if b.dtype not in DTYPES or c.dtype != b.dtype:
        raise TypeError(f"mamba1_scan: b and c must share float32 or bfloat16, "
                        f"got {b.dtype}, {c.dtype}")
    if x.dim() != 3 or dt.shape != x.shape or a.dim() != 2:
        raise ValueError(f"mamba1_scan: expected x, dt (B,S,DI) and a (DI,N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}")
    bsz, s, di = x.shape
    n = a.shape[1]
    if a.shape[0] != di or b.shape != (bsz, s, n) or c.shape != (bsz, s, n):
        raise ValueError(f"mamba1_scan: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)} do not fit x {tuple(x.shape)}")
    if h0 is not None and h0.shape != (bsz, di, n):
        raise ValueError(f"mamba1_scan: h0 must be (B, DI, N), got {tuple(h0.shape)}")
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"mamba1_scan: state size {n} is not in 1..{MAX_STATE}")
    if n > 1 and (b.stride(2) != 1 or c.stride(2) != 1):
        raise ValueError(f"mamba1_scan: b and c need a unit stride along N, got strides "
                         f"{b.stride()} and {c.stride()}")
    named = [("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"mamba1_scan: the CUDA kernel needs CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"mamba1_scan: {name} is on {t.device}, x on {x.device}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        h.copy_(h0 if h0 is not None else torch.zeros_like(h))
        return y, h
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    x, dt, a = x.contiguous(), dt.contiguous(), f32(a)
    h0 = f32(h0) if h0 is not None else None
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.mamba1_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(),
            bsz, s, di, n, b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPES[x.dtype], DTYPES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.mamba1_scan_error_string(err).decode()
        raise RuntimeError(f"mamba1_scan kernel launch failed: CUDA error {err} ({msg})")
    launches["mamba1_scan"] += 1
    return y, h
