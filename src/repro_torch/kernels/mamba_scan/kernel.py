"""ctypes wrapper of the Mamba-1 selective-scan CUDA kernels (``csrc/``):
the forward (``mamba1_scan.cu``) and its gradient (``mamba1_scan_bwd.cu``),
one library.

``mamba1_scan_cuda`` takes CUDA tensors -- x and dt (B, S, DI) of one type
(float32 or bfloat16), a (DI, N), b and c (B, S, N) of one type (float32 or
bfloat16), h0 (B, DI, N) or None -- allocates y (B, S, DI) in x's type and
the final state (B, DI, N) in float32, launches the kernel on PyTorch's
current stream and raises if the launch fails. x and dt are made
contiguous, a and h0 float32 and contiguous (no copy where they already
are, as on the models' path). b and c are read in their own type and with
their own strides along B and S, so the models' strided slices of the
``x_proj`` product go in as they are; they need a unit stride along N, and
the wrapper raises on any other. ``mamba1_scan_bwd_cuda`` takes the same
inputs and the gradients of y (B, S, DI) and of the final state (B, DI, N,
or None) and returns the gradients of x, dt, a, b, c and h0 (three
kernels of ``mamba1_scan_bwd.cu``: a sweep to the checkpoints, the walk
back, a fixed-order reduction over blocks, with a float32 workspace the
wrapper allocates). Each call adds one to its entry of ``launches``. The
library is built by ``nvcc`` on the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import _build

SOURCES = (Path(__file__).parent / "csrc" / "mamba1_scan.cu",
           Path(__file__).parent / "csrc" / "mamba1_scan_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32
# ptxas reports the kernel's registers and spills into the build log.
EXTRA_FLAGS = ("-Xptxas", "-v")

launches = {"mamba1_scan": 0, "mamba1_scan_bwd": 0}

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
            lib.mamba1_scan_bwd_workspace_floats.argtypes = [i] * 4
            lib.mamba1_scan_bwd_workspace_floats.restype = i64
            lib.mamba1_scan_bwd_launch.argtypes = [vp] * 15 + [i] * 4 + [i64] * 4 + [i] * 2 + [vp]
            lib.mamba1_scan_bwd_launch.restype = i
            _lib = lib
    return _lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def library_path() -> Path:
    return _build.library_path("mamba1_scan", SOURCES, EXTRA_FLAGS)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(what: str, x, dt, a, b, c, h0, more=()) -> None:
    """Raise unless the kernels can read these inputs (and ``more``, named
    CUDA tensors that must lie beside x)."""
    if x.dtype not in DTYPES or dt.dtype != x.dtype:
        raise TypeError(f"{what}: x and dt must share float32 or bfloat16, "
                        f"got {x.dtype}, {dt.dtype}")
    if b.dtype not in DTYPES or c.dtype != b.dtype:
        raise TypeError(f"{what}: b and c must share float32 or bfloat16, "
                        f"got {b.dtype}, {c.dtype}")
    if x.dim() != 3 or dt.shape != x.shape or a.dim() != 2:
        raise ValueError(f"{what}: expected x, dt (B,S,DI) and a (DI,N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}")
    bsz, s, di = x.shape
    n = a.shape[1]
    if a.shape[0] != di or b.shape != (bsz, s, n) or c.shape != (bsz, s, n):
        raise ValueError(f"{what}: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)} do not fit x {tuple(x.shape)}")
    if h0 is not None and h0.shape != (bsz, di, n):
        raise ValueError(f"{what}: h0 must be (B, DI, N), got {tuple(h0.shape)}")
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"{what}: state size {n} is not in 1..{MAX_STATE}")
    if n > 1 and (b.stride(2) != 1 or c.stride(2) != 1):
        raise ValueError(f"{what}: b and c need a unit stride along N, got strides "
                         f"{b.stride()} and {c.stride()}")
    named = [("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in (*named, *more):
        if not t.is_cuda:
            raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mamba1_scan_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def mamba1_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan -> (y (B, S, DI) in x.dtype, h (B, DI, N) float32)."""
    _check("mamba1_scan", x, dt, a, b, c, h0)
    bsz, s, di = x.shape
    n = a.shape[1]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        h.copy_(h0 if h0 is not None else torch.zeros_like(h))
        return y, h
    x, dt, a, h0 = x.contiguous(), dt.contiguous(), _f32(a), _f32(h0)
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.mamba1_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            _ptr(h0), y.data_ptr(), h.data_ptr(),
            bsz, s, di, n, b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPES[x.dtype], DTYPES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "mamba1_scan")
    launches["mamba1_scan"] += 1
    return y, h


def mamba1_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, h0: Optional[torch.Tensor],
                         gy: torch.Tensor, gh: Optional[torch.Tensor] = None) -> tuple:
    """Gradient of the scan given gy (B, S, DI), the gradient of y, and gh
    (B, DI, N) or None, that of the final state -> (gx, gdt in x.dtype,
    ga (DI, N) float32, gb, gc (B, S, N) in b.dtype, gh0 (B, DI, N)
    float32), as ``ref.mamba1_scan_bwd_ref``."""
    more = [("gy", gy)] + ([("gh", gh)] if gh is not None else [])
    _check("mamba1_scan_bwd", x, dt, a, b, c, h0, more)
    bsz, s, di = x.shape
    n = a.shape[1]
    if gy.shape != x.shape:
        raise ValueError(f"mamba1_scan_bwd: gy must be {tuple(x.shape)}, got {tuple(gy.shape)}")
    if gh is not None and gh.shape != (bsz, di, n):
        raise ValueError(f"mamba1_scan_bwd: gh must be (B, DI, N), got {tuple(gh.shape)}")
    gx = torch.empty_like(x, memory_format=torch.contiguous_format)
    gdt = torch.empty_like(gx)
    # The reduce kernel writes every element of ga, gb and gc.
    ga = torch.empty((di, n), dtype=torch.float32, device=x.device)
    gb = torch.empty((bsz, s, n), dtype=b.dtype, device=x.device)
    gc = torch.empty_like(gb)
    gh0 = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        for t in (ga, gb, gc):
            t.zero_()
        gh0.copy_(gh if gh is not None else torch.zeros_like(gh0))
        return gx, gdt, ga, gb, gc, gh0
    x, dt, a, h0, gh = x.contiguous(), dt.contiguous(), _f32(a), _f32(h0), _f32(gh)
    gy = gy.to(x.dtype).contiguous()
    with torch.cuda.device(x.device):
        lib = _library()
        floats = lib.mamba1_scan_bwd_workspace_floats(bsz, s, di, n)
        work = torch.empty((floats,), dtype=torch.float32, device=x.device)
        err = lib.mamba1_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), _ptr(h0),
            gy.data_ptr(), _ptr(gh), gx.data_ptr(), gdt.data_ptr(), ga.data_ptr(),
            gb.data_ptr(), gc.data_ptr(), gh0.data_ptr(), work.data_ptr(),
            bsz, s, di, n, b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            DTYPES[x.dtype], DTYPES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "mamba1_scan_bwd")
    launches["mamba1_scan_bwd"] += 1
    return gx, gdt, ga, gb, gc, gh0
