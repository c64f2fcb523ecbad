"""ctypes wrappers of the greedy matching CUDA kernels (``csrc/``).

Each wrapper takes contiguous float32 CUDA tensors with one leading batch
axis, allocates its output, launches one kernel on PyTorch's current stream
(one thread block per problem; pairing one warp per problem, several a
block) and raises if the launch fails. It counts its
launches in ``launches``: one per kernel launch, nowhere else. The library
is built by ``nvcc`` on the first launch (``kernels/_build.py``), never at
import, so this module imports on a machine without CUDA.

The plain versions of the same functions are in ``ref.py``; ``ops.py``
chooses between the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).parent / "csrc" / "greedy_matching.cu",)
# Bit-equality with the plain versions needs uncontracted a*b+c (_build.py);
# ptxas's registers and spills land in the build log.
EXTRA_FLAGS = ("--fmad=false", "-Xptxas", "-v")
# The assignment kernel's chain warp holds up to two columns a lane.
ASSIGNMENT_MAX_M = 64

# Launch counts per kernel name, bumped by the wrappers below.
launches = {"greedy_collection": 0, "greedy_assignment": 0, "greedy_pairing": 0}
# Whether each kernel's last launch kept its whole tile in shared memory
# (else it read it from global memory, or streamed it in row chunks), and the
# design it ran; both reported by the launcher itself.
tile_in_smem: dict[str, bool] = {}
variant: dict[str, str] = {}

_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("greedy_matching", SOURCES, EXTRA_FLAGS)
            vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
            lib.greedy_collection_launch.argtypes = [vp, vp, vp, vp, i, i, i, vp, ip]
            lib.greedy_assignment_launch.argtypes = [vp, vp, i, i, i, vp, ip]
            lib.greedy_pairing_launch.argtypes = [vp, vp, i, i, vp, ip]
            for fn in (lib.greedy_collection_launch, lib.greedy_assignment_launch,
                       lib.greedy_pairing_launch):
                fn.restype = i
            lib.greedy_error_string.argtypes = [i]
            lib.greedy_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def library_path() -> Path:
    return _build.library_path("greedy_matching", SOURCES, EXTRA_FLAGS)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launched(err: int, code: ctypes.c_int, name: str) -> None:
    """Raise if the launch failed; else count it and note the variant the
    launcher reported: bit 0, the whole tile in shared memory; bit 1, the
    pairing's register variant (M <= 64, rows in registers; else the wide
    one)."""
    if err != 0:
        msg = _library().greedy_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    launches[name] += 1
    tile_in_smem[name] = bool(code.value & 1)
    variant[name] = {"greedy_collection": "column_maxima",
                     "greedy_assignment": "candidate_lists",
                     "greedy_pairing": "warp" if code.value & 2 else "wide"}[name]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def greedy_collection_cuda(logw: torch.Tensor, pen: torch.Tensor) -> torch.Tensor:
    """logw (K, N, M), pen (N + 1,) -> alpha (K, N, M) in {0,1}. The kernel
    keeps a column-major copy of each tile, in shared memory where it fits
    and otherwise in a (K, M, N) scratch allocated here."""
    _check(logw, "greedy_collection logw", 3)
    _check(pen, "greedy_collection pen", 1)
    k, n, m = logw.shape
    if pen.shape[0] != n + 1 or pen.device != logw.device:
        raise ValueError("greedy_collection: pen must have N + 1 entries on logw's device")
    alpha = torch.empty_like(logw)
    if logw.numel() == 0:
        return alpha
    scratch = torch.empty((k, m, n), dtype=logw.dtype, device=logw.device)
    in_smem = ctypes.c_int(0)
    with torch.cuda.device(logw.device):
        err = _library().greedy_collection_launch(
            logw.data_ptr(), pen.data_ptr(), alpha.data_ptr(), scratch.data_ptr(), k, n, m,
            _stream(logw), ctypes.byref(in_smem))
    _launched(err, in_smem, "greedy_collection")
    return alpha


def greedy_assignment_cuda(w: torch.Tensor) -> torch.Tensor:
    """w (K, N, M) -> alpha (K, N, M) in {0,1}; N < 2^16, M <= 64."""
    _check(w, "greedy_assignment w", 3)
    k, n, m = w.shape
    if n >= 1 << 16 or m > ASSIGNMENT_MAX_M:
        raise ValueError(f"greedy_assignment: the kernel takes N < 65536 and "
                         f"M <= {ASSIGNMENT_MAX_M}, got {tuple(w.shape)}")
    alpha = torch.empty_like(w)
    if w.numel() == 0:
        return alpha
    in_smem = ctypes.c_int(0)
    with torch.cuda.device(w.device):
        err = _library().greedy_assignment_launch(
            w.data_ptr(), alpha.data_ptr(), k, n, m, _stream(w), ctypes.byref(in_smem))
    _launched(err, in_smem, "greedy_assignment")
    return alpha


def greedy_pairing_cuda(w: torch.Tensor) -> torch.Tensor:
    """Value matrix w (K, M, M) (diagonal = solo) -> match (K, M, M); one
    warp a problem, the free set in registers up to M = 64 ("warp"), in
    shared memory above ("wide")."""
    _check(w, "greedy_pairing w", 3)
    k, m, m2 = w.shape
    if m != m2:
        raise ValueError(f"greedy_pairing: expected square values, got {tuple(w.shape)}")
    match = torch.empty_like(w)
    if w.numel() == 0:
        return match
    in_smem = ctypes.c_int(0)
    with torch.cuda.device(w.device):
        err = _library().greedy_pairing_launch(
            w.data_ptr(), match.data_ptr(), k, m, _stream(w), ctypes.byref(in_smem))
    _launched(err, in_smem, "greedy_pairing")
    return match
