"""ctypes wrapper of the three flash-attention CUDA kernels (``csrc/``).

``flash_attention_cuda`` takes CUDA tensors in the layout of the models --
q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd) of one type (float32 or
bfloat16), q_pos (B, Sq), kv_pos (B, Skv) and kv_valid (B, Skv) or None --
allocates the output, launches a kernel on PyTorch's current stream and
raises if the launch fails. ``variant`` picks the kernel: decode (Sq = 1,
head dim a multiple of 8) takes ``flash_decode_sm90.cu`` (the q heads of a
kv head packed into one block, keys split across blocks as ``decode_plan``
says and merged in the same launch); bf16 prefill with hd 64 or 128 and
Sq >= 64 takes ``flash_attention_sm90.cu`` (both products on wgmma tensor
cores); every other call the kernel of ``flash_attention.cu`` (float32
cores; the q heads of a kv head packed into a block's rows, ``simt_rows``
of them a block). Each launch adds one to ``launches["flash_attention"]``, and a
launch of the wgmma or decode kernel also to ``launches["flash_attention_wgmma"]``
or ``launches["flash_attention_decode"]``; a decode launch that also writes
each row's log-sum-exp (``return_lse``: a cache whose slots are split over
tensor-parallel ranks) to ``launches["flash_attention_decode_lse"]`` too. The three kernels are in one
library, built by ``nvcc`` on the first launch (``kernels/_build.py``),
never at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import DECODE_TILE, NEG, AttnSpec

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",
           Path(__file__).parent / "csrc" / "flash_attention_sm90.cu",
           Path(__file__).parent / "csrc" / "flash_decode_sm90.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_SQ = 64  # fewer query rows stay on the SIMT kernel
# The decode kernel: head dims that are whole 16-byte chunks in both types;
# q heads a block (a group of G = H / Hkv takes the next of these, several
# blocks when G > 8); keys a split at most; a split below this many tiles
# is not worth its merge.
DECODE_HEAD_DIM_MULTIPLE = 8
DECODE_ROWS = (1, 2, 4, 8)
DECODE_MAX_SPLIT_TILES = 128
DECODE_MIN_SPLIT_TILES = 4
# The SIMT kernel: flat (position, q head) rows a block (128 only up to hd
# 128: that instance takes 64-key tiles and 8 rows a thread).
SIMT_ROWS = (16, 32, 64, 128)
SIMT_WIDE_MAX_HEAD_DIM = 128
# ptxas reports each kernel's registers and spills into the build log.
EXTRA_FLAGS = ("-Xptxas", "-v")
# The SIMT source's 22 instances are the library's longest compile (134 s on
# an H100 machine's 8 cores, the other sources 10-37 s); nvcc's split
# compilation optimises them on 8 threads (51 s) into the same SASS,
# function for function (scripts/nvcc_split.py). It changes one function's
# SASS in each of the other two sources, so only this one takes it.
SOURCE_FLAGS = {"flash_attention.cu": ("--split-compile=8",)}

launches = {"flash_attention": 0, "flash_attention_wgmma": 0, "flash_attention_decode": 0,
            "flash_attention_decode_lse": 0}

_lib = None
_lib_lock = threading.Lock()
# Decode workspaces, one per (device, stream): float32 partials and the
# merge counters, which every launch leaves at zero; and the buffers of
# workspaces that have grown since (see ``_decode_workspace``).
_workspaces: dict = {}
_retired: list = []


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(_build.load("flash_attention", SOURCES, EXTRA_FLAGS, SOURCE_FLAGS))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``SOURCES``."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.flash_attention_launch.argtypes = [vp] * 7 + [i] * 8 + [f, i, i, i, f, vp]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_occupancy.argtypes = [i, i, i, ip, ip, ip]
    lib.flash_attention_occupancy.restype = i
    lib.flash_attention_wgmma_launch.argtypes = [vp] * 7 + [i] * 6 + [f, i, i, i, f, vp]
    lib.flash_attention_wgmma_launch.restype = i
    lib.flash_attention_wgmma_occupancy.argtypes = [i, i, ip, ip]
    lib.flash_attention_wgmma_occupancy.restype = i
    lib.flash_decode_launch.argtypes = [vp] * 10 + [i] * 9 + [f, i, i, i, f, vp]
    lib.flash_decode_launch.restype = i
    lib.flash_decode_occupancy.argtypes = [i, i, i, ip, ip, ip]
    lib.flash_decode_occupancy.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or find) and load the library now rather than at first launch."""
    _library()


def library_path() -> Path:
    return _build.library_path("flash_attention", SOURCES, EXTRA_FLAGS, SOURCE_FLAGS)


def wgmma_occupancy(hd: int, skv: int) -> dict:
    """Shared memory per block and blocks per SM of the wgmma kernel on the
    current card at (hd, Skv)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().flash_attention_wgmma_occupancy(hd, skv, ctypes.byref(smem),
                                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"flash_attention_wgmma_occupancy failed: CUDA error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}


def simt_occupancy(dtype: torch.dtype, hd: int, rows: int) -> dict:
    """Shared memory, threads and blocks per SM of the SIMT kernel instance
    that takes (dtype, hd, rows) on the current card."""
    out = [ctypes.c_int(0) for _ in range(3)]
    err = _library().flash_attention_occupancy(DTYPES[dtype], hd, rows,
                                               *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"flash_attention_occupancy failed: CUDA error {err}")
    return {"smem_bytes_per_block": out[0].value, "threads": out[1].value,
            "blocks_per_sm": out[2].value}


def decode_occupancy(dtype: torch.dtype, hd: int, group: int) -> dict:
    """Shared memory, stages and blocks per SM of the decode kernel instance
    that takes (dtype, hd, G) on the current card."""
    out = [ctypes.c_int(0) for _ in range(3)]
    err = _library().flash_decode_occupancy(DTYPES[dtype], hd, decode_rows(group),
                                            *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"flash_decode_occupancy failed: CUDA error {err}")
    return {"smem_bytes_per_block": out[0].value, "stages": out[1].value,
            "blocks_per_sm": out[2].value}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def variant(dtype: torch.dtype, hd: int, sq: int) -> str:
    """The kernel a call takes: ``"decode"`` for one query row in float32 or
    bf16 with a head dim that is a multiple of ``DECODE_HEAD_DIM_MULTIPLE``;
    ``"wgmma"`` for bf16 with hd 64 or 128 and at least ``WGMMA_MIN_SQ``
    query rows; else ``"simt"``."""
    if sq == 1 and dtype in DTYPES and hd % DECODE_HEAD_DIM_MULTIPLE == 0 and \
            hd <= MAX_HEAD_DIM:
        return "decode"
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and sq >= WGMMA_MIN_SQ:
        return "wgmma"
    return "simt"


def simt_row_sizes(hd: int) -> tuple[int, ...]:
    """The SIMT kernel's rows a block at head dim ``hd``."""
    return SIMT_ROWS if hd <= SIMT_WIDE_MAX_HEAD_DIM else SIMT_ROWS[:-1]


def simt_rows(b: int, sq: int, hkv: int, group: int, hd: int, sms: int) -> int:
    """Flat rows a block of the SIMT kernel: the least of ``simt_row_sizes(hd)``
    that holds a kv head's Sq x G rows (else the largest), halved while the
    grid (row tiles x Hkv x B blocks) would not give each of ``sms`` SMs a
    block, but not below 32: 16 rows take as many threads a row as 32, so
    halving to 16 adds blocks but no threads (32 measured about 8 % faster at
    the 16-token forward on an H100, PERF.md); 16 take calls of at most 16 rows."""
    flat = sq * group
    sizes = simt_row_sizes(hd)
    rows = next((r for r in sizes if flat <= r), sizes[-1])
    while rows > 32 and -(-flat // rows) * hkv * b < sms:
        rows //= 2
    return rows


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_rows(group: int) -> int:
    """q heads a decode block: the least of ``DECODE_ROWS`` that holds the
    group, else the largest (the group then takes several blocks)."""
    return next((r for r in DECODE_ROWS if group <= r), DECODE_ROWS[-1])


@functools.lru_cache(maxsize=256)  # on the host path of every decode launch
def decode_plan(b: int, skv: int, hkv: int, group: int, slots: int) -> tuple[int, int]:
    """(splits, tiles a split) the decode kernel takes (see ``split_plan``):
    at least enough splits that none holds more than
    ``DECODE_MAX_SPLIT_TILES`` tiles, and, where every split keeps
    ``DECODE_MIN_SPLIT_TILES`` tiles, as many as one wave of ``slots``
    resident blocks (SMs x blocks an SM) holds: a block's rate is bound by
    its own latency, so a full wave is the fastest grid, and a partial second
    wave would run at a fraction of the card. A cache of a few tiles takes
    one split."""
    tiles = -(-skv // DECODE_TILE)
    blocks = b * hkv * -(-group // decode_rows(group))
    return split_plan(skv, max(-(-tiles // DECODE_MAX_SPLIT_TILES),
                               min(slots // blocks, tiles // DECODE_MIN_SPLIT_TILES), 1))


def split_plan(skv: int, n_split: int) -> tuple[int, int]:
    """(splits, tiles a split) for about ``n_split`` splits of Skv keys: Skv
    is cut into ``DECODE_TILE``-key tiles and the tiles into equal splits of
    whole tiles (the last may be shorter; ``ref.decode_split_bounds`` cuts
    the same), so the count is cut to the tiles. Raises if a split would
    hold more than ``DECODE_MAX_SPLIT_TILES`` tiles."""
    if n_split < 1:
        raise ValueError(f"flash_attention decode: n_split must be positive, got {n_split}")
    tiles = -(-skv // DECODE_TILE)
    split_tiles = -(-tiles // min(n_split, tiles))
    if split_tiles > DECODE_MAX_SPLIT_TILES:
        raise ValueError(f"flash_attention decode: {n_split} splits of {skv} keys hold more "
                         f"than {DECODE_MAX_SPLIT_TILES * DECODE_TILE} keys each")
    return -(-tiles // split_tiles), split_tiles


@functools.lru_cache(maxsize=None)
def decode_slots(device: torch.device, dtype: torch.dtype, hd: int, group: int) -> int:
    """Blocks of the decode kernel instance for (dtype, hd, G) that ``device``
    holds at once: SMs x blocks an SM."""
    with torch.cuda.device(device):
        per_sm = decode_occupancy(dtype, hd, group)["blocks_per_sm"]
    return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def _decode_workspace(device: torch.device, stream: int, n_floats: int,
                      n_counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (partials, counters) of ``device`` and ``stream``, grown when a
    call needs more. Counters start at zero and every launch leaves them so;
    partials are written before they are read, so neither is cleared per
    call. A grown workspace's earlier buffers are kept (``_retired``), never
    freed: a CUDA graph captured on the stream before the growth holds their
    addresses and may still be replayed."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        if ws is not None:
            _retired.append(ws)
            n_floats, n_counters = max(n_floats, ws[0].numel()), max(n_counters, ws[1].numel())
        ws = (torch.empty(n_floats, dtype=torch.float32, device=device),
              torch.zeros(n_counters, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, spec: AttnSpec,
                         kv_valid: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         force_simt: bool = False, return_lse: bool = False):
    """Attention of q over (k, v) -> (B, Sq, H, hd) in q.dtype (see ref.py).

    ``force_simt`` launches the kernel of ``flash_attention.cu`` where
    ``variant`` would pick the wgmma or decode one, to time them on the same
    inputs. ``return_lse`` (the decode kernel's calls only) also returns
    each row's float32 log-sum-exp (B, 1, H), -1e30 where a row sees no key
    (``ref.attention_lse_ref``)."""
    return _flash_attention_cuda(q, k, v, q_pos, kv_pos, spec, kv_valid, scale, force_simt,
                                 return_lse=return_lse)


def _flash_attention_cuda(q, k, v, q_pos, kv_pos, spec, kv_valid=None, scale=None,
                          force_simt=False, n_split: Optional[int] = None,
                          rows: Optional[int] = None, return_lse: bool = False):
    """``flash_attention_cuda``, where a given ``n_split`` fixes the decode
    kernel's split count (``split_plan``; else ``decode_plan`` picks it) and a
    given ``rows`` the SIMT kernel's rows a block (else ``simt_rows``): the
    tests reach one split and many, and every row tile, at one shape."""
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
    if n_split is not None and route != "decode":
        raise ValueError(f"flash_attention: n_split is for the decode kernel, this call "
                         f"takes the {route} one")
    if rows is not None and (route != "simt" or rows not in simt_row_sizes(hd)):
        raise ValueError(f"flash_attention: rows must be one of {simt_row_sizes(hd)} at hd "
                         f"{hd} and is for the SIMT kernel; this call takes the {route} one")
    if return_lse and route != "decode":
        raise ValueError(f"flash_attention: the log-sum-exp output is the decode kernel's "
                         f"(Sq = 1, hd a multiple of {DECODE_HEAD_DIM_MULTIPLE}); this call "
                         f"takes the {route} one")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, 1, h), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0 or skv == 0:
        return (out.zero_(), lse.fill_(NEG)) if return_lse else out.zero_()
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
            if rows is None:
                rows = simt_rows(b, sq, hkv, h // hkv, hd, device_sms(q.device))
            err = lib.flash_attention_launch(*args, DTYPES[q.dtype], rows, *mask, stream)
        elif route == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, *mask, stream)
        else:
            group = h // hkv
            rows = decode_rows(group)
            n_split, split_tiles = (
                decode_plan(b, skv, hkv, group, decode_slots(q.device, q.dtype, hd, group))
                if n_split is None else split_plan(skv, n_split))
            ws = cnt = None
            if n_split > 1:
                blocks = b * hkv * -(-group // rows)
                ws, cnt = (t.data_ptr() for t in _decode_workspace(
                    q.device, stream, blocks * n_split * rows * (hd + 2), blocks))
            err = lib.flash_decode_launch(*args[:7], None if lse is None else lse.data_ptr(),
                                          ws, cnt, b, skv, h, hkv, hd,
                                          DTYPES[q.dtype], rows, n_split, split_tiles, *mask,
                                          stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {route} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    launches["flash_attention"] += 1
    if route != "simt":
        launches[f"flash_attention_{route}"] += 1
    if return_lse:
        launches["flash_attention_decode_lse"] += 1
        return out, lse
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes (a view
    at an offset): the kernels copy rows in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
