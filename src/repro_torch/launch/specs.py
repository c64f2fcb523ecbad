"""Abstract inputs and placements of the serving and training steps of the
port; counterpart of ``repro.launch.specs``.

``batch_abstract`` and ``decode_abstract`` give a cell's global inputs as
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and
dtypes, no storage, so a 524,288-slot cache allocates nothing), under the
JAX package's names, shapes and dtypes. ``batch_pspecs``, ``cache_pspecs``
and ``decode_pspecs`` place them over name -> shape mappings, with tuples
of mesh axis names and ``None`` for the JAX package's ``PartitionSpec`` (a
one-name entry is the bare name, as JAX normalises it). ``mesh`` is a live
``DeviceMesh`` or a mapping of axis name -> size.

Cache sharding policy (decode):

  batch dim   -> the data-parallel axes when they divide it,
  kv heads    -> 'model' when they divide over it,
  else seq    -> 'model' (and the data-parallel axes too when the batch
                 cannot shard, as at long_500k's batch of 1): each rank
                 attends over its block of slots with every q head and the
                 ranks' partial outputs are merged by log-sum-exp
                 (``models/transformer.py``).

``models`` allocates each rank's block of a decode cache as
``cache_pspecs`` places it (``local_shape``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Mapping, Optional

import torch

from ..configs.base import SHAPES
from ..parallel.sharding import axis_sizes, batch_axes, mesh_context


def _entry(axes) -> Any:
    """A spec entry: None, one axis name, or a tuple of them."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else axes
    if isinstance(axes, tuple):
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


def _shape(leaf) -> tuple[int, ...]:
    if isinstance(leaf, (tuple, list)):
        return tuple(leaf)
    return tuple(getattr(leaf, "shape", ()))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in batch_axes(mesh))


@contextlib.contextmanager
def abstract():
    """Tensors made within the block are fake: the ``FakeTensorMode`` that
    is active, else a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        yield
        return
    with FakeTensorMode():
        yield


def batch_abstract(cfg, shape_name: str, kind: str) -> dict[str, torch.Tensor]:
    """The global batch of a train or prefill cell as fake tensors (the JAX
    package's names, shapes and dtypes)."""
    seq, gb, _ = SHAPES[shape_name]
    i32, f32 = torch.int32, torch.float32
    out: dict[str, torch.Tensor] = {}
    with abstract():
        if cfg.family == "vlm":
            text = seq - cfg.n_img_tokens
            out["tokens"] = torch.empty((gb, text), dtype=i32)
            out["patches"] = torch.empty((gb, cfg.n_img_tokens, cfg.d_model), dtype=f32)
        elif cfg.family == "encdec":
            text = seq
            out["tokens"] = torch.empty((gb, seq), dtype=i32)
            out["frames"] = torch.empty((gb, cfg.enc_ctx, cfg.d_model), dtype=f32)
        else:
            text = seq
            out["tokens"] = torch.empty((gb, seq), dtype=i32)
        if kind == "train":
            out["labels"] = torch.empty((gb, text), dtype=i32)
            out["weights"] = torch.empty((gb,), dtype=f32)
    return out


def decode_abstract(cfg, model, shape_name: str) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(global cache, (gb, 1) int32 next-token input) of a decode cell as
    fake tensors: ``model.init_cache(gb, seq)`` (a cache of ``seq`` tokens
    of context) outside any mesh, ``pos`` as a 0-d int32 tensor as in the
    JAX package's cache."""
    seq, gb, _ = SHAPES[shape_name]
    with abstract(), mesh_context(None):
        cache = model.init_cache(gb, seq)
        cache["pos"] = torch.zeros((), dtype=torch.int32)
        return cache, torch.empty((gb, 1), dtype=torch.int32)


def batch_pspecs(cfg, shapes: Mapping[str, Any], mesh) -> dict[str, tuple]:
    """Placements of a train or prefill batch (name -> shape, as
    ``batch_abstract`` names them): the rows on the batch axes where the
    global batch divides over them."""
    gb = _shape(shapes["tokens"])[0]
    b = _entry(batch_axes(mesh)) if gb % _dp_size(mesh) == 0 else None
    out = {}
    for name in shapes:
        if name == "weights":
            out[name] = (b,)
        elif name in ("patches", "frames"):
            out[name] = (b, None, None)
        else:
            out[name] = (b, None)
    return out


def cache_pspecs(cfg, cache: Mapping[str, Any], mesh, gb: int) -> dict[str, tuple]:
    """Placements of a decode cache (name -> shape or tensor) of global
    batch ``gb`` (see the module doc)."""
    bax = batch_axes(mesh)
    dp = _dp_size(mesh)
    msz = axis_sizes(mesh).get("model", 1)
    b = _entry(bax) if (gb % dp == 0 and gb >= dp) else None
    shapes = {name: _shape(leaf) for name, leaf in cache.items()}

    def heads_fit(h: int) -> bool:
        return h % msz == 0 and h >= msz

    def leaf_spec(name: str, shape: tuple) -> tuple:
        if len(shape) == 0:
            return ()
        if name.startswith(("k", "v", "attn_k", "attn_v", "cross_k", "cross_v")) \
                and len(shape) == 5:
            _, _, s, h, _ = shape
            h_ax = "model" if heads_fit(h) else None
            s_parts = []
            if b is None and s % dp == 0:
                s_parts.extend(bax)
            if h_ax is None and s % msz == 0:
                s_parts.append("model")
            return (None, b, _entry(s_parts), h_ax, None)
        if name.startswith(("kv_pos", "attn_pos")) and len(shape) == 3:
            s = shape[2]
            s_parts = []
            if b is None and s % dp == 0:
                s_parts.extend(bax)
            kv_shape = shapes.get(name.replace("kv_pos", "k").replace("attn_pos", "attn_k"))
            if kv_shape is not None and not heads_fit(kv_shape[3]) and s % msz == 0:
                s_parts.append("model")
            return (None, b, _entry(s_parts))
        if name == "conv" and len(shape) == 4:  # (L, B, K-1, DI)
            return (None, b, None, "model" if shape[3] % msz == 0 else None)
        if name == "h" and len(shape) == 4:  # mamba1 (L, B, DI, N)
            return (None, b, "model" if shape[2] % msz == 0 else None, None)
        if name == "h" and len(shape) == 5:  # mamba2 (L, B, H, N, P)
            return (None, b, "model" if shape[2] % msz == 0 else None, None, None)
        return (None,) * len(shape)

    return {name: leaf_spec(name, shape) for name, shape in shapes.items()}


def decode_pspecs(cfg, cache: Mapping[str, Any], gb: int, mesh) -> tuple[dict, tuple]:
    """(cache placements, placement of the (gb, 1) next-token input)."""
    dp = _dp_size(mesh)
    b = _entry(batch_axes(mesh)) if (gb % dp == 0 and gb >= dp) else None
    return cache_pspecs(cfg, cache, mesh, gb), (b, None)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` placed by
    ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(dim // math.prod(sizes.get(a, 1) for a in axes))
    return tuple(out)


def seq_axes(spec: tuple) -> tuple[str, ...]:
    """The mesh axes of a cache leaf's sequence dim (dim 2)."""
    entry: Optional[Any] = spec[2] if len(spec) > 2 else None
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


__all__ = ["abstract", "batch_abstract", "batch_pspecs", "cache_pspecs", "decode_abstract",
           "decode_pspecs", "local_shape", "seq_axes"]
