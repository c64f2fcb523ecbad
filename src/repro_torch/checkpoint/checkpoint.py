"""Checkpointing of the port; counterpart of ``repro.checkpoint.checkpoint``.

  * one ``step_<N>.npz`` per snapshot, written to a temporary file, fsynced,
    then atomically renamed: a crash mid-write never corrupts the latest
    checkpoint;
  * ``latest_step`` / ``CheckpointManager.resume``: the training loop
    restarts from the newest complete snapshot (see launch/train.py);
  * a retention window bounds disk usage;
  * elastic resharding: under a mesh, ``save`` gathers each sharded leaf
    (``shardings``: a tree of ``parallel.sharding.Sharding`` or ``None``
    beside the tree) and rank 0 alone writes the full arrays;
    ``restore_sharded`` takes each rank's block under the current mesh, so
    a run resumes at another data-parallel width.

A tree is nested mappings and named tuples of tensors (any device), numpy
arrays or scalars. Leaves are stored as host arrays under "/"-joined keys in
the JAX package's layout: a mapping key's dots (a module's parameter names,
``blocks.wq``) become "/" as in the JAX package's nested parameter trees, and
a named tuple's field ``f`` is ``.f`` (``opt/.m/blocks/wq``), so the two
packages read each other's snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import tempfile
from typing import Any, Optional

import numpy as np


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child, name) triples of an inner node (``name``: the mapping
    key or field name), or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k).replace(".", "/"), v, k) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f), f) for f in tree._fields]
    return None


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sub(shardings, name):
    """The shardings subtree of the child ``name`` (None: none)."""
    if shardings is None:
        return None
    return shardings.get(name) if isinstance(shardings, dict) else getattr(shardings, name)


def _flatten(tree, prefix: str = "", shardings=None) -> dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        if shardings is not None:  # this rank's block -> the global array
            tree = shardings.gather(tree)
        return {prefix: _host(tree)}
    flat = {}
    for key, child, name in kids:
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else key,
                             _sub(shardings, name)))
    return flat


def _unflatten(template, flat: dict[str, np.ndarray], prefix: str = "", shardings=None):
    kids = _children(template)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = flat[prefix]
        if shardings is not None:  # the global array -> this rank's block
            arr = np.ascontiguousarray(shardings.local(arr))
        shape = getattr(template, "shape", None)
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} vs "
                             f"template {tuple(shape)}")
        return arr
    vals = [_unflatten(child, flat, f"{prefix}/{key}" if prefix else key,
                       _sub(shardings, name))
            for key, child, name in kids]
    if isinstance(template, dict):
        return dict(zip(template, vals))
    return type(template)(*vals)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def save(path: str | pathlib.Path, step: int, tree: Any,
         extra: Optional[dict] = None, shardings: Any = None) -> pathlib.Path:
    """Atomic snapshot: write a temporary file in the same directory, fsync,
    rename. With ``shardings`` (a tree beside ``tree``: a leaf's
    ``Sharding`` or ``None``), every rank calls it: the sharded leaves are
    gathered, rank 0 writes the full arrays, and a barrier follows."""
    path = pathlib.Path(path)
    flat = _flatten(tree, shardings=shardings)
    final = path / f"step_{step:010d}.npz"
    if shardings is not None and _rank() != 0:
        _barrier()
        return final
    path.mkdir(parents=True, exist_ok=True)
    if extra:
        flat["__meta__"] = np.frombuffer(json.dumps(extra).encode(), dtype=np.uint8).copy()
    final = path / f"step_{step:010d}.npz"
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if shardings is not None:
        _barrier()
    return final


def latest_step(path: str | pathlib.Path) -> Optional[int]:
    path = pathlib.Path(path)
    if not path.exists():
        return None
    steps = [int(m.group(1)) for f in path.iterdir()
             if (m := re.fullmatch(r"step_(\d+)\.npz", f.name))]
    return max(steps) if steps else None


def restore(path: str | pathlib.Path, step: int, template: Any):
    """Load a snapshot as host numpy arrays shaped like ``template``;
    returns (tree, meta)."""
    return restore_sharded(path, step, template, None)


def restore_sharded(path: str | pathlib.Path, step: int, template: Any, shardings: Any):
    """Elastic restore: each leaf with a ``Sharding`` in ``shardings`` (a
    tree beside ``template``, under the current mesh, of any shape) comes
    back as this rank's block of the snapshot's full array, as host numpy
    arrays shaped like ``template``'s (local) leaves; returns (tree, meta)."""
    with np.load(pathlib.Path(path) / f"step_{step:010d}.npz") as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = None
        if "__meta__" in z.files:
            meta = json.loads(bytes(z["__meta__"]).decode())
    return _unflatten(template, flat, shardings=shardings), meta


def load_into(template: Any, host_tree: Any) -> None:
    """Copy a restored tree of host arrays into the tensors of ``template``
    (same structure), in place."""
    import torch

    kids = _children(template)
    if kids is None:
        with torch.no_grad():
            template.copy_(torch.as_tensor(np.asarray(host_tree)))
        return
    sub = host_tree.values() if isinstance(template, dict) else host_tree
    for (_, child, _), value in zip(kids, sub):
        load_into(child, value)


@dataclasses.dataclass
class CheckpointManager:
    """save-every-N + retention + auto-resume convenience wrapper."""

    directory: str
    every_steps: int = 50
    keep: int = 3

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None,
                   shardings: Any = None) -> bool:
        if step % self.every_steps:
            return False
        save(self.directory, step, tree, extra, shardings)
        if _rank() == 0:
            self._gc()
        return True

    def _gc(self):
        path = pathlib.Path(self.directory)
        snaps = sorted(f for f in path.iterdir() if re.fullmatch(r"step_\d+\.npz", f.name))
        for f in snaps[:-self.keep]:
            f.unlink()

    def resume(self, template: Any, shardings: Any = None):
        """Returns (tree, meta, step) from the newest snapshot, or None;
        with ``shardings``, each rank's blocks (``restore_sharded``)."""
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = restore_sharded(self.directory, step, template, shardings)
        return tree, meta, step
