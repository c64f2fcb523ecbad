"""Mesh construction of the port on ``torch.distributed``; counterpart of
``repro.launch.mesh``.

One rank per device. ``make_host_mesh`` joins the process group that is
already up, or starts one: from the ``torchrun`` variables where they are
set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...), else as a world of 1
through an in-process store (no network address). The backend is NCCL for
CUDA tensors and gloo for CPU tensors.

Single pod: 16 x 16 = 256 ranks (data x model).
Multi-pod:  2 x 16 x 16 = 512 ranks (pod x data x model); parameters
replicate across ``pod``, and the gradient sum over it is where int8
compression applies (``parallel.collectives``).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..parallel.sharding import axis_sizes, tree_map

TIMEOUT = datetime.timedelta(minutes=10)  # a collective waiting longer raises
# Meshes built over the live process group, by (group, device, shape): each
# new mesh makes a process group per axis, so the entry points share one.
_MESHES: dict = {}


def mesh_device(device=None) -> torch.device:
    """``cuda:LOCAL_RANK`` unless the caller names another device; without
    a card only an explicit non-CUDA device is accepted."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def local_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def ensure_process_group() -> None:
    """Join the process group that is up, else start one (see module doc)."""
    if dist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)


def _mesh(device: torch.device, shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    key = (id(dist.group.WORLD), str(device), shape, names)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device.type, shape, mesh_dim_names=names)
    return _MESHES[key]


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A (world // mp, mp) mesh named ("data", "model") over every rank of
    the process group (tests / examples / the entry points); ``device``
    picks the device type (``mesh_device``)."""
    dev = mesh_device(device)
    ensure_process_group()
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return _mesh(dev, (n // mp, mp), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model");
    raises unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = mesh_device(device)
    ensure_process_group()
    want = 1
    for s in shape:
        want *= s
    if dist.get_world_size() != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks; the world has "
                         f"{dist.get_world_size()}")
    return _mesh(dev, shape, names)


def shard_leading_axis(tree, mesh, axis: str = "data"):
    """This rank's block of every leaf's leading axis over one mesh axis:
    contiguous blocks in rank order, as ``P(axis)`` lays them out (the fleet
    engine's K slices). K must divide by the axis size."""
    n, r = axis_sizes(mesh)[axis], mesh.get_local_rank(axis)

    def block(leaf):
        if leaf.dim() == 0 or leaf.shape[0] % n:
            raise ValueError(f"a leading axis of {tuple(leaf.shape)[:1]} does not divide over "
                             f"the {n} ranks of mesh axis {axis!r}")
        b = leaf.shape[0] // n
        return leaf[r * b:(r + 1) * b]

    return tree_map(block, tree)
