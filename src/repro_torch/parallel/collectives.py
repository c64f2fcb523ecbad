"""Cross-pod collectives of the port: the int8-compressed gradient sum;
counterpart of ``repro.parallel.collectives``.

At multi-pod scale the ``pod`` axis is the slow link. Across pods each pod
sends an int8-quantised copy of its partial (4x fewer bytes than bf16, 8x
fewer than float32) with one float32 scale, and every rank dequantises and
sums the pods' copies locally. With error feedback at the optimizer level
(``repro_torch.optim.compression``) the quantisation bias vanishes over
steps.

The payloads are all-gathered over the mesh's ``pod`` process group
(``mesh["pod"].get_group()``); the ``data`` and ``model`` axes are not
touched, so this composes with any in-pod layout. Without a ``pod`` axis
both functions return the tree as it is.
"""
from __future__ import annotations

import torch

from .sharding import all_gather, axis_sizes, tree_map


def _int8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-d): scale = max|x| / 127 in float32, floored
    at 1e-12 before the division; q = x / scale rounded half to even and
    clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _pod_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the pods of their int8 copies of ``x``, in pod order, in
    ``x.dtype``."""
    q, scale = _int8_pack(x)
    qs = all_gather(q.reshape(1, *q.shape), 0, group)  # int8 on the slow link
    ss = all_gather(scale.reshape(1), 0, group)
    deq = qs.float() * ss.reshape((-1,) + (1,) * x.dim())
    return torch.sum(deq, dim=0).to(x.dtype)


def cross_pod_sum_partials(tree, mesh):
    """Every rank holds its pod's same-shape partial of each leaf; returns
    the cross-pod sum of the int8 copies, on every rank."""
    if "pod" not in axis_sizes(mesh):
        return tree
    group = mesh.get_group("pod")
    return tree_map(lambda x: _pod_sum(x, group), tree)


def cross_pod_compressed_allreduce(tree, mesh):
    """The leaves are stacked per-pod partials (the global arrays, the
    leading axis split over ``pod`` in pod order, as the JAX package's
    ``P("pod")``); each pod sends its block and every rank returns the
    cross-pod sum of the int8 copies, one block's shape."""
    sizes = axis_sizes(mesh)
    if "pod" not in sizes:
        return tree
    n, p = sizes["pod"], mesh.get_local_rank("pod")
    group = mesh.get_group("pod")

    def leaf(x):
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} pods")
        b = x.shape[0] // n
        return _pod_sum(x[p * b:(p + 1) * b], group)

    return tree_map(leaf, tree)
