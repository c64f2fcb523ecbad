"""Sharding rules of the port: the JAX package's 2-D (FSDP x TP) parameter
layout on a ``torch.distributed`` ``DeviceMesh``, and the FSDP weight
gather; counterpart of ``repro.parallel.sharding``.

Mesh axes (the JAX package's names):
  pod    cross-pod data parallelism (multi-pod mesh only; parameters replicate
         over it, and so do the AdamW moments)
  data   in-pod data parallelism; also holds the ZeRO shard of the parameters
         and of the AdamW moments
  model  tensor parallelism (heads / ffn / vocab / d_inner)

A mesh is a ``DeviceMesh`` with one rank per device, and every tensor is a
rank's local block: a sharded parameter is its rank's block of the global
array (contiguous blocks in rank order, as ``P("data")`` lays them out) and
a batch is its rank's rows. The placement rules (``param_pspec``,
``batch_axes``, ``kv_layout``, ``dp_group_count``) return what the JAX
package's return, as tuples of axis names and ``None``; they also take a
mapping of axis name -> size in place of a mesh, for meshes larger than the
world.

The paper mapping: each data-parallel rank is one EC (ML worker); the
scheduler's x / y / z decisions set the rows and sample weights of each
rank's batch, and the gradient reduction across the ranks is eq. 15's
|D_j|-weighted aggregation (``launch/steps.py``).

Every style executes on every mesh, for every family. In ``serve`` and
``tp`` each rank keeps its block of every leaf on both axes (``Sharding``),
a product whose contracting dim is on ``model`` ends in one
``tp_all_reduce``, and serving gathers the logits along the vocab
(``tp_all_gather``). Under autograd these are Megatron's pair: g
(``tp_all_reduce``: all-reduce forward, identity backward) and f
(``tp_copy``: identity forward, all-reduce of the gradient backward), put
on every replicated activation that rank-local work consumes, so a
replicated leaf's gradient comes out whole and equal on every ``model``
rank. ``tp_sp`` is ``tp`` inside a layer, and between layers each
``model`` rank keeps its block of the positions (``seq_split`` /
``seq_gather``, placed by ``models.layers.apply_layers``). ``fsdp`` has no
tensor parallelism: the batch goes over every axis, ``tp_size()`` is 1, and
each leaf is gathered whole over ``data`` and ``model`` at its use
(``gather_params``); the blocks stored stay those of the rule table. A
decode under ``fsdp`` on a ``model`` axis above 1 raises
(``check_decode``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from collections import Counter
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

_MESH: Any = None
# Parallelism style (the JAX package's):
#   "tp"    batch on (pod, data); TP on model; ZeRO over data
#   "tp_sp" as tp for the weights; sequence-sharded remat carries
#   "fsdp"  batch over every axis; weights gathered whole per layer (ZeRO-3)
#   "serve" weights TP-sharded on model and replicated over data
_STYLE: str = "tp"

# Collectives issued by this package since the last reset, and their bytes
# (each rank's payload: what it sends into an all-gather, its full input
# of a reduce-scatter or an all-reduce).
comm_counts: Counter = Counter()


def reset_comm_counts() -> None:
    comm_counts.clear()


@contextlib.contextmanager
def mesh_context(mesh, style: str = "tp"):
    """Install ``mesh`` (a ``DeviceMesh``, or a mapping of axis name ->
    size for the placement rules alone) and the parallelism style."""
    global _MESH, _STYLE
    prev, prev_style = _MESH, _STYLE
    _MESH, _STYLE = mesh, style
    try:
        yield mesh
    finally:
        _MESH, _STYLE = prev, prev_style


def current_mesh():
    return _MESH


def current_style() -> str:
    return _STYLE


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_axes(mesh) -> tuple[str, ...]:
    names = tuple(axis_sizes(mesh))
    if _STYLE == "fsdp":
        return names  # batch over every axis
    return ("pod", "data") if "pod" in names else ("data",)


def constrain_act(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The identity: a rank's activations are its local rows already (the
    JAX package constrains a global array's layout here)."""
    return x


def kv_layout(n_kv_heads: int) -> str:
    """Decode KV-cache layout policy: 'heads' when the kv head count shards
    exactly on the model axis, else 'seq'."""
    if _MESH is None:
        return "heads"
    msz = axis_sizes(_MESH).get("model", 1)
    return "heads" if (n_kv_heads % msz == 0 and n_kv_heads >= msz) else "seq"


def dp_group_count(n_items: int) -> int:
    """Static DP shard count for shard-local batch grouping (MoE dispatch):
    the number of batch-axis shards if it divides n_items, else 1."""
    if _MESH is None:
        return 1
    sizes = axis_sizes(_MESH)
    dp = math.prod(sizes.get(a, 1) for a in batch_axes(_MESH))
    return dp if (n_items % dp == 0 and n_items >= dp) else 1


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

# Leaf-name -> partition spec for the *trailing* (non-stacked) dims.
# 'F' = fsdp/ZeRO axis ('data'), 'T' = tensor axis ('model').
_RULES: list[tuple[str, Optional[tuple]]] = [
    (r"(^|/)embed$", ("T", "F")),  # (V, D): vocab on model
    (r"(^|/)pos_embed$", (None, None)),
    (r"(^|/)(cross_)?w[qkv]$", ("F", "T", None)),  # (D, H, hd): heads on model
    (r"(^|/)b[qkv]$", ("T", None)),  # (H, hd)
    (r"(^|/)(cross_)?wo$", ("T", None, "F")),  # (H, hd, D)
    (r"(^|/)w_(gate|up)$", ("F", "T")),  # (D, FF)
    (r"(^|/)w_down$", ("T", "F")),  # (FF, D)
    (r"(^|/)router$", ("F", None)),  # (D, E)
    (r"(^|/)we_(gate|up)$", (None, "F", "T")),  # (E, D, FF)
    (r"(^|/)we_down$", (None, "T", "F")),  # (E, FF, D)
    (r"(^|/)in_proj$", ("F", "T")),  # (D, ...) ssm
    (r"(^|/)conv_w$", ("T", None)),  # (DI, K)
    (r"(^|/)conv_b$", ("T",)),
    (r"(^|/)x_proj$", ("T", None)),  # (DI, R+2N)
    (r"(^|/)dt_proj$", (None, "T")),  # (R, DI)
    (r"(^|/)dt_bias$", ("T",)),
    (r"(^|/)a_log$", ("T", None)),  # (DI, N) or (H,) mamba2
    (r"(^|/)ssm_d$", ("T",)),
    (r"(^|/)out_proj$", ("T", "F")),  # (DI, D)
    (r"(^|/).*norm.*$", None),  # any norm scale/bias: replicated
    (r"(^|/)head$", ("F", "T")),  # (D, V) lm head
]


def _path(name: str) -> str:
    """A parameter name of the port (``blocks.wq``) as the JAX package's
    tree path (``blocks/wq``)."""
    return name.replace(".", "/")


def param_pspec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The placement of one parameter: a tuple with one mesh axis name or
    ``None`` per dim, as the JAX package's ``PartitionSpec``.

    Stacked layer params (path containing 'blocks') get a leading None for
    the layer dim; a dim that does not divide by its axis size is left
    unsharded."""
    path = _path(path)
    stacked = "blocks" in path or "enc_blocks" in path or "dec_blocks" in path
    trailing = shape[1:] if stacked else shape
    spec: Optional[tuple] = None
    for pat, rule in _RULES:
        if re.search(pat, path):
            spec = rule
            break
    if spec is None or len(spec) != len(trailing):
        # no rule, or a rank mismatch (a bias picked up a matrix rule): replicate
        spec = (None,) * len(trailing)

    ax = {"F": "data", "T": "model", None: None}
    if _STYLE == "serve":  # replicate over data: no FSDP gathers per token
        ax = {"F": None, "T": "model", None: None}
    sizes = axis_sizes(mesh)
    resolved = []
    for dim, s in zip(trailing, spec):
        name = ax[s]
        if name is not None and dim % sizes.get(name, 1) != 0:
            name = None
        resolved.append(name)
    if stacked:
        resolved = [None] + resolved
    return tuple(resolved)


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if hasattr(params, "named_parameters") \
        else dict(params)


def shard_params_pspecs(params, mesh) -> dict[str, tuple]:
    """name -> placement of every parameter of ``params`` (a module or a
    name -> tensor mapping)."""
    return {k: param_pspec(k, tuple(p.shape), mesh) for k, p in _named(params).items()}


# ---------------------------------------------------------------------------
# Placements on a live mesh
# ---------------------------------------------------------------------------

def model_axis(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one)."""
    return axis_sizes(mesh).get("model", 1) if mesh is not None else 1


def check_decode(mesh) -> None:
    """Raises for a decode (or its cache) under ``fsdp`` on a ``model``
    axis above 1 (``mesh``: a ``DeviceMesh``, a mapping of axis sizes or
    ``None``), which has no placement to port."""
    if _STYLE == "fsdp" and model_axis(mesh) > 1:
        raise NotImplementedError(
            "a decode under the fsdp style on a model axis above 1 has no placement: the JAX "
            "package's cache_pspecs puts a cache's slots on ('data', 'model') and its kv heads "
            "(or a block of its slots) on 'model' again, a duplicate 'model' placement that "
            "JAX refuses (DuplicateSpecError); fsdp runs the forward and the train step")


def _coord(mesh, axes) -> tuple[int, int]:
    """(this rank's linear index over ``axes``, row-major, and their size
    product)."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        if a in sizes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
    return idx, n


def _cat(pieces, dim: int):
    return torch.cat(pieces, dim) if isinstance(pieces[0], torch.Tensor) else \
        np.concatenate(pieces, dim)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leaf's placement on a live mesh: its spec, its global shape, and
    ``parts``, the parts of its ``model`` dim that are blocked each on its
    own: an int for that many equal parts (2 for Mamba-1's fused
    ``in_proj`` ``[x | z]``: a rank holds ``[x_r | z_r]``, not block r of
    the concatenation), or a tuple of (size, blocked) parts, where a part
    that is not blocked is whole on every rank (Mamba-2's ``[z | x | B | C
    | dt]``: a rank holds ``[z_r | x_r | B | C | dt_r]``). The global array
    keeps the JAX package's layout either way."""

    mesh: Any
    spec: tuple
    global_shape: tuple[int, ...]
    parts: Any = 1

    @property
    def dim(self) -> Optional[int]:
        """The dim that holds the ``data`` shard (``None``: replicated)."""
        return self.spec.index("data") if "data" in self.spec else None

    @property
    def tp_dim(self) -> Optional[int]:
        """The dim that holds the ``model`` block (``None``: whole)."""
        return self.spec.index("model") if "model" in self.spec else None

    def segments(self, n: int) -> list[tuple[int, int, bool]]:
        """(global size, size on a rank, blocked) of each part of the
        ``model`` dim over ``n`` ranks; raises where a blocked part does not
        divide."""
        size = self.global_shape[self.tp_dim]
        parts = self.parts
        if isinstance(parts, int):
            parts = ((size // parts, True),) * parts
        if sum(p for p, _ in parts) != size:
            raise ValueError(f"parts {parts} do not make up the model dim of {size}")
        out = []
        for p, blocked in parts:
            if blocked and p % n:
                raise NotImplementedError(
                    f"a part of {p} of a fused leaf {self.global_shape} does not divide over "
                    f"a model axis of {n}")
            out.append((p, p // n if blocked else p, blocked))
        return out

    def tp_whole(self) -> list[tuple[int, int]]:
        """(start, stop) on a rank's block of the parts of the ``model`` dim
        that every rank holds whole."""
        if self.tp_dim is None:
            return []
        out, at = [], 0
        for _, local, blocked in self.segments(_coord(self.mesh, ("model",))[1]):
            if not blocked:
                out.append((at, at + local))
            at += local
        return out

    def offset(self, dim: int) -> int:
        """Where this rank's block starts along ``dim`` of the global array
        (a dim of one part)."""
        for d, axis in ((self.dim, "data"), (self.tp_dim, "model")):
            if d == dim:
                if axis == "model" and self.parts != 1:
                    raise ValueError(f"dim {dim} holds the parts {self.parts}, each blocked "
                                     f"on its own")
                r, n = _coord(self.mesh, (axis,))
                return r * (self.global_shape[dim] // n)
        return 0

    def local(self, full):
        """This rank's block of the global array ``full`` (a tensor or a
        numpy array): its ``data`` shard and its ``model`` block, part by
        part."""
        if tuple(full.shape) != tuple(self.global_shape):
            raise ValueError(f"shape {tuple(full.shape)} is not the global shape "
                             f"{self.global_shape}")
        out = full
        if self.dim is not None:
            r, n = _coord(self.mesh, ("data",))
            size = full.shape[self.dim] // n
            out = _narrow(out, self.dim, r * size, size)
        if self.tp_dim is not None:
            r, n = _coord(self.mesh, ("model",))
            pieces, start = [], 0
            for size, local, blocked in self.segments(n):
                pieces.append(_narrow(out, self.tp_dim,
                                      start + (r * local if blocked else 0), local))
                start += size
            out = pieces[0] if len(pieces) == 1 else _cat(pieces, self.tp_dim)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (one all-gather over
        the leaf's ``data`` and ``model`` axes; no autograd)."""
        axes = tuple(a for a, d in (("data", self.dim), ("model", self.tp_dim)) if d is not None)
        if not axes:
            return local.detach()
        group = axes_group(self.mesh, axes)
        flat = all_gather(local.detach().reshape(-1), 0, group)
        return _blocks(self, local.shape, axes).assemble(flat.view(dist.get_world_size(group), -1))

    def per_layer(self) -> "Sharding":
        """The placement of one layer's view of a stacked leaf."""
        return Sharding(self.mesh, self.spec[1:], self.global_shape[1:], self.parts)


def _narrow(x, dim: int, start: int, size: int):
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(start, start + size)
    return x[tuple(index)]


def sharding_of(t) -> Optional[Sharding]:
    return getattr(t, "_sharding", None)


def param_shardings(params) -> dict[str, Optional[Sharding]]:
    return {k: sharding_of(p) for k, p in _named(params).items()}


def _fused(params) -> dict[str, Any]:
    """name -> parts of the model's fused leaves (``tp_fused``)."""
    return dict(getattr(params, "tp_fused", {}))


def _placement(name: str, p: torch.Tensor, mesh, parts: dict) -> Sharding:
    sh = Sharding(mesh, param_pspec(name, tuple(p.shape), mesh), tuple(p.shape),
                  parts.get(name, 1))
    if sh.tp_dim is not None:
        sh.segments(model_axis(mesh))  # raises where a fused part does not divide
    return sh


@torch.no_grad()
def shard_params(params, mesh):
    """Keep each rank's block of every parameter of ``params`` (a module,
    whose parameters are replaced in place, or a name -> tensor mapping,
    for which a new dict is returned) under the rule table, and record each
    leaf's ``Sharding`` on it."""
    parts = _fused(params)
    out = {}
    for name, p in _named(params).items():
        sh = _placement(name, p, mesh, parts)
        local = sh.local(p.detach())
        if sh.dim is not None or sh.tp_dim is not None:  # a block of its own
            local = local.clone(memory_format=torch.contiguous_format)
        if isinstance(p, torch.nn.Parameter):
            p.data = local
            t = p
        else:
            t = local
        t._sharding = sh
        out[name] = t
    return params if hasattr(params, "named_parameters") else out


@torch.no_grad()
def empty_blocks(module: torch.nn.Module, mesh, device) -> torch.nn.Module:
    """Replace every parameter of ``module`` (built on the meta device at
    the global shapes) by an uninitialised one on ``device`` at the shape
    of this rank's block, its ``Sharding`` recorded on it, so that the
    initialisers draw each global block and keep this rank's
    (``models.layers.dense_fill_``)."""
    parts = _fused(module)
    for name, p in list(module.named_parameters()):
        sh = _placement(name, p, mesh, parts)
        local = torch.nn.Parameter(torch.empty(tuple(sh.local(p).shape), dtype=p.dtype,
                                               device=device), requires_grad=p.requires_grad)
        local._sharding = sh
        owner, _, attr = name.rpartition(".")
        parent = module.get_submodule(owner) if owner else module
        if isinstance(parent, torch.nn.ParameterDict):
            parent[attr] = local
        else:
            setattr(parent, attr, local)
    return module


def local_rows(x, mesh):
    """This rank's block of rows of a global batch leaf (the leading axis
    over the batch axes, in rank order); raises where the rows do not divide
    into the batch-axis shards (the JAX package's MoE then groups the whole
    batch as one)."""
    r, n = _coord(mesh, batch_axes(mesh))
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over {n} data-parallel ranks")
    return x[r * (b // n):(r + 1) * (b // n)]


def batch_groups(mesh, skip: tuple[str, ...] = ()) -> list:
    """The process groups of the batch axes (one a mesh axis), except
    ``skip``."""
    return [mesh.get_group(a) for a in batch_axes(mesh) if a not in skip]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, dim: int, group, key: str = "all_gather") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order. The
    ranks' blocks travel as they are stored and land one after another; the
    result is a view of them where ``dim`` is 0 or the group has one rank,
    else one copy that interleaves them. Counted under ``key``."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    x = x.contiguous()
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.view(-1), group=group)
    comm_counts[key] += 1
    comm_counts[f"{key}_bytes"] += x.numel() * x.element_size()
    return out.view(n, *x.shape).movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ranks of ``x``, each rank keeping its block along
    ``dim``. The blocks are laid out one after another first: a copy where
    ``dim`` is not 0 and the group has more than one rank, else a view."""
    n = dist.get_world_size(group)
    s = x.shape[dim] // n
    blocks = x.reshape(*x.shape[:dim], n, s, *x.shape[dim + 1:]).movedim(dim, 0).contiguous()
    out = x.new_empty(blocks.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), blocks.view(-1), op=dist.ReduceOp.SUM, group=group)
    comm_counts["reduce_scatter"] += 1
    comm_counts["reduce_scatter_bytes"] += x.numel() * x.element_size()
    return out


def all_reduce_(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum ``x`` in place over each group in turn (a sum over their
    product); returns ``x``."""
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
        comm_counts["all_reduce"] += 1
        comm_counts["all_reduce_bytes"] += x.numel() * x.element_size()
    return x


def tp_size() -> int:
    """The ``model`` axis size of the installed mesh (1 without one, and
    under ``fsdp``, where the model axis holds batch rows, not a block of
    each layer's work)."""
    return model_axis(_MESH) if _MESH is not None and _STYLE != "fsdp" else 1


def tp_rank() -> int:
    """This rank's index on the installed mesh's ``model`` axis (0 where
    ``tp_size()`` is 1)."""
    return _MESH.get_local_rank("model") if tp_size() > 1 else 0


def _tp_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM, key: str = "tp_all_reduce"
                ) -> torch.Tensor:
    """Reduce ``x`` in place over the ``model`` group (``op``), counted
    under ``key``; returns ``x``."""
    dist.all_reduce(x, op=op, group=_MESH.get_group("model"))
    comm_counts[key] += 1
    comm_counts[f"{key}_bytes"] += x.numel() * x.element_size()
    return x


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduceG(torch.autograd.Function):
    """Megatron's g: the sum over ``model`` forward, the identity backward
    (what follows is replicated, so its gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, x):
        return _tp_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyF(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over ``model`` of the
    gradient backward (each rank's rank-local work gives a part of it);
    counted under ``tp_copy_bwd``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_reduce_(g.clone(memory_format=torch.contiguous_format), key="tp_copy_bwd")


class _AllGatherTP(torch.autograd.Function):
    """The ``model`` group's blocks concatenated along ``dim``; the backward
    takes this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim % x.dim(), x.shape[dim]
        return all_gather(x, dim, _MESH.get_group("model"), key="tp_all_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, tp_rank() * ctx.size, ctx.size), None


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ``model`` group of the installed mesh (the end of a
    product whose contracting dim is on ``model``), in its own type. In
    place where autograd does not record it (serving); under autograd
    Megatron's g (``_AllReduceG``: a new tensor, the identity backward).
    The identity on a ``model`` axis of 1."""
    if tp_size() == 1:
        return x
    return _AllReduceG.apply(x) if _recorded(x) else _tp_reduce_(x)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f on a replicated activation (or leaf) that rank-local
    work consumes: ``x`` forward, its gradient summed over ``model``
    backward. ``x`` itself where autograd does not record it or on a
    ``model`` axis of 1."""
    if tp_size() == 1 or not _recorded(x):
        return x
    return _CopyF.apply(x)


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` group's blocks of ``x`` concatenated along ``dim`` in
    rank order (logits along the vocab, q along the heads); ``x`` itself on
    a ``model`` axis of 1. Under autograd the backward keeps this rank's
    block of the gradient."""
    if tp_size() == 1:
        return x
    if _recorded(x):
        return _AllGatherTP.apply(x, dim)
    return all_gather(x, dim, _MESH.get_group("model"), key="tp_all_gather")


def gather_axes(sh: Optional[Sharding]) -> tuple[str, ...]:
    """The mesh axes that a leaf's gather at its use runs over, and its
    gradient's reduce-scatter: ``data`` where the leaf holds a ``data``
    shard (at every axis size), and under ``fsdp`` ``model`` too where it
    holds a ``model`` block on an axis above 1 (the layer runs on whole
    weights there)."""
    if sh is None:
        return ()
    axes = ("data",) if sh.dim is not None else ()
    if _STYLE == "fsdp" and sh.tp_dim is not None and model_axis(sh.mesh) > 1:
        axes += ("model",)
    return axes


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group over the product of ``axes`` (row-major: group
    rank = the rank's linear index over ``axes``); one mesh axis's own
    group, else one made once per mesh with ``dist.new_group`` (every rank
    makes every slice's group, in the same order)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    made = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in made:
        with _disable_current_modes():  # host bookkeeping, also under a fake tensor mode
            names = list(mesh.mesh_dim_names)
            idx = [names.index(a) for a in axes]
            ranks = mesh.mesh.movedim(idx, list(range(-len(idx), 0)))
            for row in ranks.reshape(-1, math.prod(ranks.shape[-len(idx):])).tolist():
                group = dist.new_group(row)
                if dist.get_rank() in row:
                    if row != sorted(row):  # a group ranks its members in rank order
                        raise ValueError(f"the ranks {row} of the axes {axes} are not in rank "
                                         f"order")
                    made[axes] = group
    return made[axes]


def axes_index(axes: tuple[str, ...]) -> int:
    """This rank's row-major linear index over ``axes`` of the installed
    mesh (its rank in ``axes_group``; 0 without a mesh or axes)."""
    return _coord(_MESH, axes)[0] if _MESH is not None and axes else 0


def slot_all_gather(x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """The blocks of ``x`` of every rank over the mesh axes ``axes`` (a
    decode cache's slot split), concatenated along dim 0 in their linear
    order: ``tp_all_gather`` where the axes are ``model`` alone, else one
    all-gather over ``axes_group``, counted as ``slot_all_gather``."""
    if tuple(axes) == ("model",):
        return tp_all_gather(x, 0)
    return all_gather(x, 0, axes_group(_MESH, tuple(axes)), key="slot_all_gather")


def _join(x: torch.Tensor, d: int, segs=()) -> torch.Tensor:
    """Blocks stacked on a leading rank axis, (n, *block), as one array
    along the block's dim ``d`` in rank order; part by part where ``segs``
    ((global, local, blocked) of each part of dim ``d``) is given, a part
    that is not blocked taken from rank 0."""
    if not segs:
        y = x.movedim(0, d)
        return y.reshape(*y.shape[:d], y.shape[d] * y.shape[d + 1], *y.shape[d + 2:])
    pieces, at = [], 0
    for _, local, blocked in segs:
        part = x.narrow(d + 1, at, local)
        pieces.append(_join(part, d) if blocked else part[0])
        at += local
    return torch.cat(pieces, d)


def _split(g: torch.Tensor, d: int, n: int, segs=()) -> torch.Tensor:
    """The inverse of ``_join``: each of ``n`` ranks' blocks of ``g`` along
    dim ``d``, stacked on a leading rank axis; a part that is not blocked
    goes whole to rank 0's block, and zeros to the others'."""
    if not segs:
        return g.reshape(*g.shape[:d], n, g.shape[d] // n, *g.shape[d + 1:]).movedim(d, 0)
    pieces, at = [], 0
    for size, _, blocked in segs:
        part = g.narrow(d, at, size)
        pieces.append(_split(part, d, n) if blocked else
                      torch.cat([part[None], part.new_zeros((n - 1, *part.shape))]))
        at += size
    return torch.cat(pieces, d + 1)


@dataclasses.dataclass(frozen=True)
class _Blocks:
    """Where one leaf's blocks sit in its global array over a gather's
    axes: the block's shape, the block dim of each axis (in the group's
    row-major order, ``model`` last), each axis's size, and the parts of
    the ``model`` dim (``Sharding.segments``; () for one part)."""

    shape: tuple[int, ...]
    dims: tuple[int, ...]
    sizes: tuple[int, ...]
    segs: tuple = ()

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def _segs(self, i: int):
        return self.segs if i == len(self.sizes) - 1 else ()

    def assemble(self, flat: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's flat block, (ranks, numel) in
        group order."""
        x = flat.reshape(*self.sizes, *self.shape)
        for i in reversed(range(len(self.sizes))):
            x = _join(x.movedim(i, 0), i + self.dims[i], self._segs(i))
        return x

    def blocks_of(self, g: torch.Tensor) -> torch.Tensor:
        """The inverse of ``assemble``: (ranks, numel) of ``g``'s blocks in
        group order (a part every ``model`` rank holds whole in the first
        ``model`` rank's block only)."""
        x = g
        for i in range(len(self.sizes)):
            x = _split(x, i + self.dims[i], self.sizes[i], self._segs(i)).movedim(0, i)
        return x.reshape(math.prod(self.sizes), -1)

    def whole(self) -> list[tuple[int, int]]:
        """(start, stop) on the block's ``model`` dim of the parts that
        every ``model`` rank holds whole."""
        out, at = [], 0
        for _, local, blocked in self.segs:
            if not blocked:
                out.append((at, at + local))
            at += local
        return out


def _blocks(sh: Sharding, shape, axes: tuple[str, ...]) -> _Blocks:
    sizes = axis_sizes(sh.mesh)
    segs = ()
    if "model" in axes and sh.parts != 1:
        segs = tuple(sh.segments(sizes["model"]))
    return _Blocks(tuple(shape), tuple(sh.dim if a == "data" else sh.tp_dim for a in axes),
                   tuple(sizes[a] for a in axes), segs)


class _GatherFSDP(torch.autograd.Function):
    """Several blocks gathered whole with one collective over ``group``: the
    forward all-gathers their concatenation and assembles every leaf from
    it (``_Blocks``); the backward lays out each leaf's gradient as its
    ranks' blocks and reduce-scatters (SUM) them at once. One collective a
    layer each way, where one a leaf would cost each leaf a call's host
    time. The parts of a fused leaf that every ``model`` rank holds whole
    (Mamba-2's B and C columns, gathered over ``model`` under ``fsdp``)
    reach the first ``model`` rank's block alone and are then summed over
    ``model``, so every rank holds the same bits (one more all-reduce)."""

    @staticmethod
    def forward(ctx, group, mesh, layouts, *blocks):
        n = dist.get_world_size(group)
        ctx.group, ctx.mesh, ctx.layouts = group, mesh, layouts
        full = all_gather(torch.cat([b.reshape(-1) for b in blocks]), 0, group).view(n, -1)
        outs, off = [], 0
        for b, lay in zip(blocks, layouts):
            outs.append(lay.assemble(full[:, off:off + b.numel()]))
            off += b.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        parts = []
        for g, lay in zip(grads, ctx.layouts):
            if g is None:  # a leaf the forward did not use
                parts.append(like.new_zeros((math.prod(lay.sizes), lay.numel)))
            else:
                parts.append(lay.blocks_of(g))
        out = reduce_scatter(torch.cat(parts, dim=1).view(-1), 0, ctx.group)
        locals_, off = [], 0
        for lay in ctx.layouts:
            locals_.append(out[off:off + lay.numel].view(lay.shape))
            off += lay.numel
        whole = [(t, lay.dims[-1], lo, hi) for t, lay in zip(locals_, ctx.layouts)
                 for lo, hi in lay.whole()]
        if whole:
            flat = all_reduce_(torch.cat([t.narrow(d, lo, hi - lo).reshape(-1)
                                          for t, d, lo, hi in whole]),
                               [ctx.mesh.get_group("model")])
            at = 0
            for t, d, lo, hi in whole:
                part = t.narrow(d, lo, hi - lo)
                part.copy_(flat[at:at + part.numel()].view(part.shape))
                at += part.numel()
        return (None, None, None, *locals_)


def gather_params(params: dict[str, torch.Tensor],
                  shardings: Mapping[str, Optional[Sharding]]) -> dict[str, torch.Tensor]:
    """FSDP weight gather: ``params`` (one layer's leaves, already cast to
    the compute type, so that type goes over the wire, as the JAX package
    pins with its optimisation barrier) with every leaf gathered whole over
    its ``gather_axes`` (``data``; ``data`` and ``model`` under ``fsdp``),
    all the leaves of one set of axes in one all-gather over their product
    (``axes_group``). The backward reduce-scatters their compute-type
    gradients, the JAX step's ``bf16_comms`` reduction. Issued at every
    axis size, a world of 1 included; replicated leaves pass through."""
    by_axes: dict[tuple, list[str]] = {}
    for k in params:
        axes = gather_axes(shardings.get(k))
        if axes:
            by_axes.setdefault(axes, []).append(k)
    if not by_axes:
        return params
    out = dict(params)
    for axes, names in by_axes.items():
        dtypes = {params[k].dtype for k in names}
        if len(dtypes) != 1:
            raise ValueError(f"gather_params: the leaves {names} mix dtypes ({dtypes})")
        mesh = shardings[names[0]].mesh
        layouts = tuple(_blocks(shardings[k], params[k].shape, axes) for k in names)
        gathered = _GatherFSDP.apply(axes_group(mesh, axes), mesh, layouts,
                                     *(params[k] for k in names))
        out.update(zip(names, gathered))
    return out


def gather_fsdp(w: torch.Tensor, sharding: Optional[Sharding]) -> torch.Tensor:
    """``gather_params`` of one leaf (the JAX package's name)."""
    return gather_params({"w": w}, {"w": sharding})["w"]


class _LookupRows(torch.autograd.Function):
    """``table[idx]`` in ``dtype`` from this rank's block of the table
    (gathered in ``dtype`` over ``group`` first where it is set, as
    ``layout`` places the blocks), zero rows for the indices outside the
    table (a vocab block on ``model``): the backward accumulates the rows'
    gradient in float32 (as the unsharded lookup's backward does) and
    reduce-scatters it in float32 over ``group``."""

    @staticmethod
    def forward(ctx, w, idx, layout, group, dtype):
        w = w.to(dtype)
        full = w if group is None else layout.assemble(
            all_gather(w.reshape(-1), 0, group).view(dist.get_world_size(group), -1))
        n = full.shape[0]
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        rows = full[idx]
        ctx.save_for_backward(idx, inside)
        ctx.layout, ctx.group, ctx.shape = layout, group, full.shape
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], g.float(), 0.0)
        full = g.new_zeros(ctx.shape, dtype=torch.float32).index_put_((idx,), g,
                                                                       accumulate=True)
        if ctx.group is not None:
            full = reduce_scatter(ctx.layout.blocks_of(full).reshape(-1), 0,
                                  ctx.group).view(ctx.layout.shape)
        return full, None, None, None, None


def _lookup(table: torch.Tensor, idx: torch.Tensor, sh: Sharding, axes: tuple[str, ...],
            dtype: torch.dtype) -> torch.Tensor:
    if not axes:
        return _LookupRows.apply(table, idx, None, None, dtype)
    return _LookupRows.apply(table, idx, _blocks(sh, table.shape, axes),
                             axes_group(sh.mesh, axes), dtype)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``; a table sharded on
    ``data`` (under ``fsdp`` on ``model`` too) is gathered whole (in
    ``dtype``) first. Under tensor parallelism a table whose vocab is on
    ``model`` looks up the tokens of its block (zero rows elsewhere) and
    sums them over ``model`` (g: its gradient lands in the block's rows):
    one term of the sum is not zero, so the rows are the unsharded
    lookup's, bit for bit."""
    sh = sharding_of(table)
    if sh is not None and sh.tp_dim == 0 and tp_size() > 1:
        return tp_all_reduce(_lookup(table, tokens.long() - sh.offset(0), sh,
                                     gather_axes(sh), dtype))
    axes = gather_axes(sh)
    if not axes:
        rows = table[tokens.long()]
        return rows if rows.dtype == dtype else rows.to(dtype)
    return _lookup(table, tokens.long(), sh, axes, dtype)


# ---------------------------------------------------------------------------
# Sequence-sharded layer carries (tp_sp)
# ---------------------------------------------------------------------------

def seq_parallel(n_positions: int) -> bool:
    """Whether layer carries of ``n_positions`` positions are sequence-
    sharded: the ``tp_sp`` style on a ``model`` axis above 1 that divides
    them (elsewhere the carry stays whole: GSPMD pads an uneven block, and
    the value is the same; a decode's one position is ``tp``'s decode)."""
    m = tp_size()
    return _STYLE == "tp_sp" and m > 1 and n_positions % m == 0


class _SeqGather(torch.autograd.Function):
    """Every ``model`` rank's block of positions concatenated along dim 1;
    the backward keeps this rank's block of the gradient (the layer that
    consumed the gathered carry ran in ``tp``'s layout, whose f / g pair
    leaves a replicated activation's gradient whole on every rank)."""

    @staticmethod
    def forward(ctx, x):
        ctx.size = x.shape[1]
        return all_gather(x, 1, _MESH.get_group("model"), key="seq_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, tp_rank() * ctx.size, ctx.size)


class _SeqSplit(torch.autograd.Function):
    """This rank's block of positions (dim 1) of a carry every ``model``
    rank holds whole, in a tensor of its own (a remat region saves it, not
    the whole carry); the backward all-gathers the gradient, counted under
    ``seq_split_bwd``."""

    @staticmethod
    def forward(ctx, x):
        return _seq_block(x)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 1, _MESH.get_group("model"), key="seq_split_bwd")


def _seq_block(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[1] // tp_size()
    return x.narrow(1, tp_rank() * n, n).clone(memory_format=torch.contiguous_format)


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole carry from each ``model`` rank's block of positions (one
    all-gather, counted under ``seq_gather``)."""
    if _recorded(x):
        return _SeqGather.apply(x)
    return all_gather(x, 1, _MESH.get_group("model"), key="seq_gather")


def seq_split(x: torch.Tensor) -> torch.Tensor:
    """This ``model`` rank's block of positions of a whole carry (no
    collective forward; the gradient all-gathered backward)."""
    return _SeqSplit.apply(x) if _recorded(x) else _seq_block(x)


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, named tuples, lists and
    tuples; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
