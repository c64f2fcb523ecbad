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

Execution covers meshes whose ``model`` axis has size 1, in every style,
and serving on a larger ``model`` axis in the ``serve`` and ``tp`` styles
for the dense, MoE, Mamba-1 and VLM families: each rank keeps its block of
every leaf on both axes (``Sharding``), a product whose contracting dim is
on ``model`` ends in one ``tp_all_reduce``, and logits are gathered along
the vocab (``tp_all_gather``). Training on such a mesh, the hybrid and
encoder-decoder families on it, and the ``fsdp`` / ``tp_sp`` styles on it
raise (ROADMAP.md, Queue 1 item 6).
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

_MESH: Any = None
# Parallelism style (the JAX package's):
#   "tp"    batch on (pod, data); TP on model; ZeRO over data
#   "tp_sp" as tp for the weights; sequence-sharded remat carries
#   "fsdp"  batch over every axis; weights gathered whole per layer (ZeRO-3)
#   "serve" weights TP-sharded on model and replicated over data
_STYLE: str = "tp"

TP_PENDING = ("tensor-parallel training (a train step on a model axis above 1: the "
              "f / g autograd pair, vocab-parallel cross-entropy) is not ported "
              "(ROADMAP.md, Queue 1 item 6)")
# Families and styles that execute on a model axis above 1 (serving).
TP_FAMILIES = ("dense", "moe", "ssm", "vlm")
TP_STYLES = ("serve", "tp")

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


def _check_executable(mesh, params) -> None:
    """Raises where a ``model`` axis above 1 meets what it does not run yet:
    another family than ``TP_FAMILIES``, another style than ``TP_STYLES``."""
    if model_axis(mesh) == 1:
        return
    family = getattr(getattr(params, "cfg", None), "family", None)
    if family is not None and family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism for the {family} family is not ported (ROADMAP.md, "
            f"Queue 1 item 6); it runs on a model axis of 1")
    if _STYLE not in TP_STYLES:
        raise NotImplementedError(
            f"the {_STYLE} style on a model axis above 1 is not ported (ROADMAP.md, "
            f"Queue 1 item 6); serving takes {TP_STYLES}")


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
    ``parts``, the equal parts of its ``model`` dim that are blocked each on
    its own (2 for Mamba-1's fused ``in_proj`` ``[x | z]``: a rank holds
    ``[x_r | z_r]``, not block r of the concatenation, while the global
    array keeps the JAX package's layout)."""

    mesh: Any
    spec: tuple
    global_shape: tuple[int, ...]
    parts: int = 1

    @property
    def dim(self) -> Optional[int]:
        """The dim that holds the ``data`` shard (``None``: replicated)."""
        return self.spec.index("data") if "data" in self.spec else None

    @property
    def tp_dim(self) -> Optional[int]:
        """The dim that holds the ``model`` block (``None``: whole)."""
        return self.spec.index("model") if "model" in self.spec else None

    @property
    def group(self):
        return self.mesh.get_group("data")

    @property
    def tp_group(self):
        return self.mesh.get_group("model")

    def _axes(self):
        return ((self.dim, "data", 1), (self.tp_dim, "model", self.parts))

    def offset(self, dim: int) -> int:
        """Where this rank's block starts along ``dim`` of the global array
        (a dim of one part)."""
        for d, axis, parts in self._axes():
            if d == dim:
                if parts != 1:
                    raise ValueError(f"dim {dim} holds {parts} parts blocked each on its own")
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
        for dim, axis, parts in self._axes():
            if dim is None:
                continue
            r, n = _coord(self.mesh, (axis,))
            part = full.shape[dim] // parts
            size = part // n
            pieces = []
            for j in range(parts):
                index = [slice(None)] * len(full.shape)
                index[dim] = slice(j * part + r * size, j * part + (r + 1) * size)
                pieces.append(out[tuple(index)])
            out = pieces[0] if parts == 1 else _cat(pieces, dim)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (collectives over the
        ``data`` and ``model`` axes; no autograd)."""
        out = local.detach()
        if self.dim is not None:
            out = all_gather(out, self.dim, self.group)
        if self.tp_dim is not None:
            d, n = self.tp_dim, dist.get_world_size(self.tp_group)
            out = all_gather(out, d, self.tp_group)  # [part 0 | part 1 ...] of each rank
            if self.parts > 1:
                moved = out.movedim(d, -1)
                s = moved.shape[-1] // (n * self.parts)
                moved = moved.reshape(*moved.shape[:-1], n, self.parts, s).transpose(-3, -2)
                out = moved.reshape(*moved.shape[:-3], -1).movedim(-1, d).contiguous()
        return out

    def per_layer(self) -> "Sharding":
        """The placement of one layer's view of a stacked leaf."""
        return Sharding(self.mesh, self.spec[1:], self.global_shape[1:], self.parts)


def sharding_of(t) -> Optional[Sharding]:
    return getattr(t, "_sharding", None)


def param_shardings(params) -> dict[str, Optional[Sharding]]:
    return {k: sharding_of(p) for k, p in _named(params).items()}


def _fused(params) -> dict[str, int]:
    """name -> parts of the model's fused leaves (``tp_fused``)."""
    return dict(getattr(params, "tp_fused", {}))


def _placement(name: str, p: torch.Tensor, mesh, parts: dict) -> Sharding:
    return Sharding(mesh, param_pspec(name, tuple(p.shape), mesh), tuple(p.shape),
                    parts.get(name, 1))


@torch.no_grad()
def shard_params(params, mesh):
    """Keep each rank's block of every parameter of ``params`` (a module,
    whose parameters are replaced in place, or a name -> tensor mapping,
    for which a new dict is returned) under the rule table, and record each
    leaf's ``Sharding`` on it. On a ``model`` axis above 1 only what
    serving runs is accepted (``_check_executable``)."""
    _check_executable(mesh, params)
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
    _check_executable(mesh, module)
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
    """The ``model`` axis size of the installed mesh (1 without one)."""
    return model_axis(_MESH) if _MESH is not None else 1


def tp_rank() -> int:
    """This rank's index on the installed mesh's ``model`` axis."""
    return _MESH.get_local_rank("model") if tp_size() > 1 else 0


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` in place over the ``model`` group of the installed mesh
    (the end of a product whose contracting dim is on ``model``), in its own
    type; returns ``x``. The identity on a ``model`` axis of 1. A forward
    collective (serving): no autograd."""
    if tp_size() == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_MESH.get_group("model"))
    comm_counts["tp_all_reduce"] += 1
    comm_counts["tp_all_reduce_bytes"] += x.numel() * x.element_size()
    return x


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` group's blocks of ``x`` concatenated along ``dim`` in
    rank order (logits along the vocab, q along the heads); ``x`` itself on
    a ``model`` axis of 1. No autograd."""
    if tp_size() == 1:
        return x
    return all_gather(x, dim, _MESH.get_group("model"), key="tp_all_gather")


def _global_shape(shape: torch.Size, dim: int, n: int) -> tuple[int, ...]:
    return (*shape[:dim], n * shape[dim], *shape[dim + 1:])


class _GatherFSDP(torch.autograd.Function):
    """Several blocks gathered whole with one collective: the forward
    all-gathers their concatenation and cuts every leaf out of it (along
    its own sharded dim); the backward concatenates the leaves' gradients,
    each laid out as its ranks' blocks, and reduce-scatters (SUM) them at
    once. One collective a layer each way, where one a leaf would cost each
    leaf a call's host time."""

    @staticmethod
    def forward(ctx, group, dims, *blocks):
        n = dist.get_world_size(group)
        ctx.group, ctx.dims, ctx.shapes = group, dims, [b.shape for b in blocks]
        full = all_gather(torch.cat([b.reshape(-1) for b in blocks]), 0, group).view(n, -1)
        outs, off = [], 0
        for b, d in zip(blocks, dims):
            ranks = full[:, off:off + b.numel()].reshape(n, *b.shape)
            outs.append(ranks.movedim(0, d).reshape(_global_shape(b.shape, d, n)))
            off += b.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = dist.get_world_size(ctx.group)
        parts = []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            full = _global_shape(shape, d, n)
            if g is None:  # a leaf the forward did not use
                g = torch.zeros(full, dtype=grads[0].dtype, device=grads[0].device)
            ranks = g.reshape(*shape[:d], n, shape[d], *shape[d + 1:]).movedim(d, 0)
            parts.append(ranks.reshape(n, -1))
        out = reduce_scatter(torch.cat(parts, dim=1).view(-1), 0, ctx.group)
        locals_, off = [], 0
        for shape in ctx.shapes:
            locals_.append(out[off:off + shape.numel()].view(shape))
            off += shape.numel()
        return (None, None, *locals_)


def gather_params(params: dict[str, torch.Tensor],
                  shardings: Mapping[str, Optional[Sharding]]) -> dict[str, torch.Tensor]:
    """FSDP weight gather: ``params`` (one layer's leaves, already cast to
    the compute type, so that type goes over the wire, as the JAX package
    pins with its optimisation barrier) with every leaf that ``shardings``
    places on ``data`` gathered whole, all of them in one all-gather. The
    backward reduce-scatters their compute-type gradients, the JAX step's
    ``bf16_comms`` reduction. Issued at every axis size, a world of 1
    included; replicated leaves pass through."""
    names = [k for k in params if (sh := shardings.get(k)) is not None and sh.dim is not None]
    if not names:
        return params
    groups = {shardings[k].group for k in names}
    dtypes = {params[k].dtype for k in names}
    if len(groups) != 1 or len(dtypes) != 1:
        raise ValueError(f"gather_params: the leaves {names} mix process groups or dtypes "
                         f"({dtypes})")
    gathered = _GatherFSDP.apply(groups.pop(), tuple(shardings[k].dim for k in names),
                                 *(params[k] for k in names))
    return {**params, **dict(zip(names, gathered))}


def gather_fsdp(w: torch.Tensor, sharding: Optional[Sharding]) -> torch.Tensor:
    """``gather_params`` of one leaf (the JAX package's name)."""
    return gather_params({"w": w}, {"w": sharding})["w"]


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` in ``dtype`` from this rank's block of the table: the
    forward gathers the cast table; the backward accumulates the rows'
    gradient in float32 (as the unsharded lookup's backward does) and
    reduce-scatters it in float32."""

    @staticmethod
    def forward(ctx, w, idx, dim, group, dtype):
        full = all_gather(w.to(dtype), dim, group)
        ctx.save_for_backward(idx)
        ctx.dim, ctx.group, ctx.shape = dim, group, full.shape
        return full[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape, dtype=torch.float32).index_put_(
            (idx,), g.float(), accumulate=True)
        return reduce_scatter(full, ctx.dim, ctx.group), None, None, None, None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``; a table sharded on
    ``data`` is gathered (in ``dtype``) first. A table whose vocab is on
    ``model`` looks up the tokens of its block (zero rows elsewhere) and sums
    them over ``model``: one term of the sum is not zero, so the rows are
    the unsharded lookup's, bit for bit."""
    sh = sharding_of(table)
    if sh is not None and sh.tp_dim == 0 and tp_size() > 1:
        w = table.to(dtype) if sh.dim is None else all_gather(table.to(dtype), sh.dim, sh.group)
        idx = tokens.long() - sh.offset(0)
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = w[idx.clamp(0, w.shape[0] - 1)]
        return tp_all_reduce(torch.where(inside[..., None], rows, torch.zeros_like(rows)))
    if sh is None or sh.dim is None:
        rows = table[tokens.long()]
        return rows if rows.dtype == dtype else rows.to(dtype)
    return _GatherRows.apply(table, tokens.long(), sh.dim, sh.group, dtype)


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
