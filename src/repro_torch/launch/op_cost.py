"""Op-level cost counter of one step, per rank; the port's counterpart of
``repro.launch.hlo_cost``.

The JAX package walks the post-SPMD HLO text of a compiled step. The port
has no HLO: ``OpCost`` is a ``TorchDispatchMode`` that sees every ATen op
and every c10d collective a rank's step runs (forward, backward and
optimizer alike, on real or fake tensors) and accumulates:

  * ``flops``             from ``torch.utils.flop_counter``'s registry (2MNK
                          a matmul, the convolutions and attention ops it
                          knows);
  * ``bytes_written``     result bytes of every op that makes new storage,
                          and the result of every op that writes its input
                          in place (views, metadata and allocation alone
                          count nothing): the role of ``hlo_cost``'s
                          top-level results;
  * ``dot_operand_bytes`` the input bytes of ``mm``, ``bmm``, ``addmm`` and
                          ``baddbmm``;
  * ``memory_traffic``    2 x bytes_written + dot_operand_bytes, the same
                          proxy as ``hlo_cost.HloCost.memory_traffic``;
  * ``collective_bytes``  wire bytes a rank by kind, by ``hlo_cost``'s ring
                          formulas with ``n`` the size of the group the
                          collective ran on: all-reduce 2 (n-1)/n x payload,
                          all-gather (n-1)/n x result, reduce-scatter
                          (n-1)/n x input, all-to-all (n-1)/n x result;
  * ``peak_bytes``        the peak of live storage bytes: the arguments
                          registered with ``track`` plus every storage an
                          op made, each freed when the last tensor on it
                          dies (weak references).

All values are per rank.
"""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
DOT_OPS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# Allocation without a write, and the lift of a constant made outside the
# step (``torch.tensor(x)``; a fake tensor mode copies it to a fake one).
_NO_WRITE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
             _aten.new_empty_strided, _aten.lift_fresh, _aten.lift_fresh_copy}
# c10d op name -> (kind, where the payload is: "in" the inputs, "out" the result)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", "in"), "allreduce_coalesced_": ("all-reduce", "in"),
    "_allgather_base_": ("all-gather", "out"), "allgather_": ("all-gather", "out"),
    "allgather_into_tensor_coalesced_": ("all-gather", "out"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"), "reduce_scatter_": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "in"),
    "alltoall_base_": ("all-to-all", "out"), "alltoall_": ("all-to-all", "out"),
    "broadcast_": ("broadcast", "in"),
}


def tensors(tree) -> list[torch.Tensor]:
    """The tensors among the leaves of ``tree`` (a module's parameters and
    buffers)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
            out.extend(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> dict[int, int]:
    """Storage -> bytes of the storages under the tensors of ``tree``."""
    return {_storage(t): t.untyped_storage().nbytes() for t in tensors(tree)}


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:  # another script object (a ReduceOp)
                continue
    return 1


def wire_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes a rank sends for one collective of ``kind`` over ``n`` ranks
    (ring algorithms; ``payload`` as ``_COLLECTIVES`` locates it)."""
    frac = (n - 1) / max(n, 1)
    return 2.0 * frac * payload if kind == "all-reduce" else frac * payload


class OpCost(TorchDispatchMode):
    """Counts the ops run inside the block (see the module doc). Enter
    it inside a ``FakeTensorMode`` to count a step that allocates nothing;
    call ``track`` on the step's arguments first so that the peak holds
    them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_written = 0.0
        self.dot_operand_bytes = 0.0
        self.collective_bytes: dict[str, float] = defaultdict(float)
        self.collective_calls: Counter = Counter()
        self.calls_by_group: Counter = Counter()  # "kind x n" -> calls over n ranks
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: dict[int, int] = {}  # storage -> live tensors on it
        self._sizes: dict[int, int] = {}  # storage -> bytes

    @property
    def memory_traffic(self) -> float:
        return 2.0 * self.bytes_written + self.dot_operand_bytes

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def track(self, tree) -> None:
        """Hold every tensor of ``tree`` live from now on (a step's arguments:
        weights, moments, the batch or the cache)."""
        for t in tensors(tree):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage(t)
        if key in self._refs:
            self._refs[key] += 1
        else:
            self._refs[key] = 1
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live_bytes += self._sizes[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":  # metadata (a fake tensor's device query)
            return out
        self.ops += 1
        inputs = tensors((args, kwargs))
        outputs = tensors(out)
        packet = func._overloadpacket
        if func.namespace == "c10d":
            self._collective(packet.__name__, args)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in DOT_OPS:
            self.dot_operand_bytes += sum(_nbytes(t) for t in inputs)
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        in_storages = {_storage(t) for t in inputs}
        for t in outputs:
            if _storage(t) not in in_storages:  # new storage
                if packet not in _NO_WRITE:
                    self.bytes_written += _nbytes(t)
            elif mutates:  # written in place
                self.bytes_written += _nbytes(t)
            self._hold(t)
        return out

    def _collective(self, name: str, args) -> None:
        kind, where = _COLLECTIVES.get(name, (name.strip("_"), "in"))
        n = _group_size(args)
        if where == "out":  # the output buffers are the first argument
            payload = sum(_nbytes(t) for t in tensors(args[0]))
        else:
            payload = sum(_nbytes(t) for t in tensors(args[1] if name.startswith(
                ("_reduce_scatter", "reduce_scatter")) else args[0]))
        self.collective_calls[kind] += 1
        self.calls_by_group[f"{kind} x{n}"] += 1
        self.collective_bytes[kind] += wire_bytes(kind, payload, n)

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes_written": self.bytes_written,
                "dot_operand_bytes": self.dot_operand_bytes,
                "memory_traffic": self.memory_traffic,
                "collective_bytes": dict(self.collective_bytes),
                "collective_calls": dict(self.collective_calls),
                "calls_by_group": dict(self.calls_by_group), "ops": self.ops,
                "peak_bytes": self.peak_bytes}


__all__ = ["DOT_OPS", "OpCost", "storage_bytes", "tensors", "wire_bytes"]
