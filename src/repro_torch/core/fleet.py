"""Fleet engine: K network slices scheduled together on one device, or
sharded over the ranks of a mesh.
Counterpart of ``repro.core.fleet``.

An operator runs many incremental-learning jobs at once, one slice per
region or tenant. All per-slice numbers live in ``SliceParams``, so a fleet
is that container with a leading K axis, and one slot of the whole fleet is
one pass of ``datasche.stacked_step`` over it: every tensor op runs on all K
slices at once, and each matcher kernel is launched once for all the slices
that run it. ``run`` is a Python loop over the slots, as the single-slice
``run`` is.

Axis conventions (as in the JAX package):
  * stacked ``SliceParams`` / ``SchedulerState``: leading axis = slice (K);
  * records returned by :meth:`FleetEngine.run`: time-major (T, K).

All slices of a fleet run at one ``ShapeConfig``; ``exact`` specs run on
the host one slice at a time and cannot join one. Through
:meth:`FleetEngine.from_jobs`:

  * slices with different true (N, M) are zero-padded to the elementwise
    maximum, and the ``SliceParams`` entity masks make every policy ignore
    the padding: a padded slice reproduces its own run on the real block;
  * slices with different ``AlgoSpec`` run under ``SWITCHED`` dispatch:
    the slices are grouped by the policy ids the engine keeps on the host,
    and each group runs its policies once (``datasche._by_group``).

``from_configs`` / ``from_ragged_configs`` are thin shims over
``from_jobs``. ``run(mesh=)`` shards the K slices over the ranks of a mesh
axis (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..parallel.sharding import all_gather, axis_sizes
from .datasche import (COLLECTION_POLICIES, DS, SWITCHED, SWITCHED_NOAID,
                       TRAINING_POLICIES, AlgoSpec, PolicyPlan, SlotRecord,
                       policy_plan, stacked_run, stacked_step)
from .job import JobLike, SliceJob, as_jobs
from .types import (CocktailConfig, Decision, DeviceLike, Heterogeneity,
                    Multipliers, NetworkState, QueueState, SchedulerState,
                    ShapeConfig, SliceParams, init_state, resolve_device,
                    stack_slice_params, stack_trees, tree_map, unstack)

def _gather_slices(leaf: Optional[torch.Tensor], dim: int, group):
    """Every rank's block of slices, concatenated along ``dim`` in rank
    order."""
    if leaf is None:
        return None
    return all_gather(leaf, dim, group)


def slice_records(recs: SlotRecord, k: int) -> SlotRecord:
    """Slice k's (T,) per-slot trace out of time-major (T, K) fleet records."""
    return tree_map(lambda leaf: leaf[:, k], recs)


def ragged_pad_shape(shapes: Sequence[ShapeConfig]) -> ShapeConfig:
    """The common shape of a ragged fleet: the elementwise maximum over the
    entity axes. Solver iteration counts are control flow, not padding, so
    they must agree across slices."""
    iters = {s.pair_iters for s in shapes}
    if len(iters) != 1:
        raise ValueError(f"ragged fleet slices must share pair_iters, got {iters}")
    return ShapeConfig(n_cu=max(s.n_cu for s in shapes),
                       n_ec=max(s.n_ec for s in shapes),
                       pair_iters=iters.pop())


def trim_state(state: SchedulerState, shape: ShapeConfig) -> SchedulerState:
    """Drop the ragged padding of one slice's state: slice every entity axis
    down to the true (N, M). Padded entries are exactly zero by the mask
    invariants, and the heterogeneity's true block is the unpadded slice's,
    so the trimmed state is the one the slice reaches unpadded."""
    n, m = shape.n_cu, shape.n_ec

    def trim_mults(mu: Multipliers) -> Multipliers:
        return Multipliers(mu=mu.mu[:n], eta=mu.eta[:n, :m],
                           phi=mu.phi[:n, :m], lam=mu.lam[:n, :m])

    het = state.het
    return state._replace(
        queues=QueueState(q=state.queues.q[:n], r=state.queues.r[:n, :m],
                          omega=state.queues.omega[:n, :m]),
        mults=trim_mults(state.mults),
        emp_mults=trim_mults(state.emp_mults),
        uploaded=state.uploaded[:n],
        het=Heterogeneity(link_het=het.link_het[:n, :m], ec_het=het.ec_het[:m, :m],
                          phase_d=het.phase_d[:n, :m], phase_D=het.phase_D[:m, :m]),
    )


def _stacked_slice_count(params: SliceParams) -> int:
    """K of a stacked (K, ...) params container, validating that every set
    leaf agrees on the leading (slice) axis. Raises naming the offending
    leaf instead of silently mis-reading unstacked params."""
    k: Optional[int] = None
    first = None
    for name, leaf in zip(SliceParams._fields, params):
        if leaf is None:
            continue
        if leaf.dim() == 0:
            raise ValueError(
                f"SliceParams leaf {name!r} is rank-0: params look unstacked "
                "(no leading slice axis); stack K slices with "
                "stack_slice_params first")
        n = leaf.shape[0]
        if k is None:
            k, first = int(n), name
        elif n != k:
            raise ValueError(
                f"inconsistent leading (slice) axis across SliceParams leaves: "
                f"{first!r} has K={k} but {name!r} has K={n}")
    if k is None:
        raise ValueError("SliceParams has no tensor leaves (every field is "
                         "None); build it with SliceParams.from_config / "
                         "stack_slice_params")
    return k


@dataclasses.dataclass(frozen=True)
class FleetEngine:
    """K-slice batch scheduler: ``datasche.stacked_step`` over a leading K
    axis, once per slot.

    Build with :meth:`from_jobs` (homogeneous, ragged-shape and mixed-policy
    fleets alike), or adopt a stacked ``SliceParams`` with
    :meth:`from_params`. The fleet lives on the device of its params.
    """

    shape: ShapeConfig
    spec: AlgoSpec
    params: SliceParams  # stacked, leading axis K
    n_slices: int
    seeds: tuple[int, ...]
    # Per-slice true shapes (== (shape,) * K for non-ragged fleets): used
    # by slice_state to trim the padding back off.
    slice_shapes: Optional[tuple[ShapeConfig, ...]] = None
    # Per-slice AlgoSpec (metadata; the fleet runs self.spec, which is
    # SWITCHED or SWITCHED_NOAID for mixed-policy fleets).
    slice_specs: Optional[tuple[AlgoSpec, ...]] = None
    # The per-slice policy ids of a switched fleet, fixed when it is built
    # and kept on the host, so that no slot reads a device tensor to
    # dispatch.
    plan: Optional[PolicyPlan] = None

    def __post_init__(self):
        if self.spec.exact:
            raise ValueError("exact (host-side oracle) specs cannot join a fleet; "
                             "use datasche.run per slice instead")

    @property
    def device(self):
        return self.params.device

    @classmethod
    def from_jobs(cls, jobs: Sequence[JobLike], spec: AlgoSpec = DS,
                  device: DeviceLike = None) -> "FleetEngine":
        """The fleet constructor: one ``SliceJob`` per slice, on ``device``
        (CUDA unless the caller names another).

        Numeric params differ freely; mixed true (N, M) are padded to the
        elementwise-max shape with entity masks; mixed policies run under
        ``SWITCHED`` (``SWITCHED_NOAID`` when no slice runs L-DS). Bare
        ``CocktailConfig`` entries are accepted and get ``spec``.
        """
        jobs = as_jobs(jobs, spec)
        if not jobs:
            raise ValueError("need at least one SliceJob")
        dev = resolve_device(device)
        pad = ragged_pad_shape([j.shape for j in jobs])
        policies = {(j.spec.collection, j.spec.training, j.spec.use_lsa,
                     j.spec.learning_aid) for j in jobs}
        # Distinct specs with one policy tuple (DS and GREEDY) stay static.
        # The policy leaves are filled either way, so the params state what
        # each slice runs.
        mixed = len(policies) > 1
        plan = None
        fleet_spec = jobs[0].spec
        if mixed:
            fleet_spec = SWITCHED if any(j.spec.learning_aid for j in jobs) else SWITCHED_NOAID
            plan = PolicyPlan(
                collect=tuple(COLLECTION_POLICIES.index(j.spec.collection) for j in jobs),
                train=tuple(TRAINING_POLICIES.index(j.spec.training) for j in jobs),
                aid=tuple(j.spec.learning_aid for j in jobs))
        return cls(
            shape=pad,
            spec=fleet_spec,
            params=stack_slice_params(
                [j.params(pad_shape=pad, policy_leaves=True, device=dev) for j in jobs]),
            n_slices=len(jobs),
            seeds=tuple(j.resolved_seed for j in jobs),
            slice_shapes=tuple(j.shape for j in jobs),
            slice_specs=tuple(j.spec for j in jobs),
            plan=plan,
        )

    @classmethod
    def from_configs(cls, configs: Sequence[CocktailConfig], spec: AlgoSpec = DS,
                     device: DeviceLike = None) -> "FleetEngine":
        """Shim over :meth:`from_jobs` that still rejects mixed shapes,
        which from_jobs would pad."""
        if not configs:
            raise ValueError("need at least one slice config")
        shapes = {c.shape for c in configs}
        if len(shapes) != 1:
            raise ValueError(f"fleet slices must share one ShapeConfig, got {shapes}; "
                             "pad mixed shapes with from_jobs/from_ragged_configs")
        return cls.from_jobs([SliceJob(config=c, spec=spec) for c in configs], device=device)

    @classmethod
    def from_ragged_configs(cls, configs: Sequence[CocktailConfig], spec: AlgoSpec = DS,
                            device: DeviceLike = None) -> "FleetEngine":
        """Shim over :meth:`from_jobs`: slices of different true (N, M),
        padded and masked."""
        return cls.from_jobs([SliceJob(config=c, spec=spec) for c in configs], device=device)

    @classmethod
    def from_params(cls, shape: ShapeConfig, params: SliceParams,
                    spec: AlgoSpec = DS,
                    seeds: Optional[Sequence[int]] = None) -> "FleetEngine":
        """Adopt an already-stacked (K, ...) ``SliceParams``; under a
        switched spec its policy leaves are read once, here."""
        k = _stacked_slice_count(params)
        seeds = tuple(seeds) if seeds is not None else tuple(range(k))
        if len(seeds) != k:
            raise ValueError(f"{k} slices but {len(seeds)} seeds")
        plan = policy_plan(params) if spec.switched else None
        return cls(shape=shape, spec=spec, params=params, n_slices=k, seeds=seeds, plan=plan)

    # -- state ------------------------------------------------------------

    def init(self) -> SchedulerState:
        """Stacked initial state: slice k from params[k] and seeds[k]."""
        return stack_trees([init_state(self.shape, unstack(self.params, k), seed=self.seeds[k])
                            for k in range(self.n_slices)])

    def slice_state(self, state: SchedulerState, k: int) -> SchedulerState:
        """Slice k's ``SchedulerState``; a ragged slice's padding is trimmed
        off, so the result has its true (N, M)."""
        sk = unstack(state, k)
        if self.slice_shapes is not None and self.slice_shapes[k] != self.shape:
            sk = trim_state(sk, self.slice_shapes[k])
        return sk

    # -- execution --------------------------------------------------------

    def step(self, state: SchedulerState, net: Optional[NetworkState] = None
             ) -> tuple[SchedulerState, SlotRecord, Decision]:
        """One fleet slot; ``net`` injects the K network states."""
        return stacked_step(self.shape, self.spec, state, self.params, net, self.plan)

    def run(self, n_slots: int, state: Optional[SchedulerState] = None,
            mesh=None, axis_name: str = "data"
            ) -> tuple[SchedulerState, SlotRecord]:
        """Run the whole fleet for ``n_slots``; returns (stacked final state
        (K, ...), records (T, K)).

        With ``mesh`` (a ``DeviceMesh`` of the fleet's device type), the K
        slices are sharded over ``mesh[axis_name]`` (K must divide by its
        size): each rank runs its contiguous block of K / n slices, with its
        own policy groups (one matcher launch a group a slot, per rank), and
        the final states and the records are all-gathered along K, so every
        rank returns the stacked (K, ...) result."""
        if state is None:
            state = self.init()
        if mesh is None:
            return stacked_run(self.shape, self.spec, n_slots, state, self.params, self.plan)
        from ..launch.mesh import shard_leading_axis
        n = axis_sizes(mesh)[axis_name]
        if self.n_slices % n:
            raise ValueError(f"{self.n_slices} slices do not divide over the {n} ranks of "
                             f"mesh axis {axis_name!r}")
        r, b = mesh.get_local_rank(axis_name), self.n_slices // n
        plan = None if self.plan is None else PolicyPlan(
            *(ids[r * b:(r + 1) * b] for ids in self.plan))
        state, recs = stacked_run(self.shape, self.spec, n_slots,
                                  shard_leading_axis(state, mesh, axis_name),
                                  shard_leading_axis(self.params, mesh, axis_name), plan)
        group = mesh.get_group(axis_name)
        return (tree_map(lambda leaf: _gather_slices(leaf, 0, group), state),
                tree_map(lambda leaf: _gather_slices(leaf, 1, group), recs))
