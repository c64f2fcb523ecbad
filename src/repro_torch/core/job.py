"""SliceJob: one slice of a fleet, described by what network, which
algorithm and which randomness. Counterpart of ``repro.core.job``.

``FleetEngine.from_jobs`` builds any fleet the scheduler supports from a
list of jobs: homogeneous (one shape, one spec), ragged (mixed true
(N, M), padded and masked), mixed-policy (a different ``AlgoSpec`` per
slice, dispatched per slice under ``SWITCHED``), or any mix of these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from .datasche import DS, AlgoSpec, with_policy
from .types import CocktailConfig, DeviceLike, ShapeConfig, SliceParams


@dataclasses.dataclass(frozen=True)
class SliceJob:
    """One fleet slice: network config + scheduling algorithm + seed.

    ``seed`` defaults to ``config.seed``; ``name`` is display-only metadata
    (per-slice reporting in the examples), never part of the computation.
    """

    config: CocktailConfig
    spec: AlgoSpec = DS
    seed: Optional[int] = None
    name: Optional[str] = None

    def __post_init__(self):
        if self.spec.switched:
            raise ValueError("a SliceJob carries a concrete AlgoSpec; "
                             "SWITCHED is an engine-internal dispatch mode")
        if self.spec.exact:
            raise ValueError(
                f"spec {self.spec.name!r} is exact (host-side oracles) and "
                "cannot join a fleet; use datasche.run per slice instead")

    @property
    def resolved_seed(self) -> int:
        return int(self.config.seed if self.seed is None else self.seed)

    @property
    def shape(self) -> ShapeConfig:
        return self.config.shape

    def params(self, pad_shape: Optional[ShapeConfig] = None,
               policy_leaves: bool = False, device: DeviceLike = None) -> SliceParams:
        """This job's ``SliceParams`` on ``device`` (CUDA unless named),
        optionally padded to ``pad_shape`` and with the policy leaves
        filled from the spec."""
        p = SliceParams.from_config(self.config, pad_shape=pad_shape, device=device)
        return with_policy(p, self.spec) if policy_leaves else p


JobLike = Union[SliceJob, CocktailConfig]


def as_jobs(jobs: Sequence[JobLike], spec: AlgoSpec = DS) -> list[SliceJob]:
    """Normalise a mixed list of ``SliceJob`` / bare ``CocktailConfig`` (the
    latter get ``spec``) into a list of jobs."""
    out = []
    for j in jobs:
        if isinstance(j, SliceJob):
            out.append(j)
        elif isinstance(j, CocktailConfig):
            out.append(SliceJob(config=j, spec=spec))
        else:
            raise TypeError(f"expected SliceJob or CocktailConfig, got {type(j).__name__}")
    return out
