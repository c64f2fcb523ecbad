"""Stochastic network-state generation, in PyTorch.

Counterpart of ``repro.core.network``, with the same distributions:
  traffic  ~ diurnal sinusoid + Beta(2,4)*0.4 noise, clipped to [0, 0.95]
  workload ~ Beta(2,5), clipped to [0, 0.9]
  unit costs baseline * (1 + U(0,1)); arrivals zeta * (0.5 + U(0,1)).

Every draw comes from an explicit ``torch.Generator`` on the state's device,
so the bits differ from JAX's threefry streams; the distributions and the
invariants (persistent heterogeneity, masked entities carry nothing) are
what the two packages share. ``torch.distributions.Beta`` takes no
generator, so each Beta(a, b) with integer a, b is drawn exactly as the a-th
smallest of a + b - 1 uniforms.

Two streams drive a run: the per-slot generator (``SchedulerState.rng``)
draws noise, costs and arrivals i.i.d. across slots; the persistent
heterogeneity (per-link capacity multipliers and diurnal phases) is drawn
once by :func:`heterogeneity` and carried unchanged in the state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .types import (CocktailConfig, Heterogeneity, NetworkState, ShapeConfig,
                    SliceParams, entity_masks, het_seed, make_generator,
                    split_config)

_TWO_PI = 2.0 * math.pi


def _uniform(g: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def _beta(g: torch.Generator, shape: tuple[int, ...], a: int, b: int) -> torch.Tensor:
    """Beta(a, b) for integers a, b >= 1: the a-th order statistic of
    a + b - 1 i.i.d. U(0,1) draws."""
    u = torch.rand((*shape, a + b - 1), generator=g, device=g.device)
    return torch.kthvalue(u, a, dim=-1).values


def heterogeneity(g: torch.Generator, n: int, m: int) -> Heterogeneity:
    """Draw the persistent heterogeneity once per run (``init_state``)."""
    return Heterogeneity(
        link_het=0.5 + _uniform(g, n, m),
        ec_het=0.5 + _uniform(g, m, m),
        phase_d=_uniform(g, n, m) * _TWO_PI,
        phase_D=_uniform(g, m, m) * _TWO_PI,
    )


def _traffic(g: torch.Generator, phase: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Normalized traffic in [0, 0.95]: diurnal base + Beta(2,4) noise."""
    diurnal = 0.35 + 0.3 * torch.sin(2 * math.pi * t / 288.0 + phase)  # 5-min slots
    noise = _beta(g, tuple(phase.shape), 2, 4) * 0.4
    return torch.clamp(diurnal + noise, 0.0, 0.95)


def sample_network_state(g: torch.Generator, cfg: CocktailConfig | ShapeConfig,
                         t: torch.Tensor, params: Optional[SliceParams] = None,
                         het: Optional[Heterogeneity] = None) -> NetworkState:
    """NetworkState for slot ``t``: noise, costs and arrivals from ``g``
    (advanced in place), persistent structure from ``het`` (the seed-0
    heterogeneity when None). All tensors land on ``g``'s device."""
    dev = g.device
    shape, params = split_config(cfg, params, dev)
    n, m = shape.n_cu, shape.n_ec
    if het is None:
        het = heterogeneity(make_generator(het_seed(0), dev), n, m)
    t = torch.as_tensor(t, device=dev)
    eye = torch.eye(m, device=dev)

    d = params.d_base * het.link_het * (1.0 - _traffic(g, het.phase_d, t))
    cap_d = params.cap_d_base * het.ec_het * (1.0 - _traffic(g, het.phase_D, t))
    cap_d = 0.5 * (cap_d + cap_d.T)
    cap_d = cap_d * (1.0 - eye)
    f = params.f_base * (1.0 - torch.clamp(_beta(g, (m,), 2, 5), 0.0, 0.9))
    c = params.c_base * (1.0 + _uniform(g, n, m))
    e = params.e_base * (1.0 + _uniform(g, m, m))
    e = 0.5 * (e + e.T) * (1.0 - eye)
    p = params.p_base * (1.0 + _uniform(g, m))
    arrivals = params.zeta * (0.5 + _uniform(g, n))  # E[A_i] = zeta_i

    # Ragged padding: masked entities have no capacity and generate no data.
    cu_mask, ec_mask = entity_masks(params)
    link_mask = cu_mask[:, None] * ec_mask[None, :]
    pair_mask = ec_mask[:, None] * ec_mask[None, :]
    return NetworkState(d=d * link_mask, cap_d=cap_d * pair_mask, f=f * ec_mask,
                        c=c, e=e, p=p, arrivals=arrivals * cu_mask)


def framework_cost(net: NetworkState, collected: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Per-slot framework cost C(t), eq. (14)."""
    trans_cu = torch.sum(net.c * collected)
    trans_ec = torch.sum(net.e[None, :, :] * y)  # e[j,k] per sample moved j->k
    trained_at = x + torch.sum(y, dim=1)  # (N, M): trained at EC k
    compute = torch.sum(net.p[None, :] * trained_at)
    return trans_cu + trans_ec + compute
