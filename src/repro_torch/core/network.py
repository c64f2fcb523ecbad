"""Stochastic network-state generation, in PyTorch.

Counterpart of ``repro.core.network``, with the same distributions:
  traffic  ~ diurnal sinusoid + Beta(2,4)*0.4 noise, clipped to [0, 0.95]
  workload ~ Beta(2,5), clipped to [0, 0.9]
  unit costs baseline * (1 + U(0,1)); arrivals zeta * (0.5 + U(0,1)).

Sampling is **keyed**, as in the JAX package: every element draws its
uniforms from a counter-based generator (Threefry-2x32, 20 rounds), keyed by
(run seed, stream, slot ``t``) and counted by its entity indices (i, j) and
the index k of the uniform within the element. A value therefore depends
only on the seed, the stream, the slot and the indices, never on the array
shape: a slice zero-padded to a larger ``ShapeConfig`` draws bit-identical
values on its real block, and the CPU and a CUDA card draw the same bits.
The words are those of ``jax.random``'s Threefry, but the keys are derived
differently, so the values differ from JAX's; the distributions and the
invariants (padding invariance, persistent heterogeneity, masked entities
carry nothing) are what the two packages share. Each Beta(a, b) with
integer a, b is drawn exactly as the a-th smallest of a + b - 1 uniforms.

Two seeds drive a run: the run seed (``SchedulerState.rng``) draws noise,
costs and arrivals, i.i.d. across slots through ``t``; the persistent
heterogeneity (per-link capacity multipliers and diurnal phases) is drawn
once by :func:`heterogeneity` from ``types.het_seed(run seed)`` and carried
unchanged in the state.

Everything runs as elementwise torch ops on the seed's device: one
Threefry pass derives the key of each stream of a call, a second draws all
of the call's uniforms from one stacked counter tensor.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch

from .types import (CocktailConfig, DeviceLike, Heterogeneity, NetworkState,
                    ShapeConfig, SliceParams, entity_masks, het_seed, per_slice,
                    resolve_device, seed_tensor, split_config)

_TWO_PI = 2.0 * math.pi

# Stream ids: part of the sampler's definition (changing one changes draws).
LINK_HET, EC_HET, PHASE_D, PHASE_DD = 0, 1, 2, 3  # heterogeneity
NOISE_D, NOISE_DD, WORKLOAD, COST_C, COST_E, COST_P, ARRIVALS = 4, 5, 6, 7, 8, 9, 10

# Threefry-2x32 (Salmon et al., SC'11; the Random123 and jax.random
# version): 32-bit words in int64 tensors, masked after every add.
_MASK = 0xFFFF_FFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD1_1BDA


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds: key (k0, k1), counter (x0, x1) ->
    two 32-bit words. Arguments are int64 tensors (or ints) holding values
    in [0, 2**32) and broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(20):
        rot = _ROTATIONS[r % 8]
        x0 = (x0 + x1) & _MASK
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _MASK
        x1 = x1 ^ x0
        if r % 4 == 3:  # key injection after every 4 rounds
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


Draw = tuple[int, tuple[int, ...], int]  # (stream, entity shape, uniforms each)


@functools.lru_cache(maxsize=64)
def _counters(draws: tuple[Draw, ...], device: torch.device):
    """Stacked counters of ``draws`` (they depend on shapes only, so they
    are cached; callers never write to them): per element x0 = i and
    x1 = j k_count + k (x1 = k for a vector), and the index of its draw."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    x0s, x1s, which = [], [], []
    for d, (_, shape, k) in enumerate(draws):
        if not 1 <= len(shape) <= 2 or shape[0] >= 2 ** 32 or shape[-1] * k >= 2 ** 32:
            raise ValueError(f"cannot key a draw of shape {shape} with {k} uniforms each")
        full = (*shape, k)
        x0 = ar(shape[0]).reshape(-1, *([1] * len(shape))).expand(full)
        if len(shape) == 2:
            x1 = (ar(shape[1])[:, None] * k + ar(k)[None, :]).expand(full)
        else:
            x1 = ar(k).expand(full)
        x0s.append(x0.reshape(-1))
        x1s.append(x1.reshape(-1))
        which.append(torch.full((x0s[-1].numel(),), d, dtype=torch.int64, device=device))
    streams = torch.tensor([s for s, _, _ in draws], dtype=torch.int64, device=device)
    return torch.cat(x0s), torch.cat(x1s), torch.cat(which), streams


def uniform_bits(seed, t, draws: Sequence[Draw], device: DeviceLike = None) -> torch.Tensor:
    """The 32-bit words (int64) of all of ``draws``, stacked on the last
    axis: element (i[, j], k) of a draw is the first output word of Threefry
    keyed by (seed, stream, t) at counter (i, j k_count + k).

    ``seed`` and ``t`` may carry leading slice axes (a fleet's (K,) seeds
    and slot counters); the words then get those axes in front, and slice
    k's words are those of its own single-slice draw. The counters depend
    on the draws' shapes only and are shared by every slice."""
    dev = seed.device if isinstance(seed, torch.Tensor) else resolve_device(device)
    x0, x1, which, streams = _counters(tuple(draws), dev)
    seed = seed_tensor(seed, dev)[..., None]
    t = torch.as_tensor(t, device=dev).to(torch.int64)[..., None] & _MASK
    k0, k1 = threefry2x32(seed & _MASK, (seed >> 32) & _MASK, streams, t)
    bits, _ = threefry2x32(k0[..., which], k1[..., which], x0, x1)
    return bits


def uniforms(seed, t, draws: Sequence[Draw], device: DeviceLike = None) -> list[torch.Tensor]:
    """U[0, 1) float32 draws, one tensor of shape (*lead, *shape, k) per
    draw ((*lead, *shape) when k == 1), ``lead`` the slice axes of ``seed``
    and ``t``: the top 24 bits of each word times 2**-24."""
    u = (uniform_bits(seed, t, draws, device) >> 8).to(torch.float32) * 2.0 ** -24
    lead = u.shape[:-1]
    out = []
    sizes = [math.prod(s) * k for _, s, k in draws]
    for (_, shape, k), part in zip(draws, torch.split(u, sizes, dim=-1)):
        out.append(part.reshape(*lead, *shape) if k == 1 else part.reshape(*lead, *shape, k))
    return out


def _beta(u: torch.Tensor, a: int) -> torch.Tensor:
    """Beta(a, b) from the a + b - 1 uniforms on u's last axis: their a-th
    order statistic."""
    return torch.kthvalue(u, a, dim=-1).values


def heterogeneity(seed, n: int, m: int, device: DeviceLike = None) -> Heterogeneity:
    """The persistent heterogeneity drawn from ``seed`` (``init_state``
    passes ``het_seed(run seed)``), keyed like every other draw. A (K,)
    ``seed`` tensor draws K slices' heterogeneity, each field (K, ...)."""
    link, ec, ph_d, ph_dd = uniforms(seed, 0, ((LINK_HET, (n, m), 1), (EC_HET, (m, m), 1),
                                               (PHASE_D, (n, m), 1), (PHASE_DD, (m, m), 1)),
                                     device)
    return Heterogeneity(link_het=0.5 + link, ec_het=0.5 + ec,
                         phase_d=ph_d * _TWO_PI, phase_D=ph_dd * _TWO_PI)


def _traffic(noise_u: torch.Tensor, phase: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Normalized traffic in [0, 0.95]: diurnal base + Beta(2,4) noise drawn
    from the 5 uniforms on ``noise_u``'s last axis; ``t`` is per slice."""
    t = per_slice(t, 2)
    diurnal = 0.35 + 0.3 * torch.sin(2 * math.pi * t / 288.0 + phase)  # 5-min slots
    return torch.clamp(diurnal + _beta(noise_u, 2) * 0.4, 0.0, 0.95)


def _workload(u: torch.Tensor) -> torch.Tensor:
    """Normalized co-tenant workload in [0, 0.9]: Beta(2,5) from the 6
    uniforms on ``u``'s last axis."""
    return torch.clamp(_beta(u, 2), 0.0, 0.9)


def slot_draws(n: int, m: int) -> tuple[Draw, ...]:
    """The draws of one slot at N x M: traffic noise of d and of D (5
    uniforms each), workload (6), then c, e, p and arrivals."""
    return ((NOISE_D, (n, m), 5), (NOISE_DD, (m, m), 5), (WORKLOAD, (m,), 6),
            (COST_C, (n, m), 1), (COST_E, (m, m), 1), (COST_P, (m,), 1), (ARRIVALS, (n,), 1))


def sample_network_state(seed, cfg: CocktailConfig | ShapeConfig,
                         t: torch.Tensor, params: Optional[SliceParams] = None,
                         het: Optional[Heterogeneity] = None,
                         device: DeviceLike = None) -> NetworkState:
    """NetworkState for slot ``t`` of the run seeded by ``seed`` (an int or
    an int64 0-d tensor): noise, costs and arrivals keyed by (seed, t),
    persistent structure from ``het`` (the seed-0 heterogeneity when None).
    Tensors land on the seed tensor's device, else on that of ``params``,
    else on ``device``.

    A fleet passes (K,) seeds and slot counters with (K, ...) ``params``
    and ``het``: every field then has a leading K axis, and slice k equals
    its single-slice draw bit for bit."""
    if isinstance(seed, torch.Tensor):
        dev = seed.device
    elif params is not None and device is None:
        dev = params.device
    else:
        dev = resolve_device(device)
    shape, params = split_config(cfg, params, dev)
    n, m = shape.n_cu, shape.n_ec
    if het is None:
        het = heterogeneity(het_seed(0), n, m, dev)
    t = torch.as_tensor(t, device=dev)
    eye = torch.eye(m, device=dev)
    u_d, u_dd, u_f, u_c, u_e, u_p, u_a = uniforms(seed_tensor(seed, dev), t, slot_draws(n, m))

    d = per_slice(params.d_base, 2) * het.link_het * (1.0 - _traffic(u_d, het.phase_d, t))
    cap_d = per_slice(params.cap_d_base, 2) * het.ec_het * (1.0 - _traffic(u_dd, het.phase_D, t))
    cap_d = 0.5 * (cap_d + cap_d.transpose(-1, -2))
    cap_d = cap_d * (1.0 - eye)
    f = params.f_base * (1.0 - _workload(u_f))
    c = per_slice(params.c_base, 2) * (1.0 + u_c)
    e = per_slice(params.e_base, 2) * (1.0 + u_e)
    e = 0.5 * (e + e.transpose(-1, -2)) * (1.0 - eye)
    p = per_slice(params.p_base, 1) * (1.0 + u_p)
    arrivals = params.zeta * (0.5 + u_a)  # E[A_i] = zeta_i

    # Ragged padding: masked entities have no capacity and generate no data.
    cu_mask, ec_mask = entity_masks(params)
    link_mask = cu_mask[..., :, None] * ec_mask[..., None, :]
    pair_mask = ec_mask[..., :, None] * ec_mask[..., None, :]
    return NetworkState(d=d * link_mask, cap_d=cap_d * pair_mask, f=f * ec_mask,
                        c=c, e=e, p=p, arrivals=arrivals * cu_mask)


def framework_cost(net: NetworkState, collected: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Per-slot framework cost C(t), eq. (14); one per leading slice index."""
    trans_cu = torch.sum(net.c * collected, dim=(-2, -1))
    trans_ec = torch.sum(net.e[..., None, :, :] * y, dim=(-3, -2, -1))  # e[j,k] per sample j->k
    trained_at = x + torch.sum(y, dim=-2)  # (..., N, M): trained at EC k
    compute = torch.sum(net.p[..., None, :] * trained_at, dim=(-2, -1))
    return trans_cu + trans_ec + compute
