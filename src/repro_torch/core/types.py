"""Core state types of the Cocktail scheduler, in PyTorch.

Counterpart of ``repro.core.types``. Notation follows the paper (Sec. II):
  N CUs (data sources, index i), M ECs (ML workers, index j/k).
  Q[i]      CU data queue backlog (eq. 1)
  R[i,j]    per-CU queue maintained at EC j (eq. 12)
  Omega[i,j] cumulative samples from CU i trained by EC j (eq. 9)
  mu[i], eta[i,j], phi[i,j], lam[i,j]  Lagrange multipliers for (16a)-(16d)

Decisions per slot:
  alpha[i,j] in {0,1}  CU i connected to EC j          (constraint 2)
  theta[i,j] >= 0      connection duration fraction     (constraint 3)
  x[i,j]     >= 0      samples from R[i,j] trained at j (constraint 8,13)
  y[i,j,k]   >= 0      samples from R[i,j] offloaded to and trained at k
  z[j,k] in {0,1}      EC j paired with EC k            (constraint 5)

Every container is a ``NamedTuple`` of float32 tensors that live on one
explicit device. Randomness is carried as the run seed (``SchedulerState.rng``,
an int64 0-d tensor) that keys the sampler of ``network``; the persistent
network heterogeneity is drawn once at ``init_state`` and carried unchanged
(``SchedulerState.het``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no GPU present, only an explicit ``device="cpu"`` (or any
    other explicit device) is accepted."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Shape part of a slice configuration: the sizes that fix tensor shapes
    and loop trip counts."""

    n_cu: int  # N data sources
    n_ec: int  # M ML workers
    pair_iters: int = 120  # pair-allocation solver iterations


class SliceParams(NamedTuple):
    """Numeric per-slice parameters, float32 tensors on one device.

    ``cu_mask`` / ``ec_mask`` mark real entities (1.0) against ragged padding
    (0.0); masked entities get zero capacity/arrivals and ``MASKED_WEIGHT``
    solver weights. The policy leaves (``collect_id`` ... ``learning_aid``)
    name the slice's policies for ``SWITCHED`` dispatch (``from_config``
    defaults them to DS's; ``datasche.with_policy`` fills them from a
    spec); static dispatch ignores them. A fleet stacks K slices' params
    on a leading axis of every leaf (``stack_slice_params``).
    """

    zeta: torch.Tensor  # (N,) average data generation rate per CU
    proportions: torch.Tensor  # (N,) zeta / sum(zeta)
    delta_lo: torch.Tensor  # (N,) skew lower bound
    delta_hi: torch.Tensor  # (N,) skew upper bound
    eps: torch.Tensor  # () multiplier SGD step size
    rho: torch.Tensor  # () compute cycles per sample
    q0: torch.Tensor  # () initial CU queue backlog
    sigma0: torch.Tensor  # () empirical-multiplier base step (L-DS)
    d_base: torch.Tensor  # () CU-EC transmission capacity baseline
    cap_d_base: torch.Tensor  # () EC-EC transmission capacity baseline
    f_base: torch.Tensor  # (M,) EC computing capacity baseline (cycles)
    c_base: torch.Tensor  # () unit CU->EC transmission cost
    e_base: torch.Tensor  # () unit EC<->EC transmission cost
    p_base: torch.Tensor  # () unit computing cost
    cu_mask: Optional[torch.Tensor] = None  # (N,) 1.0 real CU, 0.0 padding
    ec_mask: Optional[torch.Tensor] = None  # (M,) 1.0 real EC, 0.0 padding
    collect_id: Optional[torch.Tensor] = None  # () int32
    train_id: Optional[torch.Tensor] = None  # () int32
    use_lsa: Optional[torch.Tensor] = None  # () float32 {0,1}
    learning_aid: Optional[torch.Tensor] = None  # () float32 {0,1}

    @property
    def device(self) -> torch.device:
        return self.zeta.device

    @classmethod
    def from_config(cls, cfg: "CocktailConfig",
                    pad_shape: Optional[ShapeConfig] = None,
                    device: DeviceLike = None) -> "SliceParams":
        """Params for ``cfg`` on ``device``; with ``pad_shape`` the entity
        axes are zero-padded and the masks mark the real block."""
        dev = resolve_device(device)
        n, m = cfg.n_cu, cfg.n_ec
        n_pad = n if pad_shape is None else pad_shape.n_cu
        m_pad = m if pad_shape is None else pad_shape.n_ec
        if n_pad < n or m_pad < m:
            raise ValueError(f"pad shape ({n_pad}, {m_pad}) smaller than "
                             f"true shape ({n}, {m})")

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        def pad(v, size):
            v = np.asarray(v, np.float32)
            return f32(np.pad(v, (0, size - v.shape[0])))

        f_base = np.broadcast_to(np.asarray(cfg.f_base, np.float32), (m,))
        return cls(
            zeta=pad(cfg.zeta_vec, n_pad),
            proportions=pad(cfg.proportions, n_pad),
            delta_lo=pad(cfg.delta_lo, n_pad),
            delta_hi=pad(cfg.delta_hi, n_pad),
            eps=f32(cfg.eps), rho=f32(cfg.rho), q0=f32(cfg.q0),
            sigma0=f32(cfg.sigma0), d_base=f32(cfg.d_base),
            cap_d_base=f32(cfg.cap_d_base), f_base=pad(f_base, m_pad),
            c_base=f32(cfg.c_base), e_base=f32(cfg.e_base),
            p_base=f32(cfg.p_base),
            cu_mask=f32(np.arange(n_pad) < n),
            ec_mask=f32(np.arange(m_pad) < m),
            collect_id=torch.tensor(0, dtype=torch.int32, device=dev),
            train_id=torch.tensor(0, dtype=torch.int32, device=dev),
            use_lsa=torch.tensor(1.0, device=dev),
            learning_aid=torch.tensor(0.0, device=dev),
        )


def entity_masks(params: SliceParams) -> tuple[torch.Tensor, torch.Tensor]:
    """(cu_mask (N,), ec_mask (M,)), all-ones where a mask is unset."""
    cu = params.cu_mask if params.cu_mask is not None else torch.ones_like(params.zeta)
    ec = params.ec_mask if params.ec_mask is not None else torch.ones_like(params.f_base)
    return cu, ec


# Weight of anything touching a ragged-padded entity: large negative so no
# greedy/knapsack/waterfill policy ever selects it, but finite so products
# with the (exactly zero) padded allocations stay 0 instead of NaN.
MASKED_WEIGHT = -1e30


def mask_pairs(a: torch.Tensor, row_mask: torch.Tensor, col_mask: torch.Tensor,
               fill: float = MASKED_WEIGHT) -> torch.Tensor:
    """Force entries of a (..., R, C) tensor whose row or column entity is
    masked to ``fill``."""
    keep = (row_mask[..., :, None] * col_mask[..., None, :]) > 0
    return torch.where(keep, a, torch.full_like(a, fill))


def per_slice(v, nd: int):
    """A per-slice value (a scalar or a (K,) tensor of a fleet's slices)
    made to broadcast against tensors with ``nd`` more trailing axes."""
    if not isinstance(v, torch.Tensor):
        return v
    return v.reshape(*v.shape, *([1] * nd))


def tree_map(fn: Callable, *trees):
    """``fn`` applied leaf by leaf over matching ``NamedTuple`` containers
    (``SliceParams``, ``SchedulerState``, ``NetworkState``, ...); ``fn``
    receives the leaves of one field, ``None`` where a field is unset."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def _stack_leaves(*leaves):
    if all(leaf is None for leaf in leaves):
        return None
    if any(leaf is None for leaf in leaves):
        raise ValueError("cannot stack a field that only some slices set")
    return torch.stack(leaves)


def stack_trees(trees: Sequence) -> "tuple":
    """Stack K containers of one type (per-slice params, states, networks,
    heterogeneity) into one with a leading K axis on every leaf."""
    return tree_map(_stack_leaves, *trees)


def unstack(tree, k: int):
    """Slice ``k`` of a stacked (K, ...) container."""
    return tree_map(lambda leaf: None if leaf is None else leaf[k], tree)


def stack_slice_params(params: Sequence["SliceParams"]) -> "SliceParams":
    """Stack K per-slice ``SliceParams`` into one (K, ...) ``SliceParams``."""
    return stack_trees(params)


@dataclasses.dataclass(frozen=True)
class CocktailConfig:
    """Configuration of one Cocktail network slice (one training job)."""

    n_cu: int
    n_ec: int
    delta: float = 0.02  # long-term skew tolerance (eq. 9)
    eps: float = 0.1  # multiplier SGD step size
    rho: float = 1.0  # compute cycles per sample
    q0: float = 5000.0  # initial CU queue backlog
    zeta: float | np.ndarray = 500.0  # per-CU generation rate; scalar -> uniform
    d_base: float = 2000.0  # CU-EC transmission capacity baseline
    cap_d_base: float = 8000.0  # EC-EC transmission capacity baseline
    f_base: float | np.ndarray = 20000.0  # EC computing capacity baseline
    c_base: float = 500.0  # unit CU->EC transmission cost
    e_base: float = 30.0  # unit EC<->EC transmission cost
    p_base: float = 100.0  # unit computing cost
    sigma0: float = 1.0  # empirical multiplier base step
    pair_iters: int = 120  # pair-allocation solver iterations
    seed: int = 0

    @property
    def zeta_vec(self) -> np.ndarray:
        z = np.asarray(self.zeta, dtype=np.float64)
        if z.ndim == 0:
            z = np.full((self.n_cu,), float(z))
        if z.shape != (self.n_cu,):
            raise ValueError(f"zeta has shape {z.shape}, expected ({self.n_cu},)")
        return z

    @property
    def proportions(self) -> np.ndarray:
        z = self.zeta_vec
        return z / z.sum()

    @property
    def delta_lo(self) -> np.ndarray:
        return np.maximum(self.proportions - self.delta, 0.0)

    @property
    def delta_hi(self) -> np.ndarray:
        return np.minimum(self.proportions + self.delta, 1.0)

    @property
    def shape(self) -> ShapeConfig:
        return ShapeConfig(n_cu=self.n_cu, n_ec=self.n_ec, pair_iters=self.pair_iters)


def split_config(cfg: "CocktailConfig | ShapeConfig",
                 params: Optional[SliceParams] = None,
                 device: DeviceLike = None) -> tuple[ShapeConfig, SliceParams]:
    """Normalise a ``CocktailConfig`` (params built on ``device``) or an
    explicit (``ShapeConfig``, ``SliceParams``) pair into the split the core
    runs on."""
    if isinstance(cfg, CocktailConfig):
        if params is None:
            params = SliceParams.from_config(cfg, device=device)
        return cfg.shape, params
    if params is None:
        raise TypeError("ShapeConfig requires explicit SliceParams")
    return cfg, params


class NetworkState(NamedTuple):
    """Time-varying network state S(t) plus arrivals A(t) for one slot."""

    d: torch.Tensor  # (N, M) CU->EC transmission capacity, samples/slot
    cap_d: torch.Tensor  # (M, M) EC<->EC capacity (symmetric, 0 diag)
    f: torch.Tensor  # (M,) EC computing capacity, cycles/slot
    c: torch.Tensor  # (N, M) unit CU->EC transmission cost
    e: torch.Tensor  # (M, M) unit EC<->EC transmission cost
    p: torch.Tensor  # (M,) unit computing cost
    arrivals: torch.Tensor  # (N,) generated samples A_i(t)


class Heterogeneity(NamedTuple):
    """Slot-invariant structure of the network, drawn once per run."""

    link_het: torch.Tensor  # (N, M) CU->EC capacity multiplier, U[0.5, 1.5]
    ec_het: torch.Tensor  # (M, M) EC<->EC capacity multiplier, U[0.5, 1.5]
    phase_d: torch.Tensor  # (N, M) diurnal phase of the CU->EC traffic
    phase_D: torch.Tensor  # (M, M) diurnal phase of the EC<->EC traffic


class Multipliers(NamedTuple):
    mu: torch.Tensor  # (N,)   queue stability for Q  (16a)
    eta: torch.Tensor  # (N, M) queue stability for R  (16b)
    phi: torch.Tensor  # (N, M) skew lower bound       (16c)
    lam: torch.Tensor  # (N, M) skew upper bound       (16d)

    @staticmethod
    def zeros(n_cu: int, n_ec: int, q0: torch.Tensor, eps: torch.Tensor) -> "Multipliers":
        # mu is initialised consistently with the Q0 backlog (mu = eps * Q).
        dev = q0.device
        return Multipliers(
            mu=torch.full((n_cu,), 1.0, device=dev) * (q0 * eps),
            eta=torch.zeros((n_cu, n_ec), device=dev),
            phi=torch.zeros((n_cu, n_ec), device=dev),
            lam=torch.zeros((n_cu, n_ec), device=dev),
        )


class QueueState(NamedTuple):
    q: torch.Tensor  # (N,)   CU queues
    r: torch.Tensor  # (N, M) CU queues at ECs
    omega: torch.Tensor  # (N, M) cumulative trained per (CU, EC)

    @staticmethod
    def init(n_cu: int, n_ec: int, q0: torch.Tensor) -> "QueueState":
        dev = q0.device
        return QueueState(
            q=torch.full((n_cu,), 1.0, device=dev) * q0,
            r=torch.zeros((n_cu, n_ec), device=dev),
            omega=torch.zeros((n_cu, n_ec), device=dev),
        )


class Decision(NamedTuple):
    alpha: torch.Tensor  # (N, M) {0,1}
    theta: torch.Tensor  # (N, M) >= 0, sum_i theta[:, j] <= 1
    x: torch.Tensor  # (N, M) >= 0
    y: torch.Tensor  # (N, M, M) y[i, j, k]: from R[i,j], trained at k
    z: torch.Tensor  # (M, M) {0,1} symmetric pairing

    @property
    def duty(self) -> torch.Tensor:
        """(N, M) fraction of the slot each CU->EC connection is live."""
        return self.alpha * self.theta

    def collected(self, net: NetworkState) -> torch.Tensor:
        """(N, M) samples moved CU->EC this slot before the backlog cap."""
        return self.alpha * self.theta * net.d


class SchedulerState(NamedTuple):
    """Full state carried slot to slot by DataSche / L-DS.

    ``rng`` is the run seed: with the slot counter ``t`` it keys the slot's
    noise, so it is carried unchanged and a state is never changed by the
    slot that reads it. ``het`` is the persistent heterogeneity, carried
    unchanged (the JAX package carries the key it is drawn from instead)."""

    queues: QueueState
    mults: Multipliers
    emp_mults: Multipliers  # empirical multipliers Theta' (L-DS only)
    t: torch.Tensor  # () int32 slot counter
    total_cost: torch.Tensor  # () accumulated framework cost
    total_trained: torch.Tensor  # () accumulated |D(t)|
    uploaded: torch.Tensor  # (N,) cumulative per-CU uploads (Fig. 5 metric)
    rng: torch.Tensor  # () int64 run seed, keys the per-slot network noise
    het: Heterogeneity  # persistent heterogeneity

    @property
    def device(self) -> torch.device:
        return self.queues.q.device


# Salt separating the persistent-heterogeneity stream from every other use
# of the run seed (spells "HET\0", as in the JAX package).
_HET_FOLD = 0x48455400


def het_seed(seed: int) -> int:
    """Seed that keys the persistent heterogeneity: a hash of (run seed,
    salt), so its streams never coincide with the run seed's."""
    digest = hashlib.sha256(f"{int(seed)}:{_HET_FOLD}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def seed_tensor(seed: "int | Sequence[int] | torch.Tensor", device: torch.device) -> torch.Tensor:
    """A seed as the int64 tensor on ``device`` that keys the sampler: 0-d
    for an int, (K,) for a sequence of K ints (one per slice of a fleet);
    an int is cut to its low 63 bits."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64)
    if isinstance(seed, (list, tuple)):
        return torch.tensor([int(s) & 0x7FFF_FFFF_FFFF_FFFF for s in seed],
                            dtype=torch.int64, device=device)
    return torch.tensor(int(seed) & 0x7FFF_FFFF_FFFF_FFFF, dtype=torch.int64, device=device)


def init_state(cfg: "CocktailConfig | ShapeConfig",
               params: Optional[SliceParams] = None,
               seed: Optional[int] = None,
               device: DeviceLike = None) -> SchedulerState:
    """Initial scheduler state on ``device`` (CUDA unless the caller names
    another; given ``params`` fix the device when ``device`` is None)."""
    if params is not None and device is None:
        device = params.device
    dev = resolve_device(device)
    shape, params = split_config(cfg, params, dev)
    if seed is None:
        seed = getattr(cfg, "seed", 0)
    from .network import heterogeneity  # network imports this module

    cu_mask, _ = entity_masks(params)
    queues = QueueState.init(shape.n_cu, shape.n_ec, params.q0)
    queues = queues._replace(q=queues.q * cu_mask)
    mults = Multipliers.zeros(shape.n_cu, shape.n_ec, params.q0, params.eps)
    mults = mults._replace(mu=mults.mu * cu_mask)
    het = heterogeneity(het_seed(seed), shape.n_cu, shape.n_ec, dev)
    return SchedulerState(
        queues=queues, mults=mults, emp_mults=mults,
        t=torch.tensor(0, dtype=torch.int32, device=dev),
        total_cost=torch.tensor(0.0, device=dev),
        total_trained=torch.tensor(0.0, device=dev),
        uploaded=torch.zeros((shape.n_cu,), device=dev),
        rng=seed_tensor(seed, dev),
        het=het,
    )

