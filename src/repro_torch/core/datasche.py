"""DataSche and Learning-aid DataSche online scheduling (paper Sec. III).

Counterpart of ``repro.core.datasche``. Each slot:

  1. observe the network state S(t) (or sample it, keyed by the state's seed and t),
  2. solve the collection subproblem  -> alpha, theta      (P1' / P1 / full)
  3. solve the training subproblem    -> x, y, z           (P2' / linear / ...)
  4. execute: update queues Q, R, cumulative Omega and the framework cost,
  5. SGD-update the Lagrange multipliers; L-DS also updates empirical
     multipliers Theta' from virtual plain-P1/P2 decisions with a diminishing
     step and schedules with Theta~ = Theta + Theta' - pi.

Policies come from two indexed tables, registered in the same order as in
the JAX package (collection: skew=0, plain=1, cufull=2; training: skew=0,
linear=1, solo=2, ecfull=3), and are chosen by an ``AlgoSpec``. Dispatch is
static: the spec names the policies. ``exact=True`` swaps the greedy
matchers for the numpy/networkx oracles. The three greedy matchers go
through ``kernels.matching.ops``: CUDA kernels on the card, the plain
PyTorch versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..kernels.matching import ops as matching_ops
from . import training_alloc
from .network import framework_cost, sample_network_state
from .types import (MASKED_WEIGHT, CocktailConfig, Decision, DeviceLike,
                    Multipliers, NetworkState, QueueState, SchedulerState,
                    ShapeConfig, SliceParams, entity_masks, init_state,
                    mask_pairs, resolve_device, split_config)

_TINY = 1e-9
_NEG = MASKED_WEIGHT


class PolicyTable:
    """Ordered registry of policies sharing one call signature; the
    registration order fixes each policy's integer id."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, int] = {}
        self._fns: list = []

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise ValueError(f"{self.kind} policy {name!r} already registered")
            self._entries[name] = len(self._fns)
            self._fns.append(fn)
            return fn
        return deco

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._entries)

    def index(self, name: str) -> int:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} policy {name!r}; "
                           f"registered: {list(self._entries)}") from None

    def __getitem__(self, name: str):
        return self._fns[self.index(name)]


COLLECTION_POLICIES = PolicyTable("collection")
TRAINING_POLICIES = PolicyTable("training")

_SWITCH = "switch"


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Which variant of the scheduler to run (paper Sec. IV baselines)."""

    name: str = "ds"
    collection: str = "skew"  # skew | plain | cufull
    training: str = "skew"  # skew | linear | solo | ecfull
    use_lsa: bool = True  # long-term skew amendment (phi/lam multipliers)
    learning_aid: bool = False
    exact: bool = False  # exact Thm.1/Thm.2 matching oracles (host side)

    @property
    def switched(self) -> bool:
        return self.collection == _SWITCH or self.training == _SWITCH


DS = AlgoSpec(name="ds")
DS_EXACT = AlgoSpec(name="ds-exact", exact=True)
LDS = AlgoSpec(name="l-ds", learning_aid=True)
NO_SDC = AlgoSpec(name="no-sdc", collection="plain")
NO_SLT = AlgoSpec(name="no-slt", training="linear")
NO_LSA = AlgoSpec(name="no-lsa", use_lsa=False)
GREEDY = AlgoSpec(name="greedy")  # greedy matchers == production path
EC_FULL = AlgoSpec(name="ecfull", training="ecfull")
EC_SELF = AlgoSpec(name="ecself", training="solo")
CU_FULL = AlgoSpec(name="cufull", collection="cufull")

# Branch-free dispatch of the JAX package (policy chosen per slice from the
# SliceParams leaves). The port runs it in the fleet slice; step refuses it.
SWITCHED = AlgoSpec(name="switched", collection=_SWITCH, training=_SWITCH,
                    learning_aid=True)
SWITCHED_NOAID = AlgoSpec(name="switched-noaid", collection=_SWITCH,
                          training=_SWITCH)

ALL_SPECS = {s.name: s for s in
             [DS, DS_EXACT, LDS, NO_SDC, NO_SLT, NO_LSA, GREEDY, EC_FULL, EC_SELF, CU_FULL]}


# --------------------------------------------------------------------------
# Weights (the per-slot dual prices entering P1'/P2')
# --------------------------------------------------------------------------

def collection_weights(net: NetworkState, mults: Multipliers,
                       cu_mask: Optional[torch.Tensor] = None,
                       ec_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w_ij = d_ij (mu_i - eta_ij - c_ij); entries of masked entities are 0."""
    w = net.d * (mults.mu[:, None] - mults.eta - net.c)
    if cu_mask is not None or ec_mask is not None:
        cu = cu_mask if cu_mask is not None else torch.ones_like(w[:, 0])
        ec = ec_mask if ec_mask is not None else torch.ones_like(w[0, :])
        w = mask_pairs(w, cu, ec, fill=0.0)
    return w


def training_weights(cfg: CocktailConfig | ShapeConfig, net: NetworkState,
                     mults: Multipliers, use_lsa: bool,
                     params: Optional[SliceParams] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(beta (N, M), gamma (N, M, M)): beta[i,j] weighs x[i,j]; gamma[i,j,k]
    = beta[i,k] + eta[i,j] - eta[i,k] - e[j,k] weighs y[i,j,k]. Entries of
    masked entities are ``MASKED_WEIGHT``."""
    _, params = split_config(cfg, params, net.d.device)
    phi = mults.phi if use_lsa else torch.zeros_like(mults.phi)
    lam = mults.lam if use_lsa else torch.zeros_like(mults.lam)
    d_hi, d_lo = params.delta_hi, params.delta_lo
    common = torch.sum(lam * d_hi[:, None] - phi * d_lo[:, None], dim=0)  # (M,)
    beta = -net.p[None, :] + mults.eta - lam + phi + common[None, :]
    gamma = (beta[:, None, :] + mults.eta[:, :, None]
             - mults.eta[:, None, :] - net.e[None, :, :])
    cu, ec = entity_masks(params)
    beta = mask_pairs(beta, cu, ec)
    keep = (cu[:, None, None] * ec[None, :, None] * ec[None, None, :]) > 0
    gamma = torch.where(keep, gamma, torch.full_like(gamma, _NEG))
    return beta, gamma


# --------------------------------------------------------------------------
# Collection policies: (shape, params, net, mults, queues, exact) -> (alpha, theta)
# --------------------------------------------------------------------------

@COLLECTION_POLICIES.register("skew")
def _collect_skew(shape, params, net, mults, queues, exact):
    cu, ec = entity_masks(params)
    w = collection_weights(net, mults, cu, ec)
    logw = torch.where(w > 0, torch.log(torch.clamp(w, min=_TINY)),
                       torch.full_like(w, float("-inf")))
    if exact:
        from . import oracle
        alpha, theta = oracle.exact_collection(logw.cpu().numpy())
        return (torch.as_tensor(alpha, device=w.device),
                torch.as_tensor(theta, device=w.device))
    return matching_ops.greedy_collection(logw, cu_mask=cu, ec_mask=ec)


@COLLECTION_POLICIES.register("plain")
def _collect_plain(shape, params, net, mults, queues, exact):
    cu, ec = entity_masks(params)
    w = collection_weights(net, mults)
    alpha = matching_ops.greedy_assignment(w, cu_mask=cu, ec_mask=ec)
    return alpha, alpha  # theta = 1 on the selected connection


@COLLECTION_POLICIES.register("cufull")
def _collect_cufull(shape, params, net, mults, queues, exact):
    # Every real EC slot is shared evenly by the n_real connected CUs.
    cu, ec = entity_masks(params)
    n_real = torch.clamp(torch.sum(cu), min=1.0)
    alpha = cu[:, None] * ec[None, :]
    return alpha, alpha / n_real


# --------------------------------------------------------------------------
# Training policies: (shape, params, net, mults, queues, exact, use_lsa) -> (x, y, z)
# --------------------------------------------------------------------------

def _pair_index(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """EC pairs j < k in row-major order (that of ``np.triu_indices``)."""
    pj, pk = torch.triu_indices(m, m, offset=1, device=device)
    return pj, pk


def _compose_from_match(match, x_solo, pairs, pa, n, m):
    """Assemble (x, y, z) from the matching and the pre-solved allocations.
    Each EC is in at most one matched pair, so every entry receives at most
    one nonzero term and the scatter below equals the JAX one-hot sums."""
    pj, pk = pairs
    sel = match[pj, pk][:, None]  # (P, 1): 1 if pair matched
    x = x_solo * torch.diagonal(match)[None, :]
    x = x.index_add(1, pj, (pa.x_j * sel).T).index_add(1, pk, (pa.x_k * sel).T)
    y = torch.zeros((n, m, m), dtype=x.dtype, device=x.device)
    y[:, pj, pk] = (pa.y_jk * sel).T
    y[:, pk, pj] = (pa.y_kj * sel).T
    z = match * (1.0 - torch.eye(m, dtype=match.dtype, device=match.device))
    return x, y, z


def _train_generic(shape, params, net, mults, queues, exact, use_lsa, solo_fn, pair_fn):
    beta, gamma = training_weights(shape, net, mults, use_lsa, params)
    budgets = net.f / params.rho
    n, m = shape.n_cu, shape.n_ec
    r = queues.r

    x_solo, val_solo = solo_fn(beta.T, r.T, budgets)  # per EC, batched over M
    x_solo = x_solo.T

    pj, pk = _pair_index(m, beta.device)
    pa = pair_fn(beta[:, pj].T, gamma[:, pk, pj].T, beta[:, pk].T, gamma[:, pj, pk].T,
                 r[:, pj].T, r[:, pk].T, budgets[pj], budgets[pk], net.cap_d[pj, pk])
    pair_vals = torch.zeros((m, m), dtype=beta.dtype, device=beta.device)
    pair_vals[pj, pk] = pa.value
    pair_vals = pair_vals + pair_vals.T

    _, ec = entity_masks(params)
    if exact:
        from . import oracle
        val_solo = torch.where(ec > 0, val_solo, torch.full_like(val_solo, _NEG))
        pair_vals = mask_pairs(pair_vals, ec, ec)
        match = torch.as_tensor(oracle.exact_pairing(val_solo.cpu().numpy(),
                                                     pair_vals.cpu().numpy()),
                                device=beta.device)
    else:
        match = matching_ops.greedy_pairing(val_solo, pair_vals, ec_mask=ec)
    return _compose_from_match(match, x_solo, (pj, pk), pa, n, m)


@TRAINING_POLICIES.register("skew")
def _train_skew(shape, params, net, mults, queues, exact, use_lsa):
    def pair_fn(*args):
        return training_alloc.pair_allocate(*args, iters=shape.pair_iters)
    return _train_generic(shape, params, net, mults, queues, exact, use_lsa,
                          training_alloc.solo_waterfill, pair_fn)


@TRAINING_POLICIES.register("linear")
def _train_linear(shape, params, net, mults, queues, exact, use_lsa):
    return _train_generic(shape, params, net, mults, queues, exact, use_lsa,
                          training_alloc.linear_solo, training_alloc.linear_pair)


@TRAINING_POLICIES.register("solo")
def _train_solo(shape, params, net, mults, queues, exact, use_lsa):
    beta, _ = training_weights(shape, net, mults, use_lsa, params)
    x, _ = training_alloc.solo_waterfill(beta.T, queues.r.T, net.f / params.rho)
    n, m = shape.n_cu, shape.n_ec
    dev = beta.device
    return x.T, torch.zeros((n, m, m), device=dev), torch.zeros((m, m), device=dev)


@TRAINING_POLICIES.register("ecfull")
def _train_ecfull(shape, params, net, mults, queues, exact, use_lsa):
    beta, gamma = training_weights(shape, net, mults, use_lsa, params)
    x, y, _ = training_alloc.full_allocate(beta, gamma, queues.r, net.f / params.rho,
                                           net.cap_d)
    m = shape.n_ec
    _, ec = entity_masks(params)
    z = 1.0 - torch.eye(m, device=beta.device)
    return x, y, z * (ec[:, None] * ec[None, :])


def _pin_policy_ids() -> None:
    # The ids are part of the interface shared with the JAX package.
    if (COLLECTION_POLICIES.names != ("skew", "plain", "cufull")
            or TRAINING_POLICIES.names != ("skew", "linear", "solo", "ecfull")):
        raise RuntimeError("policy table order drifted from the JAX package's")


# --------------------------------------------------------------------------
# Dynamics (queues + multiplier SGD)
# --------------------------------------------------------------------------

def _served(alpha, theta, net, queues):
    """Samples actually moved CU->EC: alpha*theta*d, capped by the Q backlog."""
    req = alpha * theta * net.d
    tot = torch.sum(req, dim=1)
    scale = torch.clamp(queues.q / torch.clamp(tot, min=_TINY), max=1.0)
    return req * scale[:, None]


def update_multipliers(cfg: CocktailConfig | ShapeConfig, mults: Multipliers,
                       net: NetworkState, served: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, use_lsa: bool, step: torch.Tensor | float,
                       params: Optional[SliceParams] = None) -> Multipliers:
    _, params = split_config(cfg, params, x.device)
    dep_r = x + torch.sum(y, dim=2)  # leaves queue R[i,j]
    trained_at = x + torch.sum(y, dim=1)  # trained at EC k
    tot_j = torch.sum(trained_at, dim=0)
    d_hi, d_lo = params.delta_hi, params.delta_lo
    cu, ec = entity_masks(params)
    link = cu[:, None] * ec[None, :]
    mu = torch.clamp(mults.mu + step * (net.arrivals - torch.sum(served, dim=1)), min=0.0) * cu
    eta = torch.clamp(mults.eta + step * (served - dep_r), min=0.0) * link
    if use_lsa:
        phi = torch.clamp(mults.phi + step * (d_lo[:, None] * tot_j[None, :] - trained_at),
                          min=0.0) * link
        lam = torch.clamp(mults.lam + step * (trained_at - d_hi[:, None] * tot_j[None, :]),
                          min=0.0) * link
    else:
        phi, lam = mults.phi, mults.lam
    return Multipliers(mu=mu, eta=eta, phi=phi, lam=lam)


def apply_decision(cfg: CocktailConfig | ShapeConfig, queues: QueueState,
                   net: NetworkState, served: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> QueueState:
    dep_r = x + torch.sum(y, dim=2)
    trained_at = x + torch.sum(y, dim=1)
    q = torch.clamp(queues.q - torch.sum(served, dim=1), min=0.0) + net.arrivals
    r = torch.clamp(queues.r - dep_r, min=0.0) + served
    return QueueState(q=q, r=r, omega=queues.omega + trained_at)


# --------------------------------------------------------------------------
# One slot
# --------------------------------------------------------------------------

class SlotRecord(NamedTuple):
    cost: torch.Tensor
    trained: torch.Tensor
    q_backlog: torch.Tensor
    r_backlog: torch.Tensor
    skew: torch.Tensor


def stack_slot_records(recs: Sequence[SlotRecord]) -> SlotRecord:
    """Stack per-slot records time-major (leading axis = slot index)."""
    return SlotRecord(*[torch.stack([getattr(r, f) for r in recs])
                        for f in SlotRecord._fields])


def skew_degree(cfg: CocktailConfig | ShapeConfig | SliceParams, omega: torch.Tensor,
                params: Optional[SliceParams] = None) -> torch.Tensor:
    """max_{i,j} | Omega_ij / sum_l Omega_lj - zeta_i / sum zeta | (eq. 9 LHS)."""
    if params is None and isinstance(cfg, SliceParams):
        params = cfg
    else:
        _, params = split_config(cfg, params, omega.device)
    tot = torch.sum(omega, dim=0, keepdim=True)
    frac = omega / torch.clamp(tot, min=_TINY)
    dev = torch.abs(frac - params.proportions[:, None])
    return torch.max(torch.where(tot > _TINY, dev, torch.zeros_like(dev)))


def _pi(params: SliceParams) -> torch.Tensor:
    """L-DS distance parameter pi = sqrt(eps) * log^2(eps)."""
    return torch.sqrt(params.eps) * torch.log(params.eps) ** 2


def _affine(a: Multipliers, b: Multipliers, shift: torch.Tensor) -> Multipliers:
    return Multipliers(*[x + y - shift for x, y in zip(a, b)])


def slot_network(cfg: CocktailConfig | ShapeConfig, state: SchedulerState,
                 params: Optional[SliceParams] = None) -> NetworkState:
    """The network state ``step`` samples for ``state`` when none is given:
    a pure function of the state (run seed, slot ``t``, heterogeneity)."""
    shape, params = split_config(cfg, params, state.device)
    return sample_network_state(state.rng, shape, state.t, params, het=state.het)


def step(cfg: CocktailConfig | ShapeConfig, spec: AlgoSpec, state: SchedulerState,
         net: Optional[NetworkState] = None,
         params: Optional[SliceParams] = None
         ) -> tuple[SchedulerState, SlotRecord, Decision]:
    """Run one slot on the state's device. ``net`` injects the network
    state; otherwise it is ``slot_network(cfg, state)``, keyed by the run
    seed ``state.rng`` and the slot ``state.t``."""
    if spec.switched:
        raise NotImplementedError(
            f"spec {spec.name!r} uses branch-free (SWITCHED) dispatch, which the "
            "PyTorch port adds with fleets (core/fleet.py) in a later slice; "
            "use a static spec such as DS or LDS")
    shape, params = split_config(cfg, params, state.device)
    if net is None:
        net = slot_network(shape, state, params)

    use_lsa = spec.use_lsa
    if spec.learning_aid:
        eff = _affine(state.mults, state.emp_mults, _pi(params))
    else:
        eff = state.mults

    collect = COLLECTION_POLICIES[spec.collection]
    train = TRAINING_POLICIES[spec.training]
    alpha, theta = collect(shape, params, net, eff, state.queues, spec.exact)
    x, y, z = train(shape, params, net, eff, state.queues, spec.exact, use_lsa)

    served = _served(alpha, theta, net, state.queues)
    cost = framework_cost(net, served, x, y)
    queues = apply_decision(shape, state.queues, net, served, x, y)
    mults = update_multipliers(shape, state.mults, net, served, x, y,
                               use_lsa, params.eps, params)

    emp = state.emp_mults
    if spec.learning_aid:
        # Virtual decisions from plain P1/P2 with the empirical multipliers;
        # they update Theta' only (diminishing step), never the real queues.
        v_alpha, v_theta = _collect_plain(shape, params, net, state.emp_mults,
                                          state.queues, False)
        v_x, v_y, _ = _train_linear(shape, params, net, state.emp_mults,
                                    state.queues, False, use_lsa)
        v_served = _served(v_alpha, v_theta, net, state.queues)
        sigma = params.sigma0 / torch.sqrt(state.t.to(torch.float32) + 1.0)
        emp = update_multipliers(shape, state.emp_mults, net, v_served, v_x, v_y,
                                 use_lsa, sigma, params)

    trained = torch.sum(x) + torch.sum(y)
    new_state = SchedulerState(
        queues=queues, mults=mults, emp_mults=emp,
        t=state.t + 1,
        total_cost=state.total_cost + cost,
        total_trained=state.total_trained + trained,
        uploaded=state.uploaded + torch.sum(served, dim=1),
        rng=state.rng,
        het=state.het,
    )
    rec = SlotRecord(cost=cost, trained=trained,
                     q_backlog=torch.sum(queues.q), r_backlog=torch.sum(queues.r),
                     skew=skew_degree(shape, queues.omega, params))
    return new_state, rec, Decision(alpha=alpha, theta=theta, x=x, y=y, z=z)


def run(cfg: CocktailConfig | ShapeConfig, spec: AlgoSpec, n_slots: int,
        state: Optional[SchedulerState] = None,
        params: Optional[SliceParams] = None,
        device: DeviceLike = None) -> tuple[SchedulerState, SlotRecord]:
    """Run ``n_slots`` of the online algorithm; returns (final state, stacked
    per-slot records). Runs on CUDA unless ``device`` (or a given state or
    params) names another device."""
    if state is not None:
        dev = state.device
    elif params is not None and device is None:
        dev = params.device
    else:
        dev = resolve_device(device)
    shape, params = split_config(cfg, params, dev)
    if state is None:
        state = init_state(shape, params, seed=getattr(cfg, "seed", 0), device=dev)
    recs = []
    for _ in range(n_slots):  # torch has no scan: one step per slot
        state, rec, _ = step(shape, spec, state, params=params)
        recs.append(rec)
    return state, stack_slot_records(recs)


_pin_policy_ids()
