"""DataSche and Learning-aid DataSche online scheduling (paper Sec. III).

Counterpart of ``repro.core.datasche``. Each slot:

  1. observe the network state S(t) (or sample it, keyed by the state's seed and t),
  2. solve the collection subproblem  -> alpha, theta      (P1' / P1 / full)
  3. solve the training subproblem    -> x, y, z           (P2' / linear / ...)
  4. execute: update queues Q, R, cumulative Omega and the framework cost,
  5. SGD-update the Lagrange multipliers; L-DS also updates empirical
     multipliers Theta' from virtual plain-P1/P2 decisions with a diminishing
     step and schedules with Theta~ = Theta + Theta' - pi.

The slot is written once, over a leading slice axis: ``stacked_step`` runs
K slices stacked on axis 0 (a fleet, ``core.fleet``), and ``step`` runs one
slice by adding K = 1 and taking it away again. Every function below that
takes scheduler tensors indexes its entity axes from the right, so it
serves both.

Policies come from two indexed tables, registered in the same order as in
the JAX package (collection: skew=0, plain=1, cufull=2; training: skew=0,
linear=1, solo=2, ecfull=3), and are chosen by an ``AlgoSpec``: statically
(the spec names the policies) or per slice (``SWITCHED`` /
``SWITCHED_NOAID``: the ``SliceParams`` policy leaves, filled by
``with_policy``, name them). ``exact=True`` swaps the greedy matchers for
the numpy/networkx oracles, one slice at a time. The three greedy matchers
go through ``kernels.matching.ops``: CUDA kernels on the card, the plain
PyTorch versions on the CPU; each call solves all the slices it is given
in one launch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..kernels.matching import ops as matching_ops
from . import training_alloc
from .network import framework_cost, sample_network_state
from .types import (MASKED_WEIGHT, CocktailConfig, Decision, DeviceLike,
                    Multipliers, NetworkState, QueueState, SchedulerState,
                    ShapeConfig, SliceParams, entity_masks, init_state,
                    mask_pairs, per_slice, resolve_device, split_config,
                    tree_map, unstack)

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

    @property
    def fns(self) -> tuple:
        """Implementations in id order."""
        return tuple(self._fns)

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
    """Which variant of the scheduler to run (paper Sec. IV baselines).
    ``collection`` / ``training`` name table entries; ``"switch"`` leaves
    the choice to the ``SliceParams`` policy leaves (``SWITCHED``)."""

    name: str = "ds"
    collection: str = "skew"  # skew | plain | cufull | switch
    training: str = "skew"  # skew | linear | solo | ecfull | switch
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

# Per-slice dispatch: each slice runs the policies its SliceParams leaves
# name (with_policy), with the JAX package's semantics: use_lsa is a {0,1}
# gate on phi / lam and on their update (spec.use_lsa is ignored);
# SWITCHED runs the L-DS virtual update for the slices whose learning_aid
# leaf is set and keeps the others' Theta' frozen; SWITCHED_NOAID has no
# virtual update and ignores that leaf.
SWITCHED = AlgoSpec(name="switched", collection=_SWITCH, training=_SWITCH,
                    learning_aid=True)
SWITCHED_NOAID = AlgoSpec(name="switched-noaid", collection=_SWITCH,
                          training=_SWITCH)

ALL_SPECS = {s.name: s for s in
             [DS, DS_EXACT, LDS, NO_SDC, NO_SLT, NO_LSA, GREEDY, EC_FULL, EC_SELF, CU_FULL]}


def with_policy(params: SliceParams, spec: AlgoSpec) -> SliceParams:
    """Fill the policy leaves of one slice's ``params`` from a static
    ``spec``, so that the slice can run under ``SWITCHED`` dispatch."""
    if spec.exact:
        raise ValueError(f"spec {spec.name!r} is exact (host-side oracles); "
                         "it has no branch-free dispatch path")
    if spec.switched:
        raise ValueError("with_policy needs a concrete spec, not SWITCHED")
    dev = params.device
    return params._replace(
        collect_id=torch.tensor(COLLECTION_POLICIES.index(spec.collection),
                                dtype=torch.int32, device=dev),
        train_id=torch.tensor(TRAINING_POLICIES.index(spec.training),
                              dtype=torch.int32, device=dev),
        use_lsa=torch.tensor(1.0 if spec.use_lsa else 0.0, device=dev),
        learning_aid=torch.tensor(1.0 if spec.learning_aid else 0.0, device=dev),
    )


def _require_policy_leaves(params: SliceParams) -> None:
    missing = [f for f in ("collect_id", "train_id", "use_lsa", "learning_aid")
               if getattr(params, f) is None]
    if missing:
        raise TypeError(
            f"SWITCHED dispatch needs the SliceParams policy leaves, but "
            f"{missing} are unset; fill them with datasche.with_policy(params, "
            f"spec) or build the fleet via FleetEngine.from_jobs")


class PolicyPlan(NamedTuple):
    """The policy ids of each slice of a switched step, on the host: the
    step groups slices by them without reading a device tensor."""

    collect: tuple[int, ...]  # COLLECTION_POLICIES id per slice
    train: tuple[int, ...]  # TRAINING_POLICIES id per slice
    aid: tuple[bool, ...]  # learning-aid leaf set, per slice


def policy_plan(params: SliceParams) -> PolicyPlan:
    """The ``PolicyPlan`` of (stacked or single-slice) ``params``, read
    from its policy leaves in one copy to the host."""
    _require_policy_leaves(params)
    leaves = torch.stack([params.collect_id.reshape(-1).to(torch.float32),
                          params.train_id.reshape(-1).to(torch.float32),
                          params.learning_aid.reshape(-1).to(torch.float32)]).tolist()
    return PolicyPlan(collect=tuple(int(v) for v in leaves[0]),
                      train=tuple(int(v) for v in leaves[1]),
                      aid=tuple(v > 0 for v in leaves[2]))


# --------------------------------------------------------------------------
# Weights (the per-slot dual prices entering P1'/P2')
# --------------------------------------------------------------------------

def collection_weights(net: NetworkState, mults: Multipliers,
                       cu_mask: Optional[torch.Tensor] = None,
                       ec_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w_ij = d_ij (mu_i - eta_ij - c_ij); entries of masked entities are 0."""
    w = net.d * (mults.mu[..., :, None] - mults.eta - net.c)
    if cu_mask is not None or ec_mask is not None:
        cu = cu_mask if cu_mask is not None else torch.ones_like(w[..., :, 0])
        ec = ec_mask if ec_mask is not None else torch.ones_like(w[..., 0, :])
        w = mask_pairs(w, cu, ec, fill=0.0)
    return w


def training_weights(cfg: CocktailConfig | ShapeConfig, net: NetworkState,
                     mults: Multipliers, use_lsa: bool | torch.Tensor,
                     params: Optional[SliceParams] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(beta (..., N, M), gamma (..., N, M, M)): beta[i,j] weighs x[i,j];
    gamma[i,j,k] = beta[i,k] + eta[i,j] - eta[i,k] - e[j,k] weighs y[i,j,k].
    Entries of masked entities are ``MASKED_WEIGHT``. ``use_lsa`` is a bool
    or, per slice, a {0,1} gate tensor that multiplies phi and lam (equal
    to both static choices: x * 1 == x, finite x * 0 == 0)."""
    _, params = split_config(cfg, params, net.d.device)
    if isinstance(use_lsa, bool):
        phi = mults.phi if use_lsa else torch.zeros_like(mults.phi)
        lam = mults.lam if use_lsa else torch.zeros_like(mults.lam)
    else:
        gate = per_slice(use_lsa.to(torch.float32), 2)
        phi, lam = mults.phi * gate, mults.lam * gate
    d_hi, d_lo = params.delta_hi, params.delta_lo
    common = torch.sum(lam * d_hi[..., :, None] - phi * d_lo[..., :, None], dim=-2)  # (..., M)
    beta = -net.p[..., None, :] + mults.eta - lam + phi + common[..., None, :]
    gamma = (beta[..., :, None, :] + mults.eta[..., :, :, None]
             - mults.eta[..., :, None, :] - net.e[..., None, :, :])
    cu, ec = entity_masks(params)
    beta = mask_pairs(beta, cu, ec)
    keep = (cu[..., :, None, None] * ec[..., None, :, None] * ec[..., None, None, :]) > 0
    gamma = torch.where(keep, gamma, torch.full_like(gamma, _NEG))
    return beta, gamma


def _one_slice(a: torch.Tensor, rank: int) -> torch.Tensor:
    """``a`` without its leading slice axes, which must hold one slice: the
    exact oracles run on the host, one slice at a time."""
    if a.numel() != math.prod(a.shape[a.dim() - rank:]):
        raise ValueError("exact (host-side oracle) specs run one slice at a time")
    return a.reshape(a.shape[a.dim() - rank:])


# --------------------------------------------------------------------------
# Collection policies: (shape, params, net, mults, queues, exact) -> (alpha, theta),
# each (..., N, M) over the leading slice axes of their arguments.
# --------------------------------------------------------------------------

@COLLECTION_POLICIES.register("skew")
def _collect_skew(shape, params, net, mults, queues, exact):
    cu, ec = entity_masks(params)
    w = collection_weights(net, mults, cu, ec)
    logw = torch.where(w > 0, torch.log(torch.clamp(w, min=_TINY)),
                       torch.full_like(w, float("-inf")))
    if exact:
        from . import oracle
        alpha, theta = oracle.exact_collection(_one_slice(logw, 2).cpu().numpy())
        return (torch.as_tensor(alpha, device=w.device).reshape(w.shape),
                torch.as_tensor(theta, device=w.device).reshape(w.shape))
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
    n_real = torch.clamp(torch.sum(cu, dim=-1), min=1.0)
    alpha = cu[..., :, None] * ec[..., None, :]
    return alpha, alpha / per_slice(n_real, 2)


# --------------------------------------------------------------------------
# Training policies: (shape, params, net, mults, queues, exact, use_lsa) -> (x, y, z)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _pair_index(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """EC pairs j < k in row-major order (that of ``np.triu_indices``);
    cached per (M, device), never written to."""
    pj, pk = torch.triu_indices(m, m, offset=1, device=device)
    return pj, pk


def _compose_from_match(match, x_solo, pairs, pa, n, m):
    """Assemble (x, y, z) from the matching and the pre-solved allocations.
    Each EC is in at most one matched pair, so every entry receives at most
    one nonzero term and the scatter below equals the JAX one-hot sums."""
    pj, pk = pairs
    sel = match[..., pj, pk][..., None]  # (..., P, 1): 1 if pair matched
    x = x_solo * torch.diagonal(match, dim1=-2, dim2=-1)[..., None, :]
    x = (x.index_add(-1, pj, (pa.x_j * sel).transpose(-1, -2))
         .index_add(-1, pk, (pa.x_k * sel).transpose(-1, -2)))
    y = x.new_zeros((*x.shape[:-2], n, m, m))
    y[..., pj, pk] = (pa.y_jk * sel).transpose(-1, -2)
    y[..., pk, pj] = (pa.y_kj * sel).transpose(-1, -2)
    z = match * (1.0 - torch.eye(m, dtype=match.dtype, device=match.device))
    return x, y, z


def _train_generic(shape, params, net, mults, queues, exact, use_lsa, solo_fn, pair_fn):
    beta, gamma = training_weights(shape, net, mults, use_lsa, params)
    budgets = net.f / per_slice(params.rho, 1)
    n, m = shape.n_cu, shape.n_ec
    r = queues.r

    def per_ec(a):  # (..., N, M) -> (..., M, N): one solver row per EC
        return a.transpose(-1, -2)

    x_solo, val_solo = solo_fn(per_ec(beta), per_ec(r), budgets)  # K M ECs in one call
    x_solo = per_ec(x_solo)

    # The K M(M-1)/2 EC pairs of all slices are one leading (slice, pair) axis.
    pj, pk = _pair_index(m, beta.device)
    pa = pair_fn(per_ec(beta[..., pj]), per_ec(gamma[..., pk, pj]),
                 per_ec(beta[..., pk]), per_ec(gamma[..., pj, pk]),
                 per_ec(r[..., pj]), per_ec(r[..., pk]),
                 budgets[..., pj], budgets[..., pk], net.cap_d[..., pj, pk])
    pair_vals = beta.new_zeros((*beta.shape[:-2], m, m))
    pair_vals[..., pj, pk] = pa.value
    pair_vals = pair_vals + pair_vals.transpose(-1, -2)

    _, ec = entity_masks(params)
    if exact:
        from . import oracle
        val_solo = torch.where(ec > 0, val_solo, torch.full_like(val_solo, _NEG))
        pair_vals = mask_pairs(pair_vals, ec, ec)
        match = oracle.exact_pairing(_one_slice(val_solo, 1).cpu().numpy(),
                                     _one_slice(pair_vals, 2).cpu().numpy())
        match = torch.as_tensor(match, device=beta.device).reshape(pair_vals.shape)
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
    x, _ = training_alloc.solo_waterfill(beta.transpose(-1, -2), queues.r.transpose(-1, -2),
                                         net.f / per_slice(params.rho, 1))
    m = shape.n_ec
    return (x.transpose(-1, -2), beta.new_zeros((*beta.shape, m)),
            beta.new_zeros((*beta.shape[:-2], m, m)))


@TRAINING_POLICIES.register("ecfull")
def _train_ecfull(shape, params, net, mults, queues, exact, use_lsa):
    beta, gamma = training_weights(shape, net, mults, use_lsa, params)
    x, y, _ = training_alloc.full_allocate(beta, gamma, queues.r,
                                           net.f / per_slice(params.rho, 1), net.cap_d)
    _, ec = entity_masks(params)
    z = 1.0 - torch.eye(shape.n_ec, device=beta.device)
    return x, y, z * (ec[..., :, None] * ec[..., None, :])


def _pin_policy_ids() -> None:
    # The ids are part of the interface shared with the JAX package, and
    # SliceParams.from_config defaults the leaves to DS's (ids 0 and 0).
    if (COLLECTION_POLICIES.names != ("skew", "plain", "cufull")
            or TRAINING_POLICIES.names != ("skew", "linear", "solo", "ecfull")):
        raise RuntimeError("policy table order drifted from the JAX package's")


# --------------------------------------------------------------------------
# Dynamics (queues + multiplier SGD)
# --------------------------------------------------------------------------

def _served(alpha, theta, net, queues):
    """Samples actually moved CU->EC: alpha*theta*d, capped by the Q backlog."""
    req = alpha * theta * net.d
    tot = torch.sum(req, dim=-1)
    scale = torch.clamp(queues.q / torch.clamp(tot, min=_TINY), max=1.0)
    return req * scale[..., None]


def update_multipliers(cfg: CocktailConfig | ShapeConfig, mults: Multipliers,
                       net: NetworkState, served: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, use_lsa: bool | torch.Tensor,
                       step: torch.Tensor | float,
                       params: Optional[SliceParams] = None) -> Multipliers:
    """One SGD step of the multipliers; ``step`` is a scalar or one per
    slice, ``use_lsa`` a bool or a per-slice {0,1} gate (where it is 0,
    phi and lam keep their values)."""
    _, params = split_config(cfg, params, x.device)
    dep_r = x + torch.sum(y, dim=-1)  # leaves queue R[i,j]
    trained_at = x + torch.sum(y, dim=-2)  # trained at EC k
    tot_j = torch.sum(trained_at, dim=-2)
    d_hi, d_lo = params.delta_hi, params.delta_lo
    cu, ec = entity_masks(params)
    link = cu[..., :, None] * ec[..., None, :]
    step_n, step_nm = per_slice(step, 1), per_slice(step, 2)
    mu = torch.clamp(mults.mu + step_n * (net.arrivals - torch.sum(served, dim=-1)),
                     min=0.0) * cu
    eta = torch.clamp(mults.eta + step_nm * (served - dep_r), min=0.0) * link
    if use_lsa is False:
        phi, lam = mults.phi, mults.lam
    else:
        phi = torch.clamp(mults.phi + step_nm * (d_lo[..., :, None] * tot_j[..., None, :]
                                                 - trained_at), min=0.0) * link
        lam = torch.clamp(mults.lam + step_nm * (trained_at
                                                 - d_hi[..., :, None] * tot_j[..., None, :]),
                          min=0.0) * link
        if use_lsa is not True:
            gate = per_slice(use_lsa, 2) > 0
            phi = torch.where(gate, phi, mults.phi)
            lam = torch.where(gate, lam, mults.lam)
    return Multipliers(mu=mu, eta=eta, phi=phi, lam=lam)


def apply_decision(cfg: CocktailConfig | ShapeConfig, queues: QueueState,
                   net: NetworkState, served: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> QueueState:
    dep_r = x + torch.sum(y, dim=-1)
    trained_at = x + torch.sum(y, dim=-2)
    q = torch.clamp(queues.q - torch.sum(served, dim=-1), min=0.0) + net.arrivals
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
    """max_{i,j} | Omega_ij / sum_l Omega_lj - zeta_i / sum zeta | (eq. 9 LHS),
    one per leading slice index."""
    if params is None and isinstance(cfg, SliceParams):
        params = cfg
    else:
        _, params = split_config(cfg, params, omega.device)
    tot = torch.sum(omega, dim=-2, keepdim=True)
    frac = omega / torch.clamp(tot, min=_TINY)
    dev = torch.abs(frac - params.proportions[..., :, None])
    return torch.amax(torch.where(tot > _TINY, dev, torch.zeros_like(dev)), dim=(-2, -1))


def _pi(params: SliceParams) -> torch.Tensor:
    """L-DS distance parameter pi = sqrt(eps) * log^2(eps), per slice."""
    return torch.sqrt(params.eps) * torch.log(params.eps) ** 2


def _affine(a: Multipliers, b: Multipliers, shift: torch.Tensor) -> Multipliers:
    return Multipliers(*[x + y - per_slice(shift, x.dim() - shift.dim())
                         for x, y in zip(a, b)])


def slot_network(cfg: CocktailConfig | ShapeConfig, state: SchedulerState,
                 params: Optional[SliceParams] = None) -> NetworkState:
    """The network state ``step`` samples for ``state`` when none is given:
    a pure function of the state (run seed, slot ``t``, heterogeneity); for
    a stacked state, of each slice's."""
    shape, params = split_config(cfg, params, state.device)
    return sample_network_state(state.rng, shape, state.t, params, het=state.het)


@functools.lru_cache(maxsize=256)
def _slice_index(idx: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The slice indices ``idx`` as a tensor on ``device``; cached, so a
    fleet copies each group's indices to the card once."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


def _take(tree, index: torch.Tensor):
    return tree_map(lambda leaf: None if leaf is None else leaf.index_select(0, index), tree)


def _by_group(ids: Sequence[int], args: tuple, run_group: Callable) -> tuple:
    """``run_group(id, group_args)`` once for each id in ``ids`` (one id per
    slice, along axis 0 of every tensor in ``args``), on the slices that
    have it; the outputs are put back in slice order.

    This is how the port dispatches SWITCHED: the JAX package vmaps
    ``lax.switch``, which computes every policy for every slice and
    selects. Grouping computes each slice's own policy only, so the slices
    of a group share one matcher launch and no slice pays for a policy it
    does not run (``full_allocate`` above all); the ids are host values, so
    choosing the groups reads nothing from the device."""
    groups: dict[int, list[int]] = {}
    for k, pid in enumerate(ids):
        groups.setdefault(pid, []).append(k)
    if len(groups) == 1:
        return run_group(ids[0], args)
    device = args[0].zeta.device
    outs = None
    for pid in sorted(groups):
        index = _slice_index(tuple(groups[pid]), device)
        part = run_group(pid, tuple(_take(a, index) for a in args))
        if outs is None:
            outs = tuple(p.new_empty((len(ids), *p.shape[1:])) for p in part)
        for out, p in zip(outs, part):
            out.index_copy_(0, index, p)
    return outs


def _virtual_update(shape, params, net, emp, queues, use_lsa, t) -> Multipliers:
    """L-DS: decisions of plain P1 / linear P2 under the empirical
    multipliers Theta' update Theta' (step sigma0 / sqrt(t + 1)), never
    the real queues."""
    v_alpha, v_theta = _collect_plain(shape, params, net, emp, queues, False)
    v_x, v_y, _ = _train_linear(shape, params, net, emp, queues, False, use_lsa)
    v_served = _served(v_alpha, v_theta, net, queues)
    sigma = params.sigma0 / torch.sqrt(t.to(torch.float32) + 1.0)
    return update_multipliers(shape, emp, net, v_served, v_x, v_y, use_lsa, sigma, params)


def stacked_step(shape: ShapeConfig, spec: AlgoSpec, state: SchedulerState,
                 params: SliceParams, net: Optional[NetworkState] = None,
                 plan: Optional[PolicyPlan] = None
                 ) -> tuple[SchedulerState, SlotRecord, Decision]:
    """One slot of K slices stacked on axis 0 of ``state``, ``params`` and
    ``net`` (all on one device): the slot's body, written once. Each
    matcher is called once for all the slices that run it.

    ``net`` injects the network states (else ``slot_network``). Under a
    switched spec each slice runs the policies its leaves name, grouped by
    ``plan`` (read from the leaves when None)."""
    if net is None:
        net = slot_network(shape, state, params)
    queues = state.queues
    if spec.switched:
        if plan is None:
            plan = policy_plan(params)
        use_lsa: bool | torch.Tensor = params.use_lsa.to(torch.float32)
        if spec.learning_aid:
            # Same affine as _affine, selected per slice, so that a slice
            # with the aid computes exactly what static L-DS does.
            aid = params.learning_aid > 0
            pi = _pi(params)
            eff = Multipliers(*[torch.where(per_slice(aid, a.dim() - 1),
                                            a + e - per_slice(pi, a.dim() - 1), a)
                                for a, e in zip(state.mults, state.emp_mults)])
        else:
            eff = state.mults  # SWITCHED_NOAID: the aid leaf is ignored
        args = (params, net, eff, queues, use_lsa)
        alpha, theta = _by_group(plan.collect, args, lambda pid, a: COLLECTION_POLICIES.fns[pid](
            shape, a[0], a[1], a[2], a[3], False))
        x, y, z = _by_group(plan.train, args, lambda pid, a: TRAINING_POLICIES.fns[pid](
            shape, a[0], a[1], a[2], a[3], False, a[4]))
    else:
        use_lsa = spec.use_lsa
        eff = _affine(state.mults, state.emp_mults, _pi(params)) if spec.learning_aid \
            else state.mults
        alpha, theta = COLLECTION_POLICIES[spec.collection](shape, params, net, eff, queues,
                                                            spec.exact)
        x, y, z = TRAINING_POLICIES[spec.training](shape, params, net, eff, queues,
                                                   spec.exact, use_lsa)

    served = _served(alpha, theta, net, queues)
    cost = framework_cost(net, served, x, y)
    new_queues = apply_decision(shape, queues, net, served, x, y)
    mults = update_multipliers(shape, state.mults, net, served, x, y,
                               use_lsa, params.eps, params)

    emp = state.emp_mults
    if spec.learning_aid and not spec.switched:
        emp = _virtual_update(shape, params, net, emp, queues, use_lsa, state.t)
    elif spec.learning_aid and any(plan.aid):
        # Only the slices with the aid run the virtual update; the others
        # keep Theta' frozen.
        if all(plan.aid):
            emp = _virtual_update(shape, params, net, emp, queues, use_lsa, state.t)
        else:
            index = _slice_index(tuple(k for k, a in enumerate(plan.aid) if a), emp.mu.device)
            sub = _virtual_update(shape, *(_take(a, index) for a in (
                params, net, emp, queues, use_lsa, state.t)))
            emp = Multipliers(*[old.index_copy(0, index, new) for old, new in zip(emp, sub)])

    trained = torch.sum(x, dim=(-2, -1)) + torch.sum(y, dim=(-3, -2, -1))
    new_state = SchedulerState(
        queues=new_queues, mults=mults, emp_mults=emp,
        t=state.t + 1,
        total_cost=state.total_cost + cost,
        total_trained=state.total_trained + trained,
        uploaded=state.uploaded + torch.sum(served, dim=-1),
        rng=state.rng,
        het=state.het,
    )
    rec = SlotRecord(cost=cost, trained=trained,
                     q_backlog=torch.sum(new_queues.q, dim=-1),
                     r_backlog=torch.sum(new_queues.r, dim=(-2, -1)),
                     skew=skew_degree(shape, new_queues.omega, params))
    return new_state, rec, Decision(alpha=alpha, theta=theta, x=x, y=y, z=z)


def _add_slice_axis(tree):
    return tree_map(lambda leaf: None if leaf is None else leaf[None], tree)


def _plan_for(spec: AlgoSpec, params: SliceParams) -> Optional[PolicyPlan]:
    return policy_plan(params) if spec.switched else None


def step(cfg: CocktailConfig | ShapeConfig, spec: AlgoSpec, state: SchedulerState,
         net: Optional[NetworkState] = None,
         params: Optional[SliceParams] = None
         ) -> tuple[SchedulerState, SlotRecord, Decision]:
    """Run one slot of one slice on the state's device. ``net`` injects the
    network state; otherwise it is ``slot_network(cfg, state)``, keyed by
    the run seed ``state.rng`` and the slot ``state.t``. Under a switched
    spec the policy leaves of ``params`` are read once per call."""
    shape, params = split_config(cfg, params, state.device)
    new_state, rec, dec = stacked_step(
        shape, spec, _add_slice_axis(state), _add_slice_axis(params),
        None if net is None else _add_slice_axis(net), _plan_for(spec, params))
    return unstack(new_state, 0), unstack(rec, 0), unstack(dec, 0)


def stacked_run(shape: ShapeConfig, spec: AlgoSpec, n_slots: int, state: SchedulerState,
                params: SliceParams, plan: Optional[PolicyPlan] = None
                ) -> tuple[SchedulerState, SlotRecord]:
    """``n_slots`` slots of K stacked slices; returns (final state, records
    of shape (T, K), time-major)."""
    if plan is None:
        plan = _plan_for(spec, params)
    recs = []
    for _ in range(n_slots):  # torch has no scan: one step per slot
        state, rec, _ = stacked_step(shape, spec, state, params, plan=plan)
        recs.append(rec)
    return state, stack_slot_records(recs)


def run(cfg: CocktailConfig | ShapeConfig, spec: AlgoSpec, n_slots: int,
        state: Optional[SchedulerState] = None,
        params: Optional[SliceParams] = None,
        device: DeviceLike = None) -> tuple[SchedulerState, SlotRecord]:
    """Run ``n_slots`` of the online algorithm on one slice; returns (final
    state, stacked per-slot records). Runs on CUDA unless ``device`` (or a
    given state or params) names another device."""
    if state is not None:
        dev = state.device
    elif params is not None and device is None:
        dev = params.device
    else:
        dev = resolve_device(device)
    shape, params = split_config(cfg, params, dev)
    if state is None:
        state = init_state(shape, params, seed=getattr(cfg, "seed", 0), device=dev)
    state, recs = stacked_run(shape, spec, n_slots, _add_slice_axis(state),
                              _add_slice_axis(params), _plan_for(spec, params))
    return unstack(state, 0), tree_map(lambda leaf: leaf[:, 0], recs)


_pin_policy_ids()
