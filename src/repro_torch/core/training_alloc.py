"""Per-slot training-allocation solvers for subproblem P2' (and linear P2).

Counterpart of ``repro.core.training_alloc``:

* ``solo_waterfill`` -- problem (20), capped water-filling (sort + cumsum).
* ``pair_allocate``  -- problem (21) for EC pairs: dual subgradient on the
  link and the two compute budgets with a closed-form coordinate-ascent
  primal per CU, then downscaling to exact feasibility.
* ``linear_solo`` / ``linear_pair`` -- plain-P2 fractional-knapsack fills
  (L-DS virtual step, NO-SLT).
* ``full_allocate`` -- the ECFull baseline (all EC pairs connected).

The JAX package vmaps the per-EC and per-pair solvers; here the batch is
written out: every vector argument is (..., N) and every scalar (...), so
the M ECs or the M(M-1)/2 EC pairs are one leading axis, and a fleet's K
slices fold into it (K M ECs, K M(M-1)/2 pairs in one call). Sorts are
stable, as ``jnp.sort``/``jnp.argsort`` are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_TINY = 1e-9


def _shift_right(a: torch.Tensor) -> torch.Tensor:
    """[0, a_0, ..., a_{n-2}] along the last axis."""
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def solo_waterfill(beta: torch.Tensor, r: torch.Tensor,
                   budget: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Problem (20). beta, r (..., N), budget (...) -> (x (..., N), value (...)).

    max sum_{i active} log(beta_i x_i)  s.t. sum x <= budget, 0 <= x_i <= r_i,
    active = {beta_i > 0, r_i > 0}; x_i = min(r_i, level).
    """
    n = beta.shape[-1]
    zero = torch.zeros_like(r)
    active = (beta > 0) & (r > _TINY)
    n_act = torch.sum(active, dim=-1, keepdim=True)
    r_act = torch.where(active, r, zero)
    fill = torch.minimum(torch.clamp(budget, min=0.0), torch.sum(r_act, dim=-1))

    s = torch.sort(torch.where(active, r, torch.full_like(r, float("inf"))),
                   dim=-1, stable=True).values  # ascending; inactive last
    s_fin = torch.where(torch.isfinite(s), s, zero)
    cs = _shift_right(torch.cumsum(s_fin, dim=-1))  # cs[k] = sum of k smallest
    k = torch.arange(n, device=r.device)
    denom = torch.clamp((n_act - k).to(r.dtype), min=1.0)
    w_k = (fill[..., None] - cs) / denom
    s_prev = _shift_right(s)
    valid = (k < n_act) & (w_k >= s_prev - 1e-6) & (w_k <= s + 1e-6)
    any_valid = torch.any(valid, dim=-1)
    k_star = torch.argmax(valid.to(torch.uint8), dim=-1, keepdim=True)  # first valid
    # When the budget covers every active queue the level is max(r), found at
    # k = n_act - 1 only if fill - cs[k] rounds to within 1e-6 of s[k]; that
    # holds or fails with the order in which sum and cumsum add. The JAX
    # version then trains nothing at that EC; the port falls back to max(r),
    # the level its own comment names, so that its answer does not hang on
    # rounding. The two packages therefore differ on such budgets whenever
    # the JAX version loses the level (ROADMAP.md, Queue 3).
    slack = fill >= torch.sum(r_act, dim=-1)
    fallback = torch.where(slack, torch.amax(r_act, dim=-1), torch.zeros_like(fill))
    level = torch.where(any_valid, torch.gather(w_k, -1, k_star)[..., 0], fallback)
    x = torch.where(active, torch.minimum(r, torch.clamp(level[..., None], min=0.0)), zero)
    pos = x > _TINY
    logs = torch.log(torch.clamp(beta * x, min=_TINY))
    value = torch.sum(torch.where(pos, logs, zero), dim=-1)
    return x, value


class PairAlloc(NamedTuple):
    x_j: torch.Tensor  # (..., N) trained at j from R[:, j]
    x_k: torch.Tensor  # (..., N) trained at k from R[:, k]
    y_jk: torch.Tensor  # (..., N) moved j -> k, trained at k
    y_kj: torch.Tensor  # (..., N) moved k -> j, trained at j
    value: torch.Tensor  # (...) objective


def _coord_ascent_pair(duals, b_j, g_kj, b_k, g_jk, r_j, r_k, sweeps):
    """Closed-form cyclic coordinate ascent for the per-CU subproblem given
    resource prices duals (..., 3) = (a, m_j, m_k). Each coordinate update of
    max log(b v + c) - p v with 0 <= v <= cap is clip(1/p - c/b, 0, cap)."""
    a, m_j, m_k = duals[..., 0:1], duals[..., 1:2], duals[..., 2:3]
    p_xj, p_ykj = m_j + _TINY, m_j + a + _TINY
    p_xk, p_yjk = m_k + _TINY, m_k + a + _TINY
    zeros = torch.zeros_like(r_j)

    def upd(w, p, c, cap):
        v = torch.where(w > 0, 1.0 / p - c / torch.clamp(w, min=_TINY), zeros)
        return torch.minimum(torch.clamp(v, min=0.0), torch.clamp(cap, min=0.0))

    x_j = y_kj = x_k = y_jk = zeros
    for _ in range(sweeps):
        x_j = upd(b_j, p_xj, g_kj * y_kj, r_j - y_jk)
        x_k = upd(b_k, p_xk, g_jk * y_jk, r_k - y_kj)
        y_kj = upd(g_kj, p_ykj, b_j * x_j, r_k - x_k)
        y_jk = upd(g_jk, p_yjk, b_k * x_k, r_j - x_j)
    return x_j, y_kj, x_k, y_jk


def _dual_steps(iters: int, device: torch.device) -> torch.Tensor:
    """Subgradient step sizes 0.5 / sqrt(t + 1), rounded as float32 math."""
    t = np.arange(iters, dtype=np.float32)
    return torch.as_tensor(np.float32(0.5) / np.sqrt(t + np.float32(1.0)), device=device)


def _log_value(u: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(u > _TINY, torch.log(torch.clamp(u, min=_TINY)),
                                 torch.zeros_like(u)), dim=-1)


def pair_allocate(b_j, g_kj, b_k, g_jk, r_j, r_k, budget_j, budget_k, link,
                  iters: int = 60, sweeps: int = 4) -> PairAlloc:
    """Problem (21) for EC pairs (j, k). Vector args (..., N), budgets and
    link (...)."""
    cap = torch.clamp(torch.stack([link, budget_j, budget_k], dim=-1), min=0.0)
    steps = _dual_steps(iters, r_j.device)
    duals = torch.full_like(cap, 0.01)
    for t in range(iters):
        x_j, y_kj, x_k, y_jk = _coord_ascent_pair(duals, b_j, g_kj, b_k, g_jk,
                                                  r_j, r_k, sweeps)
        use = torch.stack([torch.sum(y_jk + y_kj, dim=-1),
                           torch.sum(x_j + y_kj, dim=-1),
                           torch.sum(x_k + y_jk, dim=-1)], dim=-1)
        grad = (use - cap) / (cap + 1.0)
        duals = torch.clamp(duals + steps[t] * grad, min=0.0)
    x_j, y_kj, x_k, y_jk = _coord_ascent_pair(duals, b_j, g_kj, b_k, g_jk,
                                              r_j, r_k, sweeps)

    def scale(c, used):
        return torch.clamp(c / torch.clamp(used, min=_TINY), max=1.0)

    # Exact feasibility: scale queue caps per CU, then the global resources.
    s_j = scale(r_j, x_j + y_jk)
    x_j, y_jk = x_j * s_j, y_jk * s_j
    s_k = scale(r_k, x_k + y_kj)
    x_k, y_kj = x_k * s_k, y_kj * s_k
    s_fj = scale(cap[..., 1], torch.sum(x_j + y_kj, dim=-1))[..., None]
    x_j, y_kj = x_j * s_fj, y_kj * s_fj
    s_fk = scale(cap[..., 2], torch.sum(x_k + y_jk, dim=-1))[..., None]
    x_k, y_jk = x_k * s_fk, y_jk * s_fk
    s_l = scale(cap[..., 0], torch.sum(y_jk + y_kj, dim=-1))[..., None]
    y_jk, y_kj = y_jk * s_l, y_kj * s_l

    value = _log_value(b_j * x_j + g_kj * y_kj) + _log_value(b_k * x_k + g_jk * y_jk)
    return PairAlloc(x_j=x_j, x_k=x_k, y_jk=y_jk, y_kj=y_kj, value=value)


def linear_solo(beta: torch.Tensor, r: torch.Tensor,
                budget: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-P2 solo: max sum beta_i x_i, a fractional knapsack filled in
    descending beta order (stable on ties). Returns (x, value)."""
    zero = torch.zeros_like(r)
    active = (beta > 0) & (r > _TINY)
    key = torch.where(active, -beta, torch.full_like(beta, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    r_ord = torch.gather(torch.where(active, r, zero), -1, order)
    cs = _shift_right(torch.cumsum(r_ord, dim=-1))
    room = torch.clamp(budget, min=0.0)[..., None] - cs
    alloc_ord = torch.minimum(torch.clamp(room, min=0.0), r_ord)
    x = torch.zeros_like(r).scatter(-1, order, alloc_ord)
    x = torch.where(active, x, zero)
    return x, torch.sum(beta * x, dim=-1)


def linear_pair(b_j, g_kj, b_k, g_jk, r_j, r_k, budget_j, budget_k, link) -> PairAlloc:
    """Plain-P2 pair: greedy fractional fill by descending linear weight over
    the 4N (variable, CU) slots [x_j | y_kj | x_k | y_jk], respecting the
    queue caps, both compute budgets and the link.

    The fill is sequential: a Python loop of 4N steps, each a handful of
    small tensor ops over the leading (pair) axis.
    """
    n = b_j.shape[-1]
    lead = b_j.shape[:-1]
    dev = b_j.device
    weights = torch.cat([b_j, g_kj, b_k, g_jk], dim=-1).reshape(-1, 4 * n)
    p = weights.shape[0]
    order = torch.argsort(-weights, dim=-1, stable=True)
    # Everything a step needs, permuted into fill order once, so each step
    # reads one column. kind: 0 x_j, 1 y_kj, 2 x_k, 3 y_jk.
    kind, i = order // n, order % n
    w_ord = torch.gather(weights, -1, order)
    from_j = (kind == 0) | (kind == 3)  # draws on queue R[i, j]
    q_idx = torch.where(from_j, i, i + n)  # into [rem_rj | rem_rk]
    f_idx = torch.where((kind == 0) | (kind == 1), 0, 1)  # into [rem_fj, rem_fk]
    uses_link = ((kind == 1) | (kind == 3)).to(weights.dtype)
    l_fill = torch.where(uses_link > 0, 0.0, float("inf"))

    # Loop state, updated in place (the JAX fold rebuilds it every step).
    rem_r = torch.cat([r_j, r_k], dim=-1).reshape(p, 2 * n)
    rem_f = torch.clamp(torch.stack([budget_j, budget_k], dim=-1), min=0.0).reshape(p, 2)
    rem_d = torch.clamp(link, min=0.0).reshape(p, 1)
    out_ord = torch.empty((p, 4 * n), dtype=weights.dtype, device=dev)
    for s in range(4 * n):
        qi, fi = q_idx[:, s:s + 1], f_idx[:, s:s + 1]
        # l_fill is +inf where the variable does not use the link, else 0.
        l_rem = torch.maximum(rem_d, l_fill[:, s:s + 1])
        amt = torch.minimum(torch.minimum(torch.gather(rem_r, 1, qi),
                                          torch.gather(rem_f, 1, fi)), l_rem)
        amt = torch.clamp(torch.where(w_ord[:, s:s + 1] > 0, amt, 0.0), min=0.0)
        rem_r.scatter_add_(1, qi, -amt)
        rem_f.scatter_add_(1, fi, -amt)
        rem_d -= amt * uses_link[:, s:s + 1]
        out_ord[:, s:s + 1] = amt
    out = torch.zeros_like(out_ord).scatter(1, order, out_ord).reshape(*lead, 4 * n)
    x_j, y_kj, x_k, y_jk = out[..., :n], out[..., n:2 * n], out[..., 2 * n:3 * n], out[..., 3 * n:]
    value = torch.sum(b_j * x_j + g_kj * y_kj + b_k * x_k + g_jk * y_jk, dim=-1)
    return PairAlloc(x_j=x_j, x_k=x_k, y_jk=y_jk, y_kj=y_kj, value=value)


def full_allocate(beta, gamma, r, budgets, links, iters: int = 40, sweeps: int = 2):
    """ECFull baseline: joint allocation with all EC pairs connected.
    beta (..., N, M), gamma (..., N, M, M) weight of y[i, j, k], r (..., N, M),
    budgets (..., M), links (..., M, M); leading axes are slices solved
    together. Returns (x (..., N, M), y (..., N, M, M), value (...))."""
    m = beta.shape[-1]
    dev = beta.device
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    zero_nm = torch.zeros_like(beta)
    zero_n = torch.zeros_like(beta[..., 0])

    def primal(m_dual, a_dual):
        p_x = m_dual[..., None, :] + _TINY  # price of x[i, j]
        p_y = m_dual[..., None, None, :] + a_dual[..., None, :, :] + _TINY  # of y[i, j, k]
        x, y = zero_nm, torch.zeros_like(gamma)
        for _ in range(sweeps):
            u_from_y = torch.einsum("...ijk,...ijk->...ik", gamma, y)
            cap_x = torch.clamp(r - torch.sum(y, dim=-1), min=0.0)
            v = 1.0 / p_x - u_from_y / torch.clamp(beta, min=_TINY)
            x = torch.where(beta > 0, torch.minimum(torch.clamp(v, min=0.0), cap_x), zero_nm)
            y = y.clone()  # updated in place pair by pair (JAX: .at[].set)
            for jk in range(m * m):
                j, k = jk // m, jk % m
                if j == k:
                    continue  # y[..., j, j] is never used and stays 0
                u_k = beta[..., :, k] * x[..., :, k] + torch.einsum(
                    "...ij,...ij->...i", gamma[..., :, :, k], y[..., :, :, k])
                c = u_k - gamma[..., :, j, k] * y[..., :, j, k]
                cap = torch.clamp(r[..., :, j] - x[..., :, j]
                                  - (torch.sum(y[..., :, j, :], dim=-1) - y[..., :, j, k]),
                                  min=0.0)
                g = gamma[..., :, j, k]
                vv = 1.0 / p_y[..., :, j, k] - c / torch.clamp(g, min=_TINY)
                vv = torch.minimum(torch.clamp(vv, min=0.0), cap)
                y[..., :, j, k] = torch.where(g > 0, vv, zero_n)
        return x, y

    def symmetric_flow(y):
        flow = torch.einsum("...ijk->...jk", y)
        return flow + flow.transpose(-1, -2)

    steps = _dual_steps(iters, dev)
    m_dual = torch.full_like(budgets, 0.01)
    a_dual = torch.full_like(links, 0.01)
    for t in range(iters):
        x, y = primal(m_dual, a_dual)
        trained_at = torch.sum(x, dim=-2) + torch.einsum("...ijk->...k", y)
        g_m = (trained_at - budgets) / (budgets + 1.0)
        g_a = torch.where(eye, 0.0, (symmetric_flow(y) - links) / (links + 1.0))
        m_dual = torch.clamp(m_dual + steps[t] * g_m, min=0.0)
        a_dual = torch.clamp(a_dual + steps[t] * g_a, min=0.0)
    x, y = primal(m_dual, a_dual)

    # Feasibility: queue caps, then compute, then links (downscaling only).
    dep = x + torch.sum(y, dim=-1)
    s_q = torch.clamp(r / torch.clamp(dep, min=_TINY), max=1.0)
    x = x * s_q
    y = y * s_q[..., None]
    trained_at = torch.sum(x, dim=-2) + torch.einsum("...ijk->...k", y)
    s_f = torch.clamp(budgets / torch.clamp(trained_at, min=_TINY), max=1.0)
    x = x * s_f[..., None, :]
    y = y * s_f[..., None, None, :]
    s_l = torch.clamp(links / torch.clamp(symmetric_flow(y), min=_TINY), max=1.0)
    s_l = torch.where(eye, 1.0, s_l)
    y = y * s_l[..., None, :, :]

    u = beta * x + torch.einsum("...ijk,...ijk->...ik", gamma, y)
    return x, y, _log_value(u.flatten(-2))
