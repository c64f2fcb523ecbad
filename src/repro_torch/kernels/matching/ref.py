"""Plain PyTorch versions of the three greedy matchers.

Counterpart of ``repro.kernels.matching.ref``; these are the semantics the
CUDA kernels in ``csrc/greedy_matching.cu`` reproduce bit for bit. Each runs
on any device and takes optional leading batch axes (..., N, M): the batch
is solved in lock step, one argmax per problem per iteration.

Shared rules (those of ``jnp.argmax`` in the JAX refs):
  * the winner of each iteration is the first maximum in row-major flat
    order; a NaN beats every number, and the first NaN wins;
  * collection and pairing stop at the first non-positive (or NaN) best
    value; assignment's state cannot change after one, so it stops too.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def _marginal_penalty(n: torch.Tensor) -> torch.Tensor:
    """(n+1)log(n+1) - n log(n): marginal crowding penalty of adding the
    (n+1)-th CU to an EC under the optimal theta = 1/n time split."""
    n = n.to(torch.float32)
    logn = torch.where(n > 0, torch.log(torch.clamp(n, min=1.0)), torch.zeros_like(n))
    return (n + 1.0) * torch.log(n + 1.0) - n * logn


def penalty_table(n_cu: int, device: torch.device) -> torch.Tensor:
    """pen[c] = _marginal_penalty(c) for c = 0..n_cu. Both the plain version
    and the kernel read this one table, so their gains agree to the bit."""
    return _marginal_penalty(torch.arange(n_cu + 1, device=device))


def _batched(w: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    *lead, n, m = w.shape
    return w.reshape(-1, n, m), tuple(lead)


def greedy_collection_ref(logw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy solve of P1' (skew-aware collection).

    Repeatedly connect the (CU, EC) pair with the largest marginal gain
    ``logw[i,j] - pen[n_j]`` until no unassigned CU has a positive gain.
    Non-finite log-weights are treated as ``-1e30``.

    Args:
      logw: (..., N, M) log collection weights.
    Returns:
      alpha (..., N, M) in {0,1} and theta = alpha / n_j.
    """
    w, lead = _batched(logw)
    k, n, m = w.shape
    dev = w.device
    w = torch.where(torch.isfinite(w), w, torch.full_like(w, _NEG))
    pen = penalty_table(n, dev)
    rows = torch.arange(k, device=dev)
    assigned = torch.zeros((k, n), dtype=torch.bool, device=dev)
    count = torch.zeros((k, m), dtype=torch.long, device=dev)
    alpha = torch.zeros((k, n, m), device=dev)
    done = torch.zeros((k,), dtype=torch.bool, device=dev)
    neg = torch.full_like(w, _NEG)
    for _ in range(n):
        gain = w - pen[count][:, None, :]
        gain = torch.where(assigned[:, :, None], neg, gain).reshape(k, -1)
        flat = torch.argmax(gain, dim=1)
        best = gain[rows, flat]
        i, j = flat // m, flat % m
        take = (best > 0.0) & ~done
        # In place: the JAX ref rebuilds these arrays with .at[].set().
        assigned[rows, i] |= take
        count[rows, j] += take.long()
        alpha[rows, i, j] = torch.where(take, 1.0, alpha[rows, i, j])
        done |= ~take
        if bool(done.all()):
            break
    theta = alpha / torch.clamp(count[:, None, :].to(torch.float32), min=1.0)
    return alpha.reshape(*lead, n, m), theta.reshape(*lead, n, m)


def greedy_assignment_ref(w: torch.Tensor) -> torch.Tensor:
    """Plain P1: select disjoint (CU, EC) pairs by descending positive
    weight, at most M of them. w (..., N, M) -> alpha (..., N, M) in {0,1}."""
    w, lead = _batched(w)
    k, n, m = w.shape
    dev = w.device
    neg = torch.full_like(w, _NEG)
    w = torch.where(w > 0, w, neg)
    rows = torch.arange(k, device=dev)
    cu_free = torch.ones((k, n), dtype=torch.bool, device=dev)
    ec_free = torch.ones((k, m), dtype=torch.bool, device=dev)
    alpha = torch.zeros((k, n, m), device=dev)
    for _ in range(m):
        avail = cu_free[:, :, None] & ec_free[:, None, :]
        g = torch.where(avail, w, neg).reshape(k, -1)
        flat = torch.argmax(g, dim=1)
        i, j = flat // m, flat % m
        take = g[rows, flat] > 0.0
        cu_free[rows, i] &= ~take
        ec_free[rows, j] &= ~take
        alpha[rows, i, j] = torch.where(take, 1.0, alpha[rows, i, j])
        # Once no positive weight is left the state can no longer change.
        if not bool(take.any()):
            break
    return alpha.reshape(*lead, n, m)


def pairing_value_matrix(solo: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
    """The (..., M, M) value matrix the Thm.-2 greedy scans: off-diagonal
    entries carry the pair value, the diagonal the solo value."""
    m = solo.shape[-1]
    eye = torch.eye(m, dtype=pair.dtype, device=pair.device)
    return pair * (1.0 - eye) + torch.diag_embed(solo)


def greedy_pairing_values(w: torch.Tensor) -> torch.Tensor:
    """Thm.-2 greedy over a value matrix w (..., M, M) (diagonal = solo):
    repeatedly take the best entry among free x free ECs while it is
    positive. Returns the symmetric match matrix."""
    w, lead = _batched(w)
    k, m, _ = w.shape
    dev = w.device
    neg = torch.full_like(w, _NEG)
    rows = torch.arange(k, device=dev)
    free = torch.ones((k, m), dtype=torch.bool, device=dev)
    match = torch.zeros((k, m, m), device=dev)
    done = torch.zeros((k,), dtype=torch.bool, device=dev)
    for _ in range(m):
        avail = free[:, :, None] & free[:, None, :]
        g = torch.where(avail, w, neg).reshape(k, -1)
        flat = torch.argmax(g, dim=1)
        j, kk = flat // m, flat % m
        take = (g[rows, flat] > 0.0) & ~done
        free[rows, j] &= ~take
        free[rows, kk] &= ~take
        match[rows, j, kk] = torch.where(take, 1.0, match[rows, j, kk])
        match[rows, kk, j] = torch.where(take, 1.0, match[rows, kk, j])
        done |= ~take
        if bool(done.all()):
            break
    return match.reshape(*lead, m, m)


def greedy_pairing_ref(solo: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
    """Greedy solve of the Thm.-2 EC pairing: solo (..., M), pair (..., M, M)
    (symmetric, diagonal unused) -> match (..., M, M); match[j,j]=1 solo,
    match[j,k]=1 paired."""
    return greedy_pairing_values(pairing_value_matrix(solo, pair))


__all__ = ["greedy_collection_ref", "greedy_assignment_ref",
           "greedy_pairing_ref", "greedy_pairing_values",
           "pairing_value_matrix", "penalty_table", "_marginal_penalty"]
