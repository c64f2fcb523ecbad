"""Exact matching oracles (numpy + networkx, host-side).

These implement the paper's Thm.-1 / Thm.-2 graph constructions literally and
solve them with networkx's maximum-weight matching (blossom) — the same
tooling the paper's testbed used. They are the ground truth the greedy
matchers in ``repro_torch.kernels.matching`` are tested against, and back
the ``exact`` scheduler mode. A copy of ``repro.core.oracle``, so that the
PyTorch package depends on nothing of the JAX package.
"""
from __future__ import annotations

import math

import networkx as nx
import numpy as np


def exact_collection(logw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Optimal P1' via max-weight matching on the Thm.-1 bipartite graph.

    Virtual EC copies (j, n) carry edge weight
        omega^n_ij = logw[i,j] - [n log n - (n-1) log(n-1)]
    so the total matched weight equals the P1' objective (marginal-gain
    telescoping). Returns (alpha, theta).

    Edges with non-positive weight are pruned: blossom with
    ``maxcardinality=False`` never includes them (dropping such an edge never
    lowers the matched weight), and since the crowding penalty grows with n
    the inner loop can stop at the first non-positive copy — without this the
    graph is O(N^2 M) edges and exact mode crawls at simulation scale.
    """
    n_cu, n_ec = logw.shape
    g = nx.Graph()
    for i in range(n_cu):
        for j in range(n_ec):
            if not np.isfinite(logw[i, j]):
                continue
            for n in range(1, n_cu + 1):
                pen = n * math.log(n) - (n - 1) * (math.log(n - 1) if n > 1 else 0.0)
                wt = float(logw[i, j]) - pen
                if wt <= 0.0:
                    break  # pen is increasing in n: all later copies are <= 0 too
                g.add_edge(("cu", i), ("ec", j, n), weight=wt)
    match = nx.max_weight_matching(g, maxcardinality=False)
    alpha = np.zeros((n_cu, n_ec), np.float32)
    for a, b in match:
        if a[0] == "ec":
            a, b = b, a
        alpha[a[1], b[1]] = 1.0
    count = alpha.sum(axis=0)
    theta = alpha / np.maximum(count[None, :], 1.0)
    return alpha, theta


def collection_objective(logw: np.ndarray, alpha: np.ndarray) -> float:
    """P1' objective for a given connection pattern (theta = 1/n_j optimal)."""
    total = 0.0
    for j in range(logw.shape[1]):
        idx = np.nonzero(alpha[:, j])[0]
        n = len(idx)
        if n == 0:
            continue
        total += float(np.sum(logw[idx, j])) - n * math.log(n)
    return total


def exact_pairing(solo: np.ndarray, pair: np.ndarray) -> np.ndarray:
    """Optimal Thm.-2 matching: nodes {EC j} + virtual {j'}; edge (j,j') has
    the solo value, (j,k) the pair value. Blossom via networkx."""
    m = solo.shape[0]
    g = nx.Graph()
    for j in range(m):
        g.add_edge(("ec", j), ("v", j), weight=float(solo[j]))
        for k in range(j + 1, m):
            g.add_edge(("ec", j), ("ec", k), weight=float(pair[j, k]))
    match = nx.max_weight_matching(g, maxcardinality=False)
    out = np.zeros((m, m), np.float32)
    for a, b in match:
        if a[0] == "v":
            a, b = b, a
        if b[0] == "v":
            out[a[1], a[1]] = 1.0
        else:
            out[a[1], b[1]] = 1.0
            out[b[1], a[1]] = 1.0
    return out


def exact_assignment(w: np.ndarray) -> np.ndarray:
    """Optimal plain-P1 assignment (each EC -> one CU, disjoint) via
    max-weight bipartite matching; used as oracle for greedy_assignment."""
    n_cu, n_ec = w.shape
    g = nx.Graph()
    for i in range(n_cu):
        for j in range(n_ec):
            if w[i, j] > 0:
                g.add_edge(("cu", i), ("ec", j), weight=float(w[i, j]))
    match = nx.max_weight_matching(g, maxcardinality=False)
    alpha = np.zeros((n_cu, n_ec), np.float32)
    for a, b in match:
        if a[0] == "ec":
            a, b = b, a
        alpha[a[1], b[1]] = 1.0
    return alpha
