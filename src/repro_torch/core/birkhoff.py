"""Birkhoff-von Neumann decomposition of doubly stochastic matrices.

A doubly stochastic consensus matrix A decomposes as

    A = sum_k  lambda_k  P_k,     lambda_k > 0, sum lambda_k = 1,

with P_k permutation matrices.  This is the bridge from the paper's
topology design to a gossip schedule: every permutation P_k is one
transfer between silos (on one card, one ``index_select`` along the
silo dimension; across cards, one point-to-point exchange), so the
gossip step

    w_i  <-  sum_j A_ij w_j

becomes ``sum_k lambda_k * w[P_k]`` — a number of sequential transfers
equal to the number of non-identity permutations, mirroring the degree
term of the paper's delay model (Eq. 3).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _perfect_matching(support: np.ndarray) -> List[int]:
    """Perfect matching on the bipartite support graph (rows -> cols) via
    Hopcroft-Karp-style augmenting paths (Hungarian augmentation)."""
    n = support.shape[0]
    match_col = [-1] * n  # col -> row
    match_row = [-1] * n  # row -> col

    def try_assign(r: int, seen: List[bool]) -> bool:
        # Prefer the diagonal: extracting the identity permutation first
        # (A_ii is usually the largest entry) saves one transfer.
        cols = [r] + [c for c in range(n) if c != r]
        for c in cols:
            if support[r, c] and not seen[c]:
                seen[c] = True
                if match_col[c] == -1 or try_assign(match_col[c], seen):
                    match_col[c] = r
                    match_row[r] = c
                    return True
        return False

    for r in range(n):
        if not try_assign(r, [False] * n):
            raise ValueError("no perfect matching: matrix is not doubly stochastic")
    return match_row


def birkhoff_decomposition(
    A: np.ndarray, tol: float = 1e-9, max_terms: int = 10_000
) -> List[Tuple[float, np.ndarray]]:
    """Decompose doubly stochastic ``A`` into [(coeff, perm)], where
    ``perm[i]`` is the source index feeding row i (i.e. P[i, perm[i]] = 1,
    so (P w)[i] = w[perm[i]]).

    Greedy Birkhoff: repeatedly extract the matching on the support and
    subtract ``min_entry * P``.  Terminates in at most (n-1)^2 + 1 terms;
    for a degree-d gossip matrix it produces <= d + 1 terms.
    """
    A = np.array(A, dtype=np.float64, copy=True)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError("square matrix required")
    if not np.allclose(A.sum(0), 1.0, atol=1e-6) or not np.allclose(A.sum(1), 1.0, atol=1e-6):
        raise ValueError("matrix is not doubly stochastic")
    terms: List[Tuple[float, np.ndarray]] = []
    remaining = 1.0
    for _ in range(max_terms):
        if remaining <= tol:
            break
        support = A > tol
        match_row = _perfect_matching(support)
        coeff = min(A[r, match_row[r]] for r in range(n))
        perm = np.array(match_row, dtype=np.int64)
        terms.append((float(coeff), perm))
        for r in range(n):
            A[r, perm[r]] -= coeff
        remaining -= coeff
    # normalize tiny numeric drift
    total = sum(c for c, _ in terms)
    terms = [(c / total, p) for (c, p) in terms]
    return terms


def reconstruct(terms: List[Tuple[float, np.ndarray]], n: int) -> np.ndarray:
    """Rebuild the ``[n, n]`` doubly-stochastic matrix from Birkhoff
    ``(coeff, perm)`` terms (inverse of :func:`birkhoff_decomposition`)."""
    A = np.zeros((n, n))
    for (c, perm) in terms:
        for r in range(n):
            A[r, perm[r]] += c
    return A


def schedule_cost(terms: List[Tuple[float, np.ndarray]]) -> int:
    """Number of non-identity permutations = number of transfers."""
    cost = 0
    for (_, perm) in terms:
        if not np.array_equal(perm, np.arange(len(perm))):
            cost += 1
    return cost
