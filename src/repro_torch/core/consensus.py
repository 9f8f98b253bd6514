"""Consensus matrices for DPASGD (Eq. 2, Appendix G.3).

The *local-degree rule* ([62], Eq. 22-23 of the paper):

    A_ij = 1 / (1 + max(|N_i^-|, |N_j^-|))   for (i,j) in E_o
    A_ii = 1 - sum_j A_ij

which is symmetric doubly stochastic on undirected overlays.  For the
directed RING the optimal consensus matrix has all non-zero entries equal
to 1/2 (Appendix H.4): A = (I + P)/2 with P the ring permutation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _degrees(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    for (i, j) in edges:
        if i != j:
            deg[j] += 1  # in-degree |N_j^+| == |N_j^-| on undirected overlays
    return deg


def local_degree_matrix(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Consensus matrix from the local-degree rule.

    ``edges`` are directed (i, j) pairs meaning i sends to j; for an
    undirected overlay both directions must be present.
    """
    deg = _degrees(n, edges)
    A = np.zeros((n, n), dtype=np.float64)
    for (i, j) in edges:
        if i == j:
            continue
        A[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    for i in range(n):
        A[i, i] = 1.0 - A[i].sum()
    return A


def ring_matrix(n: int, tour: Sequence[int]) -> np.ndarray:
    """A = (I + P)/2 for the directed ring defined by ``tour``."""
    A = 0.5 * np.eye(n)
    for k in range(n):
        i, j = tour[k], tour[(k + 1) % n]
        A[j, i] += 0.5
    return A


def metropolis_matrix(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Metropolis-Hastings weights (alternative to local-degree)."""
    deg = _degrees(n, edges)
    A = np.zeros((n, n), dtype=np.float64)
    for (i, j) in edges:
        if i == j:
            continue
        A[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    A = np.maximum(A, A.T)  # symmetrize support
    for i in range(n):
        A[i, i] = 1.0 - A[i].sum()
    return A


def is_doubly_stochastic(A: np.ndarray, tol: float = 1e-9) -> bool:
    """True iff ``A`` ([n, n]) is nonnegative with unit row and column
    sums — the precondition for the Birkhoff decomposition."""
    return (
        bool((A >= -tol).all())
        and bool(np.allclose(A.sum(axis=0), 1.0, atol=1e-8))
        and bool(np.allclose(A.sum(axis=1), 1.0, atol=1e-8))
    )


def spectral_gap(A: np.ndarray) -> float:
    """1 - second largest singular value of A - (1/n) 11^T — governs the
    per-round consensus contraction (classic worst-case bound)."""
    n = A.shape[0]
    M = A - np.full((n, n), 1.0 / n)
    s = np.linalg.svd(M, compute_uv=False)
    return float(1.0 - s[0])


def star_matrix(n: int, center: int) -> np.ndarray:
    """FedAvg-style star: one round of leaf->center averaging followed by
    broadcast equals the rank-one averaging matrix."""
    return np.full((n, n), 1.0 / n)
