"""Batched mixing-rate pricing: the convergence half of co-design -- a
copy of the reference's ``repro/core/mixing.py``.

The paper's evaluation (Sect. 4) ranks topologies on *time-to-ε*, yet
cycle time τ (Eq. 4) only prices the throughput half: a sparse ring
wins rounds-per-second while mixing information at 1 − O(1/N²) per
round, and MATCHA's whole point — mixing per unit of traffic — is
invisible to τ̄.  This module prices the other half on the engine's
batched layouts:

* **Consensus matrices** from edge activations: :func:`mixing_matrix`
  (single) and :func:`batched_mixing_matrices` (``[B, E]`` activation
  masks over a shared arc pool → ``[B, N, N]`` stacks) under the
  local-degree rule the runtime deploys
  (:func:`repro_torch.core.consensus.local_degree_matrix`, the matrix
  :class:`repro_torch.fed.gossip.ScheduleSlot` builds each round), plus
  Metropolis and uniform (max-degree) weights.
* **Contraction factor ρ**: :func:`batched_rho` — the second-largest
  singular value of W, i.e. ``‖W − (1/n)·11ᵀ‖₂`` — over a whole
  candidate stack in one LAPACK call (``eigvalsh`` fast path for
  symmetric stacks, ``svd`` in general), with a jittable
  torch twin :func:`batched_rho_torch` (``torch.linalg.svdvals``, on
  the stack's device).
* **Randomized schedules**: the per-round matrix is a random variable,
  so the right contraction is ``ρ² = λ_max(E[WᵀW] − (1/n)·11ᵀ)``
  (E‖x_{k+1} − x̄‖² ≤ ρ²·E‖x_k − x̄‖²).  :func:`matcha_expected_gram`
  estimates E[WᵀW] from the *same* bulk-drawn activation masks the
  Monte-Carlo τ̄ pricing consumes
  (:meth:`repro_torch.core.schedule.MatchaSchedule.activation_masks`),
  deduplicating repeated activation subsets so only the distinct
  matrices are built.
* **The composite objective**: :func:`wall_clock_to_eps` scores a
  ``(τ, ρ)`` pair as ``τ / −log(ρ)`` — milliseconds per e-fold of
  consensus-error decay, the wall-clock-to-ε framing of Sect. 4 — and
  :func:`pareto_frontier` returns the non-dominated candidates for
  callers that want the whole tradeoff curve rather than one scalar.

Everything here is pure numpy over label-indexed graphs, apart from the
``*_torch`` twins.  All ρ math is f64 by default but dtype-preserving:
f32 stacks price in f32.
"""

from __future__ import annotations

import math
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..obs.spans import span_fn
from .consensus import local_degree_matrix, metropolis_matrix, ring_matrix
from .schedule import Schedule, _unique_rows

Node = Hashable
Edge = Tuple[Node, Node]

#: Supported consensus-weight rules for matrix construction.
WEIGHT_RULES = ("local_degree", "metropolis", "uniform")

#: Supported design objectives (ControllerConfig.objective / --objective).
OBJECTIVES = ("tau", "time_to_eps")

#: Floor applied to ρ inside the −log: a perfectly-mixing round (ρ = 0,
#: e.g. STAR's full averaging) still costs one round, so its score must
#: stay proportional to τ rather than collapsing to zero.
RHO_FLOOR = 1e-9


# ---------------------------------------------------------------------------
# Consensus-matrix construction


def mixing_matrix(
    num_nodes: int,
    edges: Sequence[Tuple[int, int]],
    *,
    rule: str = "local_degree",
) -> np.ndarray:
    """Consensus matrix of one directed edge list (0-based indices).

    ``rule`` picks the weight scheme: ``"local_degree"`` (Eq. 22-23,
    what the gossip runtime deploys), ``"metropolis"``
    (Metropolis-Hastings, symmetrized support) or ``"uniform"``
    (constant weight ``1/(1+Δ)`` with Δ the max degree).  Undirected
    overlays must list both arc directions, as everywhere in the repo.
    """
    n = int(num_nodes)
    if rule == "local_degree":
        return local_degree_matrix(n, edges)
    if rule == "metropolis":
        return metropolis_matrix(n, edges)
    if rule == "uniform":
        deg = np.zeros(n, dtype=np.int64)
        for (i, j) in edges:
            if i != j:
                deg[j] += 1
        alpha = 1.0 / (1.0 + (int(deg.max()) if n else 0))
        A = np.zeros((n, n), dtype=np.float64)
        for (i, j) in edges:
            if i != j:
                A[j, i] = alpha
        A = np.maximum(A, A.T)  # symmetrize support
        for i in range(n):
            A[i, i] = 1.0 - A[i].sum()
        return A
    raise ValueError(f"unknown weight rule {rule!r}; one of {WEIGHT_RULES}")


@span_fn("engine.mixing_matrices")
def batched_mixing_matrices(
    num_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    masks: np.ndarray,
    *,
    rule: str = "local_degree",
) -> np.ndarray:
    """``[B, N, N]`` consensus matrices of ``[B, E]`` arc activations.

    ``src``/``dst`` are the shared directed arc pool (0-based node
    indices; both directions present for undirected links), ``masks``
    the per-candidate activation — the same layout the sparse max-plus
    engine prices τ on, so one mask stack feeds both halves of the
    (τ, ρ) pair.  Degrees are recomputed per row (a deactivated arc
    changes its endpoints' weights), fully vectorized: one ``bincount``
    for the ``[B, N]`` degree table and one scatter-add for the
    off-diagonal entries.  A row with no active arcs yields the
    identity (no mixing, ρ = 1).
    """
    n = int(num_nodes)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    act = np.asarray(masks, dtype=np.float64)
    if rule not in WEIGHT_RULES:
        raise ValueError(f"unknown weight rule {rule!r}; one of {WEIGHT_RULES}")
    B, E = act.shape
    A = np.zeros((B, n, n), dtype=np.float64)
    di = np.arange(n, dtype=np.int64)
    if E == 0:
        A[:, di, di] = 1.0
        return A
    act = np.where(src[None, :] == dst[None, :], 0.0, act)  # drop self-loops
    flat = (np.arange(B, dtype=np.int64)[:, None] * n + dst[None, :]).ravel()
    deg = np.bincount(flat, weights=act.ravel(), minlength=B * n).reshape(B, n)
    if rule == "uniform":
        w = act / (1.0 + deg.max(axis=1, keepdims=True))
    else:  # local_degree / metropolis share the pairwise max-degree weight
        w = act / (1.0 + np.maximum(deg[:, src], deg[:, dst]))
    rows = np.broadcast_to(np.arange(B, dtype=np.int64)[:, None], (B, E))
    np.add.at(
        A,
        (rows, np.broadcast_to(dst, (B, E)), np.broadcast_to(src, (B, E))),
        w,
    )
    if rule in ("metropolis", "uniform"):
        A = np.maximum(A, np.transpose(A, (0, 2, 1)))  # symmetrize support
    A[:, di, di] = 0.0
    A[:, di, di] = 1.0 - A.sum(axis=2)
    return A


# ---------------------------------------------------------------------------
# Batched contraction factor / spectral gap


@span_fn("engine.mixing_rho")
def batched_rho(W: np.ndarray, *, symmetric: bool = False) -> np.ndarray:
    """``[B]`` contraction factors ρ = ‖W − (1/n)·11ᵀ‖₂ of a matrix stack.

    For doubly-stochastic W this is the second-largest singular value —
    the per-round worst-case consensus contraction (‖Wx − x̄‖ ≤
    ρ·‖x − x̄‖ for mean-zero deviations).  ``symmetric=True`` takes the
    ``eigvalsh`` fast path (ρ = max |λ| of the deflated matrix), valid
    for symmetric stacks (local-degree/Metropolis on undirected
    overlays); the default prices arbitrary (e.g. directed-ring) stacks
    via one batched SVD.  dtype-preserving: a float32 stack is priced
    in float32.
    """
    W = np.asarray(W)
    n = W.shape[-1]
    M = W - np.asarray(1.0 / n, dtype=W.dtype)
    if symmetric:
        lam = np.linalg.eigvalsh(0.5 * (M + np.swapaxes(M, -1, -2)))
        return np.maximum(np.abs(lam[..., 0]), np.abs(lam[..., -1]))
    s = np.linalg.svd(M, compute_uv=False)
    return s[..., 0]


@span_fn("engine.mixing_gap")
def batched_spectral_gap(W: np.ndarray, *, symmetric: bool = False) -> np.ndarray:
    """``[B]`` spectral gaps ``1 − ρ`` (see :func:`batched_rho`); the
    batched twin of :func:`repro_torch.core.consensus.spectral_gap`."""
    one = np.asarray(1.0, dtype=np.asarray(W).dtype)
    return one - batched_rho(W, symmetric=symmetric)


def batched_rho_torch(W) -> torch.Tensor:
    """Torch twin of :func:`batched_rho` (general SVD path): ``[B]`` ρ of
    a ``[B, N, N]`` stack on its own device, by ``torch.linalg.svdvals``.
    dtype follows the input."""
    W = torch.as_tensor(W)
    n = W.shape[-1]
    M = W - torch.tensor(1.0 / n, dtype=W.dtype, device=W.device)
    return torch.linalg.svdvals(M)[..., 0]


def batched_spectral_gap_torch(W) -> torch.Tensor:
    """Torch twin of :func:`batched_spectral_gap`."""
    W = torch.as_tensor(W)
    return torch.tensor(1.0, dtype=W.dtype, device=W.device) - batched_rho_torch(W)


# ---------------------------------------------------------------------------
# Overlay / plan / schedule pricing


def _silo_index(
    n: int, silos: Optional[Sequence[Node]], edges: Sequence[Edge]
) -> dict:
    if silos is None:
        labels = {v for e in edges for v in e}
        try:
            silos = sorted(labels)
        except TypeError:
            silos = sorted(labels, key=repr)
    return {v: k for k, v in enumerate(silos)}


def overlay_mixing_matrix(
    overlay, num_nodes: int, *, silos: Optional[Sequence[Node]] = None
) -> np.ndarray:
    """The consensus matrix the runtime would deploy for ``overlay``.

    Mirrors :func:`repro_torch.fed.topology_runtime.plan_from_overlay` exactly
    (ring-named overlays get the Appendix H.4 optimal ``(I + P)/2``,
    STAR gets full averaging ``(1/n)·11ᵀ``, everything else the
    local-degree rule) so the priced ρ is the deployed ρ — but lives in
    ``core``, so designers can price mixing without the runtime.
    ``silos`` pins the label → index order (pass
    ``gc.silos``); by default edge labels are sorted.
    """
    n = int(num_nodes)
    index = _silo_index(n, silos, overlay.edges)
    edges = [(index[i], index[j]) for (i, j) in overlay.edges]
    if overlay.name.startswith("ring") and edges:
        nxt = {i: j for (i, j) in edges}
        if len(nxt) == n == len(edges):
            tour = [edges[0][0]]
            for _ in range(n - 1):
                tour.append(nxt[tour[-1]])
            return ring_matrix(n, tour)
        # ring-named but not a single directed tour (e.g. a repaired
        # ring fragment): fall through to the local-degree rule, which
        # is what plan construction would reject and re-derive anyway.
    if overlay.name == "star":
        return np.full((n, n), 1.0 / n, dtype=np.float64)
    return local_degree_matrix(n, edges)


@span_fn("engine.overlay_rho")
def overlay_rho(
    overlay, num_nodes: int, *, silos: Optional[Sequence[Node]] = None
) -> float:
    """ρ of one overlay's deployed consensus matrix."""
    W = overlay_mixing_matrix(overlay, num_nodes, silos=silos)
    return float(batched_rho(W[None])[0])


@span_fn("engine.overlay_rho_batch")
def overlay_rho_batch(
    overlays: Sequence, num_nodes: int, *, silos: Optional[Sequence[Node]] = None
) -> np.ndarray:
    """``[len(overlays)]`` ρ of a candidate pool in one batched SVD.

    Matrix construction is per-overlay (rules differ: ring vs star vs
    local-degree) but the spectral pricing — the O(N³) part — is one
    stacked LAPACK call, the same batching win as the max-plus engines.
    """
    if not len(overlays):
        return np.zeros((0,), dtype=np.float64)
    W = np.stack(
        [
            overlay_mixing_matrix(ov, num_nodes, silos=silos)
            for ov in overlays
        ]
    )
    return batched_rho(W)


@span_fn("engine.matcha_expected_gram")
def matcha_expected_gram(
    schedule,
    gc,
    *,
    rounds: int = 128,
    seed: int = 0,
    rule: str = "local_degree",
) -> np.ndarray:
    """Empirical ``E[WᵀW]`` of a randomized schedule's per-round matrix.

    Draws ``rounds`` activation rows from the schedule's own bulk
    sampler (:meth:`~repro_torch.core.schedule.MatchaSchedule.activation_masks`
    — the stream τ̄ pricing consumes), deduplicates repeated activation
    subsets (at small budgets most rounds repeat a handful), builds the
    distinct consensus matrices in one :func:`batched_mixing_matrices`
    call under ``rule`` (``"local_degree"`` matches what
    :class:`repro_torch.fed.gossip.ScheduleSlot` deploys per round) and
    returns the count-weighted Gram average.  The arc pool is filtered
    to pairs ``gc`` still routes, exactly as τ̄ pricing filters it.
    """
    arcs, mids = schedule._arc_pool(gc)
    if not arcs:
        # Nothing routable: every round is the identity (no mixing).
        return np.eye(gc.num_silos, dtype=np.float64)
    index = {v: k for k, v in enumerate(gc.silos)}
    src = np.asarray([index[i] for (i, _) in arcs], dtype=np.int64)
    dst = np.asarray([index[j] for (_, j) in arcs], dtype=np.int64)
    masks = schedule.activation_masks(rounds, seed)  # [R, M]
    first, inv = _unique_rows(masks)
    counts = np.bincount(inv, minlength=len(first)).astype(np.float64)
    p = counts / counts.sum()
    uniq = masks[first][:, mids]  # [U, E] arc activations
    W = batched_mixing_matrices(gc.num_silos, src, dst, uniq, rule=rule)
    return np.einsum("u,uij,uik->jk", p, W, W)


def contraction_from_gram(G: np.ndarray) -> float:
    """ρ = sqrt(λ_max(E[WᵀW] − (1/n)·11ᵀ)) of a symmetric Gram average —
    the mean-square per-round consensus contraction of a random W."""
    G = np.asarray(G, dtype=np.float64)
    n = G.shape[0]
    M = G - np.full((n, n), 1.0 / n, dtype=np.float64)
    lam = float(np.linalg.eigvalsh(0.5 * (M + M.T))[-1])
    return float(math.sqrt(max(lam, 0.0)))


@span_fn("engine.schedule_rho")
def schedule_rho(
    schedule: Schedule,
    gc,
    *,
    rounds: int = 128,
    seed: int = 0,
    rule: str = "local_degree",
) -> float:
    """ρ of any :class:`~repro_torch.core.schedule.Schedule` on an estimate.

    Fixed schedules price the deployed overlay matrix exactly
    (:func:`overlay_rho`); randomized ones price the expected
    contraction ``sqrt(λ_max(E[WᵀW] − J/n))`` over ``rounds`` sampled
    activation rows (:func:`matcha_expected_gram`).
    """
    if not schedule.is_randomized:
        return overlay_rho(
            schedule.overlay, gc.num_silos, silos=tuple(gc.silos)
        )
    G = matcha_expected_gram(schedule, gc, rounds=rounds, seed=seed, rule=rule)
    return contraction_from_gram(G)


# ---------------------------------------------------------------------------
# The composite objective and the Pareto frontier


def wall_clock_to_eps(tau_ms: float, rho: float) -> float:
    """Score a ``(τ, ρ)`` pair as wall clock per e-fold of error decay.

    Consensus error contracts by ρ per round, so reaching a target ε
    takes ``log(1/ε)/(−log ρ)`` rounds at τ ms each — the Sect. 4
    time-to-ε framing up to the ε-dependent constant, which cancels in
    any argmin.  ``ρ ≥ 1`` (disconnected / no contraction) scores +inf;
    ρ is floored at :data:`RHO_FLOOR` so perfectly-mixing one-round
    topologies (STAR) stay proportional to their τ instead of scoring
    an impossible zero.  NaN ρ propagates (the caller forgot to price
    mixing).
    """
    tau = float(tau_ms)
    r = float(rho)
    if math.isnan(r):
        return float("nan")
    if r >= 1.0:
        return float("inf")
    return tau / -math.log(max(r, RHO_FLOOR))


def score_estimate(est, objective: str) -> float:
    """Scalarize a priced estimate under ``objective``.

    ``est`` is any object with ``tau_ms`` and ``rho`` attributes
    (:class:`~repro_torch.core.schedule.ScheduleEstimate`).  ``"tau"`` ranks
    on cycle time alone (the paper's Table 1 regime); ``"time_to_eps"``
    on :func:`wall_clock_to_eps` and raises if ρ was never priced —
    silently ranking NaNs would make ``min()`` nondeterministic.
    """
    if objective == "tau":
        return float(est.tau_ms)
    if objective == "time_to_eps":
        score = wall_clock_to_eps(est.tau_ms, est.rho)
        if math.isnan(score):
            raise ValueError(
                "objective='time_to_eps' needs a priced rho; this "
                "estimate has rho=NaN (price mixing before scoring)"
            )
        return score
    raise ValueError(f"unknown objective {objective!r}; one of {OBJECTIVES}")


def pareto_frontier(taus, rhos) -> np.ndarray:
    """Indices of the (τ, ρ)-non-dominated candidates, sorted by τ.

    A candidate is dominated when another is at least as fast *and*
    mixes at least as well, strictly better in one.  The frontier is
    what a designer should surface when the caller wants the tradeoff
    curve instead of one scalarized pick: every point on it is optimal
    for *some* convergence/throughput weighting.
    """
    t = np.asarray(taus, dtype=np.float64)
    r = np.asarray(rhos, dtype=np.float64)
    order = np.lexsort((r, t))  # by τ, ties by ρ
    keep: List[int] = []
    best_r = np.inf
    for k in order:
        if r[k] < best_r:
            keep.append(int(k))
            best_r = r[k]
    return np.asarray(keep, dtype=np.int64)
