"""Dense batched max-plus engine on the host (numpy): a copy of the
host part of the reference's ``repro/core/maxplus_vec.py``.

A delay digraph is a dense ``[N, N]`` matrix ``W`` with ``W[i, j] =
d_o(i, j)`` and ``MISSING`` (``-inf``) where there is no arc
(:func:`edges_to_matrix`, :func:`graph_to_matrix`); whole batches ``[B,
N, N]`` are scored at once:

* :func:`batched_cycle_time` -- Karp's maximum cycle mean per graph, one
  broadcast ``np.max`` sweep per DP level;
* :func:`reachability_closure` / :func:`batched_is_strongly_connected`
  -- boolean matrix-power transitive closure;
* :func:`scc_labels` -- strongly-connected components;
* the Eq. 4 timing recursion on dense state, static
  (:func:`batched_timing_recursion`) and piecewise-constant over network
  epochs (:func:`batched_timing_recursion_piecewise`, the engine of
  :mod:`repro_torch.dynamics.simulate`), and the critical circuit
  (:func:`critical_circuit_dense`).

Karp on a batch runs the *multi-source* variant: ``D_0(v) = 0`` for every
vertex and ``D_k(v)`` is the max weight of a walk of exactly k arcs ending
at v, so

    mu* = max_v min_{0<=k<N} ( D_N(v) - D_k(v) ) / (N - k)

is exact on the original N vertices, and acyclic graphs give ``-inf``.
"""

from __future__ import annotations

from typing import Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..obs.spans import span_fn


# The "absent arc" sentinel of every engine in the port.
MISSING = float("-inf")
NEG_INF = MISSING  # the reference's name for it

# Above this vertex count the boolean matrix-power closure (O(N^3 log N)
# bits) loses to iterative Tarjan (O(N + E)).
_DENSE_SCC_THRESHOLD = 512

# Default cap on the D_k storage of one batched Karp chunk (float64).
_DEFAULT_DP_BYTES = 256 << 20

# Per-level working set (chunk * N * N * 8 bytes) targeted at L2/L3
# residency.
_DP_CACHE_BYTES = 2 << 20


def missing_mask(x) -> np.ndarray:
    """Boolean mask of *absent* arcs: True where ``x`` carries the
    ``MISSING`` sentinel (``np.isneginf``).

    The one way the host engines test for the sentinel: a raw equality
    test reads as a value test, and an f32 pipeline can *manufacture*
    -inf by overflow.  Works on scalars and arrays alike.
    """
    return np.isneginf(x)


def edges_to_matrix(delays: Mapping[Tuple[Hashable, Hashable], float],
                    nodes: Sequence[Hashable]) -> np.ndarray:
    """Dense ``[N, N]`` weight matrix with ``-inf`` holes from an edge dict."""
    index = {v: k for k, v in enumerate(nodes)}
    W = np.full((len(nodes), len(nodes)), NEG_INF, dtype=np.float64)
    for (i, j), w in delays.items():
        W[index[i], index[j]] = w
    return W


def graph_to_matrix(graph) -> Tuple[np.ndarray, Tuple[Hashable, ...]]:
    """Convert a :class:`repro_torch.core.maxplus.DelayDigraph` to (W, nodes)."""
    return edges_to_matrix(graph.delays, graph.nodes), tuple(graph.nodes)


@span_fn("engine.karp_dense")
def batched_cycle_time(
    weights: np.ndarray,
    *,
    max_dp_bytes: int = _DEFAULT_DP_BYTES,
    chunk_graphs: Optional[int] = None,
    dtype: np.dtype = np.float64,
) -> np.ndarray:
    """Maximum cycle mean of every graph in a batch.

    Parameters
    ----------
    weights:
        ``[B, N, N]`` (or a single ``[N, N]``) array; ``weights[b, i, j]``
        is the arc weight i->j of graph b, ``-inf`` where there is no arc.
    max_dp_bytes:
        Hard cap on one chunk's DP storage (Karp's formula needs all
        levels ``D_0..D_N``).
    chunk_graphs:
        Explicit graphs-per-chunk override; by default sized so a level's
        working set stays cache-resident.
    dtype:
        ``np.float64`` (default) reproduces the legacy Python floats
        exactly; ``np.float32`` halves memory traffic — plenty for
        ranking candidate overlays whose delays are ms-scale
        measurements.

    Returns
    -------
    ``[B]`` array of max cycle means (``-inf`` for acyclic graphs); a
    scalar if the input was a single matrix.
    """
    dtype = np.dtype(dtype)
    W = np.asarray(weights, dtype=dtype)
    single = W.ndim == 2
    if single:
        W = W[None]
    if W.ndim != 3 or W.shape[-1] != W.shape[-2]:
        raise ValueError(f"expected [B, N, N] weights, got shape {W.shape}")
    B, N, _ = W.shape
    if N == 0:
        out = np.full(B, MISSING, dtype=dtype)
        return out[0] if single else out
    itemsize = dtype.itemsize
    if chunk_graphs is None:
        per_level = N * N * itemsize
        per_graph_dp = (N + 1) * N * itemsize
        chunk_graphs = min(
            max(1, _DP_CACHE_BYTES // max(per_level, 1)),
            max(1, max_dp_bytes // max(per_graph_dp, 1)),
        )
    chunk = max(1, min(B, chunk_graphs))
    out = np.empty(B, dtype=dtype)
    for lo in range(0, B, chunk):
        out[lo : lo + chunk] = _karp_chunk(W[lo : lo + chunk])
    return out[0] if single else out


def _karp_chunk(W: np.ndarray) -> np.ndarray:
    B, N, _ = W.shape
    # Multi-source DP: D[k][b, v] = max weight of a walk of exactly k
    # arcs ending at v (from any start vertex).
    D = np.empty((N + 1, B, N), dtype=W.dtype)
    D[0] = 0.0
    cur = D[0]
    for k in range(1, N + 1):
        # D_k[v] = max_u D_{k-1}[u] + W[u, v]  — one broadcast sweep.
        cur = np.max(cur[:, :, None] + W, axis=1)
        D[k] = cur
    return karp_from_levels(D)


def karp_from_levels(D: np.ndarray) -> np.ndarray:
    """Karp's formula from a precomputed multi-source DP table.

    ``D`` is ``[N+1, B, N]`` with ``D[k, b, v]`` the max weight of a walk
    of exactly k arcs ending at v in graph b (``D[0] == 0``).  Returns the
    ``[B]`` max cycle means.  Shared by the dense sweep above and the
    edge-list DP of :mod:`repro_torch.core.maxplus_sparse` — the engines differ
    only in how they produce the levels.
    """
    Np1, B, N = D.shape
    assert Np1 == N + 1, f"expected [N+1, B, N] levels, got {D.shape}"
    Dn = D[N]  # [B, N]
    denom = (N - np.arange(N)).astype(D.dtype)  # [N]
    with np.errstate(invalid="ignore"):
        ratios = (Dn[None, :, :] - D[:N]) / denom[:, None, None]
    # D_k = -inf, D_N finite  -> ratio +inf (never the min): already so.
    # D_k = D_N = -inf        -> nan: neutralize to +inf.
    np.nan_to_num(ratios, copy=False, nan=np.inf)
    mins = np.min(ratios, axis=0)  # [B, N]
    # Vertices with no N-arc walk do not certify any cycle.
    mins = np.where(missing_mask(Dn), MISSING, mins)
    return np.max(mins, axis=1)


def cycle_time_dense(W: np.ndarray) -> float:
    """Max cycle mean of a single dense weight matrix."""
    return float(batched_cycle_time(np.asarray(W, dtype=np.float64)))


def batched_throughput(weights: np.ndarray) -> np.ndarray:
    """1 / tau per graph (inf where tau <= 0 or the graph is acyclic)."""
    tau = np.atleast_1d(batched_cycle_time(weights))
    out = np.full_like(tau, np.inf)
    pos = tau > 0
    out[pos] = 1.0 / tau[pos]
    return out


def reachability_closure(adj: np.ndarray) -> np.ndarray:
    """Reflexive-transitive closure of boolean adjacency ``[..., N, N]``.

    Repeated boolean squaring: log2(N) matrix products instead of a
    per-vertex graph traversal, so it batches over leading dimensions.
    """
    A = np.asarray(adj, dtype=bool)
    N = A.shape[-1]
    R = A | np.eye(N, dtype=bool)
    hops = 1
    while hops < N:
        # R ∘ R in the boolean semiring.
        R = np.matmul(R, R)
        hops *= 2
    return R


def batched_is_strongly_connected(weights: np.ndarray) -> np.ndarray:
    """``[B]`` bool: is each graph (arcs where weight > -inf) strong?

    Self-loops are ignored, matching the legacy Tarjan-based check.
    """
    W = np.asarray(weights)
    single = W.ndim == 2
    if single:
        W = W[None]
    adj = W > MISSING
    idx = np.arange(adj.shape[-1])
    adj = adj.copy()
    adj[:, idx, idx] = False
    R = reachability_closure(adj)
    ok = np.all(R & np.swapaxes(R, -1, -2), axis=(-1, -2))
    return ok[0] if single else ok


def scc_labels(adj: np.ndarray, *, dense_threshold: int = _DENSE_SCC_THRESHOLD) -> np.ndarray:
    """Component label per vertex (vertices share a label iff mutually
    reachable).  Matrix-power closure for small N, Tarjan for large N."""
    A = np.asarray(adj, dtype=bool)
    n = A.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n <= dense_threshold:
        R = reachability_closure(A)
        mutual = R & R.T
        # Label = smallest mutually-reachable vertex index: identical for
        # every member of the SCC (mutual reachability is an equivalence).
        return np.argmax(mutual, axis=1).astype(np.int64)
    return _tarjan_labels(A)


def _tarjan_labels(A: np.ndarray) -> np.ndarray:
    n = A.shape[0]
    succ = [np.nonzero(A[v])[0] for v in range(n)]
    index = np.full(n, -1, dtype=np.int64)
    lowlink = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    labels = np.full(n, -1, dtype=np.int64)
    stack: List[int] = []
    counter = 0
    ncomp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = lowlink[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            sv = succ[v]
            for i in range(pi, len(sv)):
                w = int(sv[i])
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    lowlink[v] = min(lowlink[v], index[w])
            if recurse:
                continue
            if lowlink[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    labels[w] = ncomp
                    if w == v:
                        break
                ncomp += 1
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
    return labels


# ---------------------------------------------------------------------------
# Timing recursion (Eq. 4) on dense state


def timing_recursion_dense(
    W: np.ndarray, num_rounds: int, t0: Optional[np.ndarray] = None
) -> np.ndarray:
    """Evolve ``t(k+1) = W^T (x) t(k)`` (max-plus) for ``num_rounds`` rounds.

    ``W`` is ``[N, N]``; a missing self-loop acts as weight 0 (a silo with
    no modeled computation delay still observes its own previous start).
    Returns ``[num_rounds + 1, N]``.
    """
    out = batched_timing_recursion(
        np.asarray(W, dtype=np.float64)[None],
        num_rounds,
        None if t0 is None else np.asarray(t0, dtype=np.float64)[None],
    )
    return out[0]


def batched_timing_recursion(
    W: np.ndarray, num_rounds: int, t0: Optional[np.ndarray] = None
) -> np.ndarray:
    """Batched Eq. 4 recursion: ``[B, N, N]`` weights -> ``[B, R+1, N]``."""
    W = np.asarray(W, dtype=np.float64)
    B, N, _ = W.shape
    Weff = W.copy()
    idx = np.arange(N)
    diag = Weff[:, idx, idx]
    Weff[:, idx, idx] = np.where(missing_mask(diag), 0.0, diag)
    t = (np.zeros((B, N), dtype=np.float64) if t0 is None
         else np.asarray(t0, dtype=np.float64).copy())
    out = np.empty((B, num_rounds + 1, N), dtype=np.float64)
    out[:, 0] = t
    for k in range(num_rounds):
        # t_j(k+1) = max_i t_i(k) + W[i, j]
        t = np.max(t[:, :, None] + Weff, axis=1)
        out[:, k + 1] = t
    return out


def empirical_cycle_time_dense(W: np.ndarray, num_rounds: int = 200) -> float:
    """Estimate tau from the slope of the dense recursion tail."""
    t = timing_recursion_dense(W, num_rounds)
    warmup = num_rounds // 2
    return float(np.max((t[num_rounds] - t[warmup]) / (num_rounds - warmup)))


# ---------------------------------------------------------------------------
# Time-varying (piecewise-constant) timing recursion


def _epoch_of(starts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Epoch index per entry of ``t``: the last epoch whose start <= t.

    ``starts`` is ``[E]`` (or ``[B, E]`` matching a leading batch dim of
    ``t``) of nondecreasing epoch start times with ``starts[..., 0]``
    covering t=0.
    """
    if starts.ndim == 1:
        e = np.searchsorted(starts, t, side="right") - 1
    else:
        # batched: one boolean reduction instead of a per-row searchsorted
        e = np.sum(starts[:, None, :] <= t[:, :, None], axis=-1) - 1
    return np.clip(e, 0, starts.shape[-1] - 1)


def timing_recursion_piecewise(
    Ws: np.ndarray,
    epoch_starts_ms: np.ndarray,
    num_rounds: int,
    t0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Eq. 4 recursion under a piecewise-constant time-varying network.

    ``Ws`` is ``[E, N, N]``: one Eq. 3 delay matrix per network epoch,
    ``epoch_starts_ms`` the ``[E]`` nondecreasing epoch start instants
    (``epoch_starts_ms[0] <= 0``).  At round k, silo i transmits with the
    delays of the epoch containing its *start* time ``t_i(k)`` -- rows of
    the effective delay matrix are gathered per silo, so silos straddling
    an event boundary see different network states within one round.
    With a single epoch this reduces to :func:`timing_recursion_dense`
    bit for bit.

    Returns ``[num_rounds + 1, N]`` start times.
    """
    out = batched_timing_recursion_piecewise(
        np.asarray(Ws, dtype=np.float64)[None],
        np.asarray(epoch_starts_ms, dtype=np.float64)[None],
        num_rounds,
        None if t0 is None else np.asarray(t0, dtype=np.float64)[None],
    )
    return out[0]


@span_fn("engine.timing_piecewise")
def batched_timing_recursion_piecewise(
    Ws: np.ndarray,
    epoch_starts_ms: np.ndarray,
    num_rounds: int,
    t0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Batched scenario form: ``[B, E, N, N]`` epochs -> ``[B, R+1, N]``.

    Each scenario b carries its own epoch matrices ``Ws[b]`` and epoch
    grid ``epoch_starts_ms[b]`` (``[B, E]``); scenarios advance in
    lockstep over rounds.
    """
    Ws = np.asarray(Ws, dtype=np.float64)
    if Ws.ndim != 4 or Ws.shape[-1] != Ws.shape[-2]:
        raise ValueError(f"expected [B, E, N, N] epoch weights, got {Ws.shape}")
    B, E, N, _ = Ws.shape
    starts = np.asarray(epoch_starts_ms, dtype=np.float64)
    if starts.shape != (B, E):
        raise ValueError(f"epoch_starts_ms shape {starts.shape} != {(B, E)}")
    Weff = Ws.copy()
    idx = np.arange(N)
    diag = Weff[:, :, idx, idx]
    Weff[:, :, idx, idx] = np.where(missing_mask(diag), 0.0, diag)
    t = (np.zeros((B, N), dtype=np.float64) if t0 is None
         else np.asarray(t0, dtype=np.float64).copy())
    out = np.empty((B, num_rounds + 1, N), dtype=np.float64)
    out[:, 0] = t
    b_idx = np.arange(B)[:, None]
    for k in range(num_rounds):
        e = _epoch_of(starts, t)  # [B, N] epoch per *sender*
        Wk = Weff[b_idx, e, idx[None, :], :]  # gather rows -> [B, N, N]
        t = np.max(t[:, :, None] + Wk, axis=1)
        out[:, k + 1] = t
    return out


# ---------------------------------------------------------------------------
# Critical circuit (vectorized tight-subgraph extraction)


def critical_circuit_dense(
    W: np.ndarray, *, tau: Optional[float] = None
) -> Tuple[float, List[int]]:
    """(tau, circuit) attaining the max cycle mean of a dense ``[N, N]``
    weight matrix; the circuit is a closed vertex-index walk
    ``[v0, ..., v0]`` (empty for acyclic graphs).

    Longest-path potentials under the reduced weights ``W - tau`` converge
    in <= N max-plus matvec sweeps, the *tight* arcs ``pot[u] + w'(u,v) ==
    pot[v]`` form one boolean matrix, and a vertex on a critical circuit
    is any diagonal hit of ``tight @ closure(tight)``.  Only the final
    circuit walk -- output-sized -- runs in Python.
    """
    W = np.asarray(W, dtype=np.float64)
    N = W.shape[0]
    if tau is None:
        tau = float(batched_cycle_time(W))
    if missing_mask(tau) or N == 0:
        return NEG_INF, []
    finite = W > NEG_INF
    with np.errstate(invalid="ignore"):
        Wr = np.where(finite, W - tau, NEG_INF)
    eps = 1e-9 * max(1.0, abs(tau))
    # Longest-path potentials from the all-zeros super-source.
    pot = np.zeros(N, dtype=np.float64)
    for _ in range(N):
        nxt = np.maximum(pot, np.max(pot[:, None] + Wr, axis=0))
        if np.all(nxt <= pot + eps):
            pot = nxt
            break
        pot = nxt
    tight = finite & (pot[:, None] + Wr >= pot[None, :] - 10 * eps)
    # Vertex on a critical circuit: closed tight walk of length >= 1.
    closure = reachability_closure(tight)
    on_cycle = np.diag(tight @ closure)
    hits = np.nonzero(on_cycle)[0]
    if hits.size == 0:  # numerically degenerate; caller falls back
        return tau, []
    v0 = int(hits[0])
    # Deterministic walk over tight arcs restricted to vertices that can
    # reach v0 tightly: the walk must revisit some vertex within N steps,
    # and any closed tight walk has original mean exactly tau.
    back = closure[:, v0]
    pos = {v0: 0}
    walk = [v0]
    cur = v0
    while True:
        succ = np.nonzero(tight[cur] & back)[0]
        if not succ.size:
            raise RuntimeError("tight subgraph lost the certified circuit")
        cur = int(succ[0])
        if cur in pos:
            return tau, walk[pos[cur]:] + [cur]
        pos[cur] = len(walk)
        walk.append(cur)
