"""Sparse (edge-list) batched max-plus engine: the host engine (numpy,
a copy of the reference's ``repro/core/maxplus_sparse.py``) and its
device twin in torch.

A batch of delay digraphs is a set of padded edge lists

    src[B, E] : int32  arc source vertex
    dst[B, E] : int32  arc destination vertex
    w[B, E]   : float  arc weight; ``-inf`` marks an absent (padding) arc

(an :class:`EdgeBatch`), evaluated in O(B·N·E) work with O(B·E) graph
storage:

* :func:`batched_cycle_time_sparse` -- multi-source Karp via one segment
  max over edges per DP level (numpy, f32/f64);
* :func:`batched_cycle_time_sparse_torch` -- the same DP on a torch
  device, through the implementation
  :func:`repro_torch.kernels.select_segment_max_impl` picks (on the card,
  the hand-written persistent Karp kernel: all N levels in one launch)
  -- the scorer inside the rewire climb of
  :mod:`repro_torch.core.topologies`;
* :func:`batched_is_strongly_connected_sparse` /
  :func:`reachable_from_sparse` / :func:`scc_labels_sparse` --
  reachability and SCCs along edges;
* :func:`timing_recursion_unique_rounds_sparse_torch` -- the
  round-varying Eq. 4 recursion behind MATCHA pricing (on the card, one
  launch of the hand-written persistent recursion for all rounds);
* :class:`DeltaPricer` -- incremental cycle-time certificates for the
  host rewire climb;
* :func:`batched_overlay_delay_edges` -- Eq. 3 pricing of a batch of
  candidate overlays as edge lists.

Padding convention: a padded arc keeps ``src``/``dst`` in ``[0, N)`` and
``w = -inf``.  ``-inf`` is absorbing in max-plus, so a padded arc never
attains a segment max and padding is exactly equivalent to the arc not
existing.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import karp_cycle_time, select_segment_max_impl, timing_recursion
from ..kernels.segment_max import karp_cycle_time_ref, karp_from_step
from ..obs.spans import span_fn
from .maxplus_vec import MISSING, karp_from_levels, missing_mask

Arc = Tuple[int, int]

# Default cap on one chunk's Karp level-table storage (matches the dense
# engine's default).
_DEFAULT_DP_BYTES = 256 << 20


class EdgeBatch(NamedTuple):
    """A batch of B delay digraphs on a common vertex set ``[0, N)``.

    Attributes
    ----------
    src, dst:
        ``[B, E]`` int32 arc endpoints (``src`` -> ``dst``).
    w:
        ``[B, E]`` float arc weights; ``-inf`` marks padding (the arc
        does not exist in that graph).
    num_nodes:
        N, the common vertex count.
    """

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    num_nodes: int

    @property
    def batch(self) -> int:
        return self.src.shape[0]

    @property
    def max_edges(self) -> int:
        return self.src.shape[1]


class _Segments(NamedTuple):
    """Precomputed sort-order for repeated segment maxes over fixed keys."""

    order: np.ndarray  # [B*E] permutation sorting keys
    starts: np.ndarray  # group start offsets into the sorted stream
    group_keys: np.ndarray  # the key of each group


def _segments_by(keys: np.ndarray) -> _Segments:
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return _Segments(order, starts, ks[starts])


def _segment_max(
    vals: np.ndarray, seg: _Segments, out_size: int, dtype
) -> np.ndarray:
    """Max of ``vals`` per key group, scattered into ``[out_size]``
    (``-inf`` where a key never occurs).  ``vals`` is flat ``[B*E]``."""
    out = np.full(out_size, MISSING, dtype=dtype)
    if seg.starts.size:
        out[seg.group_keys] = np.maximum.reduceat(vals[seg.order], seg.starts)
    return out


def _dst_segments(eb: EdgeBatch) -> _Segments:
    B, E = eb.src.shape
    keys = (
        np.repeat(np.arange(B, dtype=np.int64), E) * eb.num_nodes
        + eb.dst.ravel().astype(np.int64)
    )
    return _segments_by(keys)


@span_fn("engine.karp_sparse")
def batched_cycle_time_sparse(
    eb: EdgeBatch,
    *,
    dtype: Optional[np.dtype] = None,
    max_dp_bytes: int = _DEFAULT_DP_BYTES,
) -> np.ndarray:
    """Maximum cycle mean of every graph in an edge-list batch.

    Same multi-source Karp DP as
    :func:`repro_torch.core.maxplus_vec.batched_cycle_time`, but each level is
    one segment-max over the E arcs instead of an N×N broadcast sweep:
    O(B·N·E) work, which beats the dense O(B·N³) whenever E ≪ N².

    Parameters
    ----------
    eb:
        :class:`EdgeBatch`; padding arcs (``w = -inf``) are ignored.
    dtype:
        DP dtype; defaults to ``eb.w.dtype``.  f64 reproduces the dense
        engine bit-for-bit, f32 halves memory traffic for search-grade
        candidate ranking.
    max_dp_bytes:
        Cap on one chunk's ``[N+1, chunk, N]`` Karp level table (the
        formula needs all levels); the batch is chunked to stay under it,
        mirroring the dense engine.

    Returns
    -------
    ``[B]`` max cycle means (``-inf`` for acyclic graphs).
    """
    dtype = np.dtype(dtype or eb.w.dtype)
    B, E = eb.src.shape
    N = eb.num_nodes
    if N == 0 or B == 0:
        return np.full(B, MISSING, dtype=dtype)
    per_graph_dp = (N + 1) * N * dtype.itemsize
    chunk = max(1, min(B, max_dp_bytes // max(per_graph_dp, 1)))
    out = np.empty(B, dtype=dtype)
    for lo in range(0, B, chunk):
        sub = EdgeBatch(
            eb.src[lo : lo + chunk],
            eb.dst[lo : lo + chunk],
            eb.w[lo : lo + chunk],
            N,
        )
        out[lo : lo + chunk] = _sparse_karp_chunk(sub, dtype)
    return out


def cycle_time_engine(num_nodes: int, num_edges: int, batch: int) -> str:
    """Pick the winning Karp engine for a scoring problem size.

    The dense ``[B, N, N]`` sweep beats the edge-list segment max at
    small N (the reference's CPU measurements in BENCH_sparse_search.json,
    124 ms vs 196 ms at N=64 — short
    contiguous rows amortize better than argsort+reduceat segments)
    and loses badly once E ≪ N² (678 ms vs 414 ms at N=256, 12.6 s vs
    2.0 s at N=1024).  The measured crossover sits between N=64 and
    N=256; the heuristic also keeps dense whenever the edge list is
    nearly square (E ≥ N²/4), where segment bookkeeping is pure
    overhead.  Returns ``"dense"`` or ``"sparse"``.
    """
    n, e = int(num_nodes), int(num_edges)
    if n <= 128 or e * 4 >= n * n:
        return "dense"
    return "sparse"


def batched_cycle_time_auto(
    eb: EdgeBatch, *, dtype: Optional[np.dtype] = None
) -> np.ndarray:
    """Size-dispatched exact cycle time: dense engine below the
    crossover of :func:`cycle_time_engine`, edge-list engine above.

    Both engines run the same f64 Karp DP, so the dispatch never
    changes results, only wall clock (the equivalence suite asserts
    bit identity between them).  This is the scoring entry point the
    searches re-price final candidates through.
    """
    B, E = eb.src.shape
    N = eb.num_nodes
    if cycle_time_engine(N, E, B) == "sparse":
        return batched_cycle_time_sparse(eb, dtype=dtype)
    from .maxplus_vec import batched_cycle_time

    dt = np.dtype(dtype or eb.w.dtype)
    W = np.full((B, N, N), MISSING, dtype=dt)
    present = ~missing_mask(eb.w)
    bb = np.broadcast_to(np.arange(B)[:, None], eb.src.shape)
    # Parallel arcs collapse under max — same semantics as the sparse
    # segment reduction.
    np.maximum.at(
        W, (bb[present], eb.src[present], eb.dst[present]),
        eb.w.astype(dt, copy=False)[present],
    )
    return np.atleast_1d(batched_cycle_time(W, dtype=dt))


def _sparse_karp_chunk(eb: EdgeBatch, dtype: np.dtype) -> np.ndarray:
    B, E = eb.src.shape
    N = eb.num_nodes
    w = eb.w.astype(dtype, copy=False)
    seg = _dst_segments(eb)
    bb = np.arange(B)[:, None]
    D = np.empty((N + 1, B, N), dtype=dtype)
    D[0] = 0.0
    cur = D[0]
    for k in range(1, N + 1):
        vals = cur[bb, eb.src] + w  # [B, E] walk extensions
        cur = _segment_max(vals.ravel(), seg, B * N, dtype).reshape(B, N)
        D[k] = cur
    return karp_from_levels(D)


def reachable_from_sparse(eb: EdgeBatch, start: int = 0) -> np.ndarray:
    """``[B, N]`` bool: vertices reachable from ``start`` (inclusive) by
    the present arcs of each graph.  Frontier propagation to a fixed
    point — at most N-1 sweeps of O(E) each."""
    B, E = eb.src.shape
    N = eb.num_nodes
    present = (eb.w > MISSING) & (eb.src != eb.dst)
    seg = _dst_segments(eb)
    bb = np.arange(B)[:, None]
    reach = np.zeros((B, N), dtype=bool)
    reach[:, start] = True
    for _ in range(max(N - 1, 0)):
        vals = (reach[bb, eb.src] & present).ravel().astype(np.int8)
        hop = _segment_max(vals, seg, B * N, np.float64).reshape(B, N) > 0
        new = reach | hop
        if np.array_equal(new, reach):
            break
        reach = new
    return reach


def _reversed_batch(eb: EdgeBatch) -> EdgeBatch:
    return EdgeBatch(eb.dst, eb.src, eb.w, eb.num_nodes)


def batched_is_strongly_connected_sparse(eb: EdgeBatch) -> np.ndarray:
    """``[B]`` bool: is each edge-list graph strongly connected?

    Strong iff every vertex both reaches and is reached by vertex 0
    (self-loops ignored) — agrees with
    :func:`repro_torch.core.maxplus_vec.batched_is_strongly_connected` on the
    densified graph.
    """
    fwd = reachable_from_sparse(eb)
    bwd = reachable_from_sparse(_reversed_batch(eb))
    return np.all(fwd & bwd, axis=1)


def scc_labels_sparse(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Strongly-connected-component label per vertex of one edge-list
    digraph (flat ``[E]`` int arrays; self-loops ignored).

    Forward–backward peeling: pick the smallest unlabeled vertex, its
    SCC is (reachable ∩ co-reachable) within the unlabeled set, repeat.
    Each peel is O(N·E) worst case; the expected number of peels is small
    on the power-law-ish graphs this engine targets (the classic FW-BW /
    coloring argument).  For small N the dense matrix-power
    :func:`repro_torch.core.maxplus_vec.scc_labels` is faster; for pathological
    chains its Tarjan fallback is.  Labels induce the same partition as
    both (tested), though label *values* may differ.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    N = int(num_nodes)
    labels = np.full(N, -1, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ncomp = 0
    while True:
        unlabeled = np.flatnonzero(labels < 0)
        if unlabeled.size == 0:
            return labels
        pivot = int(unlabeled[0])
        live = labels < 0
        alive = live[src] & live[dst]
        s, d = src[alive], dst[alive]
        fwd = _reach_one(s, d, N, pivot, live)
        bwd = _reach_one(d, s, N, pivot, live)
        comp = fwd & bwd & live
        labels[comp] = ncomp
        ncomp += 1


def _reduced_potentials(
    s: np.ndarray, d: np.ndarray, wr: np.ndarray, N: int, eps: float
) -> np.ndarray:
    """Longest-path potentials under reduced weights ``wr = w - tau``.

    With every cycle's reduced mean <= 0 the sweep reaches its fixed
    point within N iterations; the result satisfies the feasibility
    certificate ``pot[s] + wr <= pot[d]`` (up to ``eps``) on every arc.
    """
    seg = _segments_by(d)
    pot = np.zeros(N, dtype=np.float64)
    for _ in range(N):
        cand = _segment_max(pot[s] + wr, seg, N, np.float64)
        nxt = np.maximum(pot, cand)
        if np.all(nxt <= pot + eps):
            return nxt
        pot = nxt
    return pot


def critical_circuit_sparse(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    num_nodes: int,
    *,
    tau: Optional[float] = None,
) -> Tuple[float, list]:
    """(tau, circuit) attaining the max cycle mean of one edge-list
    digraph — the sparse analogue of
    :func:`repro_torch.core.maxplus_vec.critical_circuit_dense` (kept as the
    oracle), so bottleneck explanation never materializes an ``[N, N]``
    matrix: O(N·E) work, O(N + E) extra memory.

    ``src``/``dst``/``w`` are flat ``[E]`` arrays (``-inf`` = padding).
    Longest-path potentials under the reduced weights ``w - tau`` converge
    in <= N segment-max sweeps; the *tight* arcs
    ``pot[src] + w' >= pot[dst]`` form a subgraph whose non-trivial SCCs
    (plus tight self-loops) carry exactly the circuits of mean ``tau``;
    the returned circuit is a deterministic walk inside one of them,
    closed as ``[v0, ..., v0]`` (empty for acyclic graphs).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    N = int(num_nodes)
    if tau is None:
        tau = float(
            batched_cycle_time_sparse(
                EdgeBatch(
                    src[None].astype(np.int32), dst[None].astype(np.int32),
                    w[None], N,
                )
            )[0]
        )
    if missing_mask(tau) or N == 0:
        return MISSING, []
    present = w > MISSING
    s, d = src[present], dst[present]
    wr = w[present] - tau
    eps = 1e-9 * max(1.0, abs(tau))
    pot = _reduced_potentials(s, d, wr, N, eps)
    tight = pot[s] + wr >= pot[d] - 10 * eps
    ts, td = s[tight], d[tight]
    if ts.size == 0:  # numerically degenerate; caller falls back to dense
        return tau, []
    self_loops = ts[ts == td]
    labels = scc_labels_sparse(ts, td, N)
    counts = np.bincount(labels, minlength=N if labels.size else 0)
    on_cycle = np.zeros(N, dtype=bool)
    on_cycle[self_loops] = True
    multi = counts[labels] >= 2 if labels.size else np.zeros(0, dtype=bool)
    on_cycle[np.flatnonzero(multi)] = True
    hits = np.flatnonzero(on_cycle)
    if hits.size == 0:
        return tau, []
    v0 = int(hits[0])
    if counts.size == 0 or counts[labels[v0]] < 2:
        return tau, [v0, v0]  # tight self-loop
    # Deterministic walk over tight arcs restricted to v0's tight SCC:
    # every vertex there has a tight successor inside the SCC, so the
    # walk revisits a vertex within N steps; any closed tight walk has
    # reduced mean exactly 0, i.e. original mean exactly tau.
    comp = labels[v0]
    in_comp = (labels[ts] == comp) & (labels[td] == comp) & (ts != td)
    cs, cd = ts[in_comp], td[in_comp]
    order = np.lexsort((cd, cs))
    cs, cd = cs[order], cd[order]
    starts = np.searchsorted(cs, np.arange(N))
    ends = np.searchsorted(cs, np.arange(N) + 1)
    pos = {v0: 0}
    walk = [v0]
    cur = v0
    while True:
        lo, hi = starts[cur], ends[cur]
        assert hi > lo, "tight SCC lost the certified circuit"
        cur = int(cd[lo])
        if cur in pos:
            return tau, walk[pos[cur] :] + [cur]
        pos[cur] = len(walk)
        walk.append(cur)


def _reach_one(
    src: np.ndarray, dst: np.ndarray, n: int, start: int, live: np.ndarray
) -> np.ndarray:
    reach = np.zeros(n, dtype=bool)
    reach[start] = True
    while True:
        hop = np.zeros(n, dtype=bool)
        np.logical_or.at(hop, dst, reach[src])
        new = reach | (hop & live)
        if np.array_equal(new, reach):
            return reach
        reach = new


class PricedMove(NamedTuple):
    """The result of :meth:`DeltaPricer.price` — pass to
    :meth:`DeltaPricer.commit` to apply the move.

    ``tau`` is the exact max cycle mean of the *proposed* graph; ``kind``
    records which pricing path produced it (``"fast"``: certificate
    untouched, O(changed arcs); ``"propagated"``: local potential
    repair from the touched endpoints; ``"reanchor"``: full Karp)."""

    tau: float
    kind: str
    slots: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    pot: Optional[np.ndarray]
    crit_arcs: Optional[frozenset]


class DeltaPricer:
    """Incremental max-cycle-mean pricing of one edge-list digraph under
    a stream of arc rewires (the hill-climb hot loop).

    The pricer maintains, alongside the graph itself, a *certificate* of
    its cycle time tau: longest-path potentials ``pot`` under the reduced
    weights ``w - tau`` (feasibility ``pot[s] + w - tau <= pot[d]`` on
    every arc proves every cycle mean <= tau) and one cached critical
    circuit attaining tau (proving some cycle mean == tau).  A proposed
    move — any set of slot rewrites ``(slot, src', dst', w')`` — is then
    priced by checking how it interacts with the certificate:

    * arcs it *weakens* (weight drop / removal / endpoint change) can
      only lower cycle means; if none lies on the cached critical
      circuit, that circuit still attains tau — the lower bound stands;
    * arcs it *strengthens* can only raise cycle means; each is checked
      against the potentials, and violations trigger a bounded local
      propagation (Bellman sweeps from the touched endpoints only).  If
      the propagation converges, the upper bound is repaired at the same
      tau; if any vertex updates more than N times there is a positive
      reduced cycle, i.e. tau genuinely rose.

    Only when a bound actually breaks (critical arc weakened, or a
    positive cycle appears) does the pricer fall back to a full Karp
    re-anchor (:func:`batched_cycle_time_sparse` — the equivalence
    oracle) on the proposed graph.  Random rewire proposals touch the
    certificate with probability ~deg/E, so the common case prices in
    O(deg) work: the order-of-magnitude that makes hill climbs feasible
    at N ~ 10^4.

    Exactness: the returned tau always equals full-Karp-from-scratch on
    the current graph, up to the feasibility tolerance ``eps`` (scale ×
    1e-9); on the fast paths it *is* the previously anchored Karp value,
    bit-for-bit (``tests/test_delta_pricing.py`` property-checks bit
    equality in f64 over random move sequences, including moves that
    disconnect and reconnect the graph).

    Not thread-safe; one pricer per climb state.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        w: np.ndarray,
        num_nodes: int,
        *,
        dtype=np.float64,
    ):
        self.num_nodes = int(num_nodes)
        self._dtype = np.dtype(dtype)
        self._src = np.array(src, dtype=np.int64)
        self._dst = np.array(dst, dtype=np.int64)
        self._w = np.array(w, dtype=self._dtype)
        if not (self._src.ndim == 1 and self._src.shape == self._dst.shape
                == self._w.shape):
            raise ValueError("DeltaPricer expects flat [S] slot arrays")
        self.stats = {"fast": 0, "propagated": 0, "reanchor": 0}
        self._csr_dirty = True
        self._tau, self._pot, self._crit_arcs, self._eps = self._anchor(
            self._src, self._dst, self._w
        )

    # -- public surface ----------------------------------------------------

    @property
    def tau(self) -> float:
        """Exact max cycle mean of the current graph."""
        return self._tau

    def graph(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) copies of the current slot arrays."""
        return self._src.copy(), self._dst.copy(), self._w.copy()

    def price(self, slots, src, dst, w, *, force_full: bool = False) -> PricedMove:
        """Price the graph obtained by rewriting ``slots`` to the given
        endpoints/weights (``w = -inf`` empties a slot), without
        committing.  All four are parallel flat arrays.  ``force_full``
        bypasses the certificate and runs the full-Karp oracle (the
        benchmark's baseline arm, and a drift bound for f32 pricers)."""
        slots = np.asarray(slots, dtype=np.int64)
        src2 = np.asarray(src, dtype=np.int64)
        dst2 = np.asarray(dst, dtype=np.int64)
        w2 = np.asarray(w, dtype=self._dtype)
        if force_full:
            return self._price_full(slots, src2, dst2, w2)
        s0, d0, w0 = self._src[slots], self._dst[slots], self._w[slots]
        moved = (s0 != src2) | (d0 != dst2)
        present0 = w0 > MISSING
        present2 = w2 > MISSING
        weakened = present0 & (moved | (w2 < w0))
        strengthened = present2 & (moved | ~present0 | (w2 > w0))
        crit_hit = self._crit_arcs is None or any(
            (int(a), int(b)) in self._crit_arcs
            for a, b in zip(s0[weakened], d0[weakened])
        )
        if missing_mask(self._tau):
            # Acyclic graph: weakening keeps it acyclic; any strengthened
            # arc may close a cycle — no potentials to reason with.
            if not strengthened.any():
                return PricedMove(self._tau, "fast", slots, src2, dst2, w2,
                                  None, None)
            return self._price_full(slots, src2, dst2, w2)
        if crit_hit and weakened.any():
            return self._price_full(slots, src2, dst2, w2)
        wf = w2.astype(np.float64, copy=False)
        viol = strengthened & (
            self._pot[src2] + wf - self._tau > self._pot[dst2] + self._eps
        )
        if not viol.any():
            return PricedMove(self._tau, "fast", slots, src2, dst2, w2,
                              None, None)
        pot2 = self._propagate(slots, src2, dst2, w2, viol)
        if pot2 is None:  # positive reduced cycle: tau rose
            return self._price_full(slots, src2, dst2, w2)
        return PricedMove(self._tau, "propagated", slots, src2, dst2, w2,
                          pot2, None)

    def commit(self, priced: PricedMove) -> None:
        """Apply a :meth:`price` result to the pricer state."""
        self.stats[priced.kind] += 1
        if ((self._src[priced.slots] != priced.src).any()
                or (self._dst[priced.slots] != priced.dst).any()):
            self._csr_dirty = True
        self._src[priced.slots] = priced.src
        self._dst[priced.slots] = priced.dst
        self._w[priced.slots] = priced.w
        self._tau = priced.tau
        if priced.pot is not None:
            self._pot = priced.pot
        if priced.kind == "reanchor":
            self._crit_arcs = priced.crit_arcs
            scale = max(1.0, abs(priced.tau) if np.isfinite(priced.tau)
                        else 1.0)
            self._eps = (1e-9 if self._dtype.itemsize >= 8 else 1e-4) * scale

    def update(self, slots, src, dst, w) -> float:
        """``price`` + ``commit`` in one call; returns the new tau."""
        priced = self.price(slots, src, dst, w)
        self.commit(priced)
        return priced.tau

    def reanchor(self) -> float:
        """Rebuild the certificate from scratch on the current graph
        (periodic drift bound: under f32 slot weights the fast paths
        carry the anchored tau forward, so a caller can re-anchor every
        K commits to keep accumulated decision error at one oracle call
        of slack).  Returns the re-anchored tau."""
        self._tau, self._pot, self._crit_arcs, self._eps = self._anchor(
            self._src, self._dst, self._w
        )
        self.stats["reanchor"] += 1
        return self._tau

    # -- internals ---------------------------------------------------------

    def _anchor(self, src, dst, w):
        """Full Karp + certificate rebuild on the given arrays (pure —
        does not touch pricer state).  Returns (tau, pot, crit, eps)."""
        N = self.num_nodes
        eb = EdgeBatch(
            src[None].astype(np.int32), dst[None].astype(np.int32),
            w[None], N,
        )
        tau = float(batched_cycle_time_sparse(eb)[0])
        scale = max(1.0, abs(tau) if np.isfinite(tau) else 1.0)
        eps = (1e-9 if self._dtype.itemsize >= 8 else 1e-4) * scale
        if missing_mask(tau):
            pot = np.zeros(N, dtype=np.float64)
            crit: Optional[frozenset] = frozenset()
        else:
            wf = w.astype(np.float64, copy=False)
            present = wf > MISSING
            s, d = src[present], dst[present]
            pot = _reduced_potentials(s, d, wf[present] - tau, N, eps)
            _, circuit = critical_circuit_sparse(src, dst, wf, N, tau=tau)
            # Empty circuit on a cyclic graph = numerically degenerate
            # extraction; None = "unknown": every weakening re-anchors.
            crit = (
                frozenset(zip(circuit[:-1], circuit[1:])) if circuit else None
            )
        return tau, pot, crit, eps

    def _price_full(self, slots, src2, dst2, w2) -> PricedMove:
        """Price a proposal with a full Karp pass on the modified graph."""
        ps, pd, pw = self._src.copy(), self._dst.copy(), self._w.copy()
        ps[slots], pd[slots], pw[slots] = src2, dst2, w2
        tau, pot, crit, _ = self._anchor(ps, pd, pw)
        return PricedMove(tau, "reanchor", slots, src2, dst2, w2, pot, crit)

    def _rebuild_csr(self) -> None:
        order = np.argsort(self._src, kind="stable")
        self._csr_slots = order
        self._csr_start = np.searchsorted(
            self._src[order], np.arange(self.num_nodes + 1)
        )
        self._csr_dirty = False

    def _propagate(self, slots, src2, dst2, w2, viol) -> Optional[np.ndarray]:
        """Bounded Bellman repair of the potentials on the proposed graph.

        Returns the repaired potentials, or ``None`` if a vertex updated
        more than N times (a positive reduced cycle: tau increased)."""
        if self._csr_dirty:
            self._rebuild_csr()
        N = self.num_nodes
        tau, eps = self._tau, self._eps
        pot2 = self._pot.copy()
        moved_slots = {int(s): k for k, s in enumerate(slots)}
        wf = w2.astype(np.float64, copy=False)
        frontier: Dict[int, float] = {}
        for k in np.flatnonzero(viol):
            d = int(dst2[k])
            # host numpy throughout: no device sync to batch
            cand = self._pot[int(src2[k])] + float(wf[k]) - tau
            if cand > frontier.get(d, MISSING):
                frontier[d] = cand
        counts: Dict[int, int] = {}
        csr_slots, csr_start = self._csr_slots, self._csr_start
        cur_src, cur_dst, cur_w = self._src, self._dst, self._w
        while frontier:
            nxt: Dict[int, float] = {}
            for u, p in frontier.items():
                if p <= pot2[u] + eps:
                    continue
                pot2[u] = p
                c = counts.get(u, 0) + 1
                if c > N:
                    return None
                counts[u] = c
                # out-arcs of u in the *proposed* graph: current CSR rows
                # minus rewritten slots, plus the move's own arcs at u.
                for slot in csr_slots[csr_start[u]:csr_start[u + 1]]:
                    k = moved_slots.get(int(slot))
                    if k is not None:
                        continue
                    wv = float(cur_w[slot])
                    if missing_mask(wv):
                        continue
                    v = int(cur_dst[slot])
                    cand = p + wv - tau
                    if cand > pot2[v] + eps and cand > nxt.get(v, MISSING):
                        nxt[v] = cand
                for k, slot in ((k, s) for s, k in moved_slots.items()):
                    if int(src2[k]) != u:
                        continue
                    wv = float(wf[k])
                    if missing_mask(wv):
                        continue
                    v = int(dst2[k])
                    cand = p + wv - tau
                    if cand > pot2[v] + eps and cand > nxt.get(v, MISSING):
                        nxt[v] = cand
            frontier = nxt
        return pot2


@span_fn("engine.price_edges")
def batched_overlay_delay_edges(gc, tp, arcs: Sequence[Arc], masks) -> EdgeBatch:
    """Eq. 3 delay *edge lists* for a batch of candidate overlays.

    Sparse analogue of
    :func:`repro_torch.core.delays.batched_overlay_delay_matrices`: same
    ``arcs`` pool and ``[B, E]`` boolean ``masks`` selection, but the
    result is an :class:`EdgeBatch` of ``E + N`` slots (the arc pool
    followed by the N computation self-loops) instead of a dense
    ``[B, N, N]`` stack — O(B·(E+N)) memory, never O(B·N²).  Masked-off
    arcs become ``-inf`` padding.  Degrees, and therefore the
    access-link-sharing term of Eq. 3, are recomputed per candidate.
    """
    n = gc.num_silos
    index = {v: k for k, v in enumerate(gc.silos)}
    masks = np.asarray(masks, dtype=bool)
    B, E = masks.shape
    if E != len(arcs):
        raise ValueError(f"masks last dim {E} != number of arcs {len(arcs)}")
    comp = np.array(
        [tp.local_steps * gc.silo_params[v].comp_time_ms for v in gc.silos]
    )
    w = np.empty((B, E + n), dtype=np.float64)
    # self-loop slots: always present
    w[:, E:] = comp[None, :]
    if E == 0:
        loops = np.arange(n, dtype=np.int32)
        src = np.broadcast_to(loops, (B, n))
        return EdgeBatch(src, src, w, n)
    asrc = np.array([index[i] for (i, _) in arcs], dtype=np.int32)
    adst = np.array([index[j] for (_, j) in arcs], dtype=np.int32)
    if np.any(asrc == adst):
        raise ValueError("arc pool must not contain self-loops")
    # The arc layout is identical in every row: broadcast views keep the
    # EdgeBatch contract at O(E) instead of O(B·E) storage.
    loops = np.arange(n, dtype=np.int32)
    src = np.broadcast_to(np.concatenate([asrc, loops]), (B, E + n))
    dst = np.broadcast_to(np.concatenate([adst, loops]), (B, E + n))
    lat = np.array([gc.latency_ms[(i, j)] for (i, j) in arcs])
    bwa = np.array([gc.available_bw_gbps[(i, j)] for (i, j) in arcs])
    up = np.array([gc.silo_params[v].uplink_gbps for v in gc.silos])
    dn = np.array([gc.silo_params[v].downlink_gbps for v in gc.silos])
    # Per-candidate degrees: one matmul against arc-endpoint one-hots
    # (cast first: numpy's bool-times-float matmul path is far slower).
    eye = np.eye(n)
    maskf = masks.astype(np.float64)
    out_deg = maskf @ eye[asrc]  # [B, N]
    # Matching-derived pools interleave both directions of every pair
    # ((i,j) at slot 2p, (j,i) at 2p+1) and activate them together, which
    # makes in-degrees equal out-degrees — skip the second matmul then.
    symmetric = (
        E % 2 == 0
        and np.array_equal(asrc[0::2], adst[1::2])
        and np.array_equal(adst[0::2], asrc[1::2])
        and np.array_equal(masks[:, 0::2], masks[:, 1::2])
    )
    in_deg = out_deg if symmetric else maskf @ eye[adst]
    D = int(max(out_deg.max(), in_deg.max(), 1.0))
    if B > 4 * D * D and D * D * E <= (1 << 24):
        # Degree-table path: Eq. 3 depends on the mask row only through
        # (out_deg[src], in_deg[dst]) ∈ [1, D]², so for large batches of
        # degree-bounded overlays (randomized-schedule pricing: B = rounds
        # × chains) it is far cheaper to tabulate the E × D × D possible
        # arc delays once and gather than to re-derive every [B, E] entry.
        # Same expressions in the same order as the general path below —
        # the results are bit-identical, not approximately equal.
        ds = np.arange(1.0, D + 1.0)
        rate_t = np.minimum(
            (up[asrc] / ds[:, None])[:, None, :],  # out-degree on axis 0
            (dn[adst] / ds[:, None])[None, :, :],  # in-degree on axis 1
        )
        rate_t = np.minimum(rate_t, bwa[None, None, :])
        # table[a-1, b-1, e] = delay of arc e at out_deg=a, in_deg=b
        table = comp[asrc][None, None, :] + lat[None, None, :] + (
            tp.model_size_mbits / rate_t
        )
        oi = np.clip(out_deg.astype(np.int32) - 1, 0, D - 1)[:, asrc]
        if symmetric:
            # ii[:, 2p] == oi[:, 2p+1] and vice versa: an even/odd column
            # swap replaces the second [B, E] index gather outright.
            ii = np.ascontiguousarray(
                oi.reshape(B, E // 2, 2)[:, :, ::-1]
            ).reshape(B, E)
        else:
            ii = np.clip(in_deg.astype(np.int32) - 1, 0, D - 1)[:, adst]
        # flat_idx = (oi·D + ii)·E + e, built in place on oi's buffer;
        # masked-off arcs route through a -inf sentinel slot appended to
        # the table (an in-place copyto instead of a boolean scatter).
        oi *= np.int32(D)
        oi += ii
        oi *= np.int32(E)
        oi += np.arange(E, dtype=np.int32)
        np.copyto(oi, np.int32(D * D * E), where=~masks)
        tflat = np.append(table.ravel(), MISSING)
        w[:, :E] = tflat.take(oi)
        return EdgeBatch(src, dst, w, n)
    rate = np.minimum(
        up[asrc][None, :] / np.maximum(out_deg[:, asrc], 1.0),
        dn[adst][None, :] / np.maximum(in_deg[:, adst], 1.0),
    )
    rate = np.minimum(rate, bwa[None, :])
    w[:, :E] = np.where(
        masks, comp[asrc][None, :] + lat[None, :] + tp.model_size_mbits / rate, MISSING
    )
    return EdgeBatch(src, dst, w, n)


# ---------------------------------------------------------------------------
# Batched Karp on a device (torch)


def _padded_edge_layout(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                        num_nodes: int, max_in_degree: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, N*D]`` gather layout for the degree-padded segment max.

    For each destination ``v`` its (up to ``D``) present in-arcs occupy
    slots ``v*D .. v*D+D-1`` as (source index, weight); unused slots
    point at node 0 with ``-inf`` weight so they fold away under max.
    Absent arcs (``-inf`` weight) never consume a slot.  Present arcs
    beyond ``D`` per destination are dropped -- callers must guarantee
    the in-degree bound (the rewire climb passes its degree cap plus
    transient headroom).
    """
    B, E = src.shape
    N, D = int(num_nodes), int(max_in_degree)
    # Absent arcs sort into a virtual segment N so real arcs of a
    # destination are ranked only against each other.
    key = torch.where(torch.isneginf(w), N, dst)
    order = torch.argsort(key, dim=1, stable=True)
    sd = torch.gather(key, 1, order).contiguous()
    ss = torch.gather(src, 1, order)
    ws = torch.gather(w, 1, order)
    first = torch.searchsorted(sd, sd, side="left")
    rank = torch.arange(E, device=src.device)[None, :] - first
    slot = torch.where((rank < D) & (sd < N), sd * D + rank, N * D)
    table = torch.full((B, N * D + 1), E, dtype=torch.int64, device=src.device)
    table.scatter_(1, slot, torch.arange(E, device=src.device).expand(B, E))
    table = table[:, : N * D]
    ssp = torch.cat([ss, ss.new_zeros((B, 1))], dim=1)
    wsp = torch.cat([ws, ws.new_full((B, 1), MISSING)], dim=1)
    return torch.gather(ssp, 1, table), torch.gather(wsp, 1, table)


def batched_cycle_time_sparse_torch(src, dst, w, num_nodes: int, *,
                                    kernel: str = "auto",
                                    max_in_degree: Optional[int] = None
                                    ) -> torch.Tensor:
    """Device twin of :func:`batched_cycle_time_sparse` (the reference's
    ``batched_cycle_time_sparse_jax``): ``[B]`` max cycle means of
    ``[B, E]`` edge lists (``-inf`` padding), on ``w``'s device.

    ``kernel`` picks how the N Karp levels run: ``"auto"`` (the persistent
    K1 recursion on the card; on the CPU the degree-padded gather when
    ``max_in_degree`` is given, else ``"scatter"``), or an explicit
    ``"scatter"`` / ``"padded"`` / ``"cuda"``.  All choices give
    bit-identical results for NaN-free inputs (``"padded"`` also needs
    the in-degree bound to hold).  ``"cuda"`` is one launch of
    :func:`repro_torch.kernels.karp_cycle_time` (its plain version, the
    scatter loop, on the CPU); the other two are a Python loop over the
    levels with no host synchronisation in it.
    """
    w = torch.as_tensor(w)
    src = torch.as_tensor(src, device=w.device)
    dst = torch.as_tensor(dst, device=w.device)
    B = src.shape[0]
    N = int(num_nodes)
    impl = select_segment_max_impl(kernel, padded=max_in_degree is not None,
                                   device=w.device)
    if impl == "cuda":
        return karp_cycle_time(src, dst, w, N)
    if impl == "scatter":
        return karp_cycle_time_ref(src, dst, w, N)
    if max_in_degree is None:
        raise ValueError("kernel='padded' needs max_in_degree")
    D = int(max_in_degree)
    gsrc, gw = _padded_edge_layout(src.long(), dst.long(), w, N, D)

    def step(cur):
        vals = torch.gather(cur, 1, gsrc) + gw
        return vals.view(B, N, D).amax(dim=2)

    return karp_from_step(step, B, N, w.dtype, w.device)


# ---------------------------------------------------------------------------
# The round-varying timing recursion on a device (torch)


def timing_recursion_unique_rounds_sparse_torch(src, dst, w_unique, round_ids, num_nodes: int,
                                                t0=None) -> torch.Tensor:
    """Eq. 4 recursion with round-varying weights drawn from a pool of
    distinct weight rows (the reference's
    ``timing_recursion_unique_rounds_sparse``): round k of chain c runs
    over the arcs ``(src, dst)`` ``[E]`` weighted by
    ``w_unique[round_ids[c, k]]`` (``-inf`` = absent), and a vertex without
    a present self-loop that round keeps its previous start.  Returns
    ``[C, R+1, N]`` start times on ``w_unique``'s device and in its dtype
    (float32 or float64), through
    :func:`repro_torch.kernels.timing_recursion` -- on the card one launch
    of the persistent K1 recursion for every round of every chain, on the
    CPU its plain loop; bit-identical to the reference's numpy engine in
    float64."""
    w_unique = torch.as_tensor(w_unique)
    dev = w_unique.device
    return timing_recursion(torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev),
                            w_unique, torch.as_tensor(round_ids, device=dev), int(num_nodes),
                            None if t0 is None else torch.as_tensor(t0, device=dev))
