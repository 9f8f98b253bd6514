"""Topology design for the Minimal Cycle Time (MCT) problem.

The host designers are a copy of the reference's
``repro/core/topologies.py`` (numpy and Python graph code):

* ``star_overlay``        -- server-client baseline;
* ``mst_overlay``         -- Prim MST on the symmetrized connectivity graph
                            (optimal for edge-capacitated undirected
                            overlays, Prop. 3.1);
* ``ring_overlay``        -- directed ring from Christofides' TSP algorithm
                            (Prop. 3.3 / 3.6), and ``two_opt_ring_overlay``;
* ``delta_prim`` / ``algorithm1_mbst`` -- Algorithm 1 (Appendix D,
                            Prop. 3.5);
* ``search_overlays_delta`` -- the rewire climb priced incrementally on
                            the host (:class:`~repro_torch.core.maxplus_sparse.DeltaPricer`);
* ``brute_force_mct``     -- the exact solver by enumeration, scored by the
                            host's dense Karp engine: an oracle for tiny N.

The rewire climb runs on a torch device (:func:`rewire_climb`): batched
simulated annealing over arc-slot states, every proposal re-priced with
Eq. 3 on the device and scored by the device Karp
(:func:`~repro_torch.core.maxplus_sparse.batched_cycle_time_sparse_torch`)
and tested for strong connectivity
(:func:`~repro_torch.kernels.reach_from_zero`); on the card each of the
two is one launch of a hand-written persistent kernel that runs every
level of its recursion.  :func:`search_overlays_jit` (one connectivity
universe, all restarts) and :func:`search_overlays_hierarchical` (one
universe per cluster, every cluster's search in one climb) drive it, and
:func:`design_overlay` is the registry callers design through.

An *overlay* is a list of **directed** edges; undirected topologies
contain both directions of every link.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Hashable, Iterable, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import reach_from_zero
from ..obs.spans import span_fn
from .delays import (
    ConnectivityGraph,
    TrainingParams,
    batched_overlay_delay_matrices,
    node_capacitated_sym_delay_ms,
    overlay_delay_matrix,
    symmetrized_delay_ms,
)
from .maxplus_sparse import (
    DeltaPricer,
    batched_cycle_time_auto,
    batched_cycle_time_sparse_torch,
    batched_is_strongly_connected_sparse,
    batched_overlay_delay_edges,
)
from .maxplus_vec import (
    MISSING,
    batched_cycle_time,
    batched_is_strongly_connected,
    cycle_time_dense,
)

Node = Hashable
Edge = Tuple[Node, Node]


@dataclass(frozen=True)
class Overlay:
    """A designed overlay with its realized cycle time."""

    name: str
    edges: Tuple[Edge, ...]  # directed
    cycle_time_ms: float

    @property
    def undirected_edges(self) -> Set[FrozenSet[Node]]:
        return {frozenset(e) for e in self.edges}

    def out_degree(self, v: Node) -> int:
        return sum(1 for (i, _) in self.edges if i == v)

    def in_degree(self, v: Node) -> int:
        return sum(1 for (_, j) in self.edges if j == v)


def evaluate_overlay(
    gc: ConnectivityGraph, tp: TrainingParams, edges: Sequence[Edge], name: str = "custom"
) -> Overlay:
    """Price a directed edge list with Eq. 3 and return it as an
    :class:`Overlay` with its exact (f64 dense-engine) cycle time.
    Raises ``ValueError`` if the edges do not form a strongly-connected
    digraph over ``gc.silos``."""
    W = overlay_delay_matrix(gc, tp, edges)
    if not batched_is_strongly_connected(W):
        raise ValueError(f"overlay {name!r} is not strongly connected")
    return Overlay(name=name, edges=tuple(edges), cycle_time_ms=cycle_time_dense(W))


def _sym_edges(gc: ConnectivityGraph) -> List[Tuple[Node, Node]]:
    """Unordered silo pairs present in both directions (G_c^(u))."""
    out = []
    seen = set()
    for (i, j) in gc.latency_ms:
        key = frozenset((i, j))
        if key in seen or i == j:
            continue
        if gc.has_edge(j, i):
            seen.add(key)
            out.append((i, j))
    return out


def _bidir(edges: Sequence[Tuple[Node, Node]]) -> List[Edge]:
    out: List[Edge] = []
    for (i, j) in edges:
        out.append((i, j))
        out.append((j, i))
    return out


def star_overlay(
    gc: ConnectivityGraph, tp: TrainingParams, center: Optional[Node] = None
) -> Overlay:
    """Server-client (FedAvg) baseline.

    One communication round is *two-phase* (Appendix B): every silo uploads
    to the orchestrator, which aggregates and pushes the refined model back.
    The orchestrator performs no local training (its loss is constant), so

        tau_STAR = max_l [ s*T_c(l) + l(l,c) + M/min(C_UP(l), C_DN(c)/N, A) ]
                 + max_l [           l(c,l) + M/min(C_UP(c)/N, C_DN(l), A) ]

    which recovers Appendix B's 2N*M/C in the slow-homogeneous-access-link
    regime.  (The generic max-plus circuit mean would halve this because a
    FedAvg round spans two ticks of the recursion.)
    """
    if center is None:
        # Highest-closeness silo in latency space when no underlay info.
        def closeness(v: Node) -> float:
            return sum(gc.latency_ms[(v, u)] for u in gc.silos if u != v)

        center = min(gc.silos, key=closeness)
    leaves = [v for v in gc.silos if v != center]
    n = len(leaves)
    cp = gc.silo_params[center]
    up_phase = 0.0
    dn_phase = 0.0
    for l in leaves:
        lp = gc.silo_params[l]
        up_rate = min(lp.uplink_gbps, cp.downlink_gbps / n, gc.available_bw_gbps[(l, center)])
        dn_rate = min(cp.uplink_gbps / n, lp.downlink_gbps, gc.available_bw_gbps[(center, l)])
        up_phase = max(
            up_phase,
            tp.local_steps * lp.comp_time_ms
            + gc.latency_ms[(l, center)]
            + tp.model_size_mbits / up_rate,
        )
        dn_phase = max(
            dn_phase, gc.latency_ms[(center, l)] + tp.model_size_mbits / dn_rate
        )
    edges = []
    for v in leaves:
        edges.append((center, v))
        edges.append((v, center))
    return Overlay(name="star", edges=tuple(edges), cycle_time_ms=up_phase + dn_phase)


def mst_edges(
    gc: ConnectivityGraph,
    weight: Callable[[Node, Node], float],
) -> List[Tuple[Node, Node]]:
    """Prim MST over G_c^(u) with the given symmetric weight."""
    pairs = _sym_edges(gc)
    adj: Dict[Node, List[Tuple[Node, float]]] = {v: [] for v in gc.silos}
    for (i, j) in pairs:
        w = weight(i, j)
        adj[i].append((j, w))
        adj[j].append((i, w))
    import heapq

    start = gc.silos[0]
    visited = {start}
    pq: List[Tuple[float, int, Node, Node]] = []
    tiebreak = itertools.count()
    for (v, w) in adj[start]:
        heapq.heappush(pq, (w, next(tiebreak), start, v))
    tree: List[Tuple[Node, Node]] = []
    while pq and len(visited) < len(gc.silos):
        w, _, u, v = heapq.heappop(pq)
        if v in visited:
            continue
        visited.add(v)
        tree.append((u, v))
        for (x, wx) in adj[v]:
            if x not in visited:
                heapq.heappush(pq, (wx, next(tiebreak), v, x))
    if len(visited) != len(gc.silos):
        raise ValueError("connectivity graph (symmetrized) is not connected")
    return tree


def mst_overlay(gc: ConnectivityGraph, tp: TrainingParams) -> Overlay:
    """MST on the symmetrized connectivity delays, both arc directions
    kept — optimal among undirected overlays on edge-capacitated
    networks (Prop. 3.1)."""
    tree = mst_edges(gc, lambda i, j: symmetrized_delay_ms(gc, tp, i, j))
    ov = evaluate_overlay(gc, tp, _bidir(tree), name="mst")
    return ov


def christofides_tour(nodes: Sequence[Node], weight: Callable[[Node, Node], float]) -> List[Node]:
    """Christofides' 1.5-approximation for metric TSP.

    MST + minimum-weight perfect matching on odd-degree vertices (greedy
    matching — keeps the classical guarantee structure; exact blossom is
    overkill at N<=100 and greedy is the standard engineering choice) +
    Eulerian circuit + shortcutting.
    """
    nodes = list(nodes)
    n = len(nodes)
    if n == 1:
        return nodes
    if n == 2:
        return nodes
    # MST (Prim, dense)
    in_tree = [False] * n
    best = [math.inf] * n
    best_to = [-1] * n
    in_tree[0] = True
    for j in range(1, n):
        best[j] = weight(nodes[0], nodes[j])
        best_to[j] = 0
    mst_adj: Dict[int, List[int]] = {i: [] for i in range(n)}
    for _ in range(n - 1):
        v = min((j for j in range(n) if not in_tree[j]), key=lambda j: best[j])
        mst_adj[v].append(best_to[v])
        mst_adj[best_to[v]].append(v)
        in_tree[v] = True
        for j in range(n):
            if not in_tree[j]:
                w = weight(nodes[v], nodes[j])
                if w < best[j]:
                    best[j] = w
                    best_to[j] = v
    # Odd-degree vertices -> greedy min-weight perfect matching
    odd = [v for v in range(n) if len(mst_adj[v]) % 2 == 1]
    pairs = sorted(
        ((weight(nodes[a], nodes[b]), a, b) for k, a in enumerate(odd) for b in odd[k + 1 :]),
    )
    matched: Set[int] = set()
    for (_, a, b) in pairs:
        if a not in matched and b not in matched:
            matched.add(a)
            matched.add(b)
            mst_adj[a].append(b)
            mst_adj[b].append(a)
    # Eulerian circuit (Hierholzer) on the multigraph
    adj_copy: Dict[int, List[int]] = {v: list(ns) for v, ns in mst_adj.items()}
    stack = [0]
    circuit: List[int] = []
    while stack:
        v = stack[-1]
        if adj_copy[v]:
            u = adj_copy[v].pop()
            adj_copy[u].remove(v)
            stack.append(u)
        else:
            circuit.append(stack.pop())
    # Shortcut repeated vertices
    seen: Set[int] = set()
    tour: List[int] = []
    for v in circuit:
        if v not in seen:
            seen.add(v)
            tour.append(v)
    return [nodes[v] for v in tour]


def ring_overlay(gc: ConnectivityGraph, tp: TrainingParams) -> Overlay:
    """Directed ring from Christofides on the symmetrized connectivity
    delays (the paper's RING, Prop. 3.3/3.6)."""
    tour = christofides_tour(
        list(gc.silos), lambda i, j: symmetrized_delay_ms(gc, tp, i, j)
    )
    edges = [(tour[k], tour[(k + 1) % len(tour)]) for k in range(len(tour))]
    return evaluate_overlay(gc, tp, edges, name="ring")


def two_opt_ring_overlay(
    gc: ConnectivityGraph, tp: TrainingParams, max_rounds: int = 20
) -> Overlay:
    """Beyond-paper: Christofides tour refined with 2-opt on symmetrized
    delays, then evaluated with the true (node-capacitated) cycle time."""
    tour = christofides_tour(
        list(gc.silos), lambda i, j: symmetrized_delay_ms(gc, tp, i, j)
    )
    w = lambda i, j: symmetrized_delay_ms(gc, tp, i, j)
    n = len(tour)
    improved = True
    rounds = 0
    while improved and rounds < max_rounds:
        improved = False
        rounds += 1
        for a in range(n - 1):
            for b in range(a + 2, n - (1 if a == 0 else 0)):
                i, inext = tour[a], tour[a + 1]
                j, jnext = tour[b], tour[(b + 1) % n]
                delta = (w(i, j) + w(inext, jnext)) - (w(i, inext) + w(j, jnext))
                if delta < -1e-9:
                    tour[a + 1 : b + 1] = reversed(tour[a + 1 : b + 1])
                    improved = True
    edges = [(tour[k], tour[(k + 1) % n]) for k in range(n)]
    return evaluate_overlay(gc, tp, edges, name="ring_2opt")


def delta_prim(
    gc: ConnectivityGraph,
    weight: Callable[[Node, Node], float],
    delta: int,
) -> List[Tuple[Node, Node]]:
    """Degree-bounded Prim: grow a tree always picking the smallest-weight
    edge whose tree endpoint has degree < delta (Algorithm 2, [2])."""
    nodes = list(gc.silos)
    pairs = _sym_edges(gc)
    wmap: Dict[FrozenSet[Node], float] = {frozenset(p): weight(*p) for p in pairs}
    in_tree: Set[Node] = {nodes[0]}
    degree: Dict[Node, int] = {v: 0 for v in nodes}
    tree: List[Tuple[Node, Node]] = []
    while len(in_tree) < len(nodes):
        cand: Optional[Tuple[float, Node, Node]] = None
        for u in in_tree:
            if degree[u] >= delta:
                continue
            for v in nodes:
                if v in in_tree:
                    continue
                key = frozenset((u, v))
                if key not in wmap:
                    continue
                w = wmap[key]
                if cand is None or w < cand[0]:
                    cand = (w, u, v)
        if cand is None:
            raise ValueError(f"delta-PRIM stuck: no degree-<{delta} expansion edge")
        _, u, v = cand
        tree.append((u, v))
        degree[u] += 1
        degree[v] += 1
        in_tree.add(v)
    return tree


def _cube_hamiltonian_path(tree_adj: Dict[Node, List[Node]], root: Node) -> List[Node]:
    """Hamiltonian path in the cube of a tree via a pre-order DFS walk.

    A DFS pre-order of a tree visits consecutive vertices at tree distance
    <= 3 when children subtrees are walked contiguously — the classical
    construction behind Karaganis' theorem [43] used by [3, Sect. 3.2.1].
    """
    order: List[Node] = []
    stack: List[Node] = [root]
    seen: Set[Node] = set()
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        order.append(v)
        for u in reversed(tree_adj[v]):
            if u not in seen:
                stack.append(u)
    return order


def algorithm1_mbst(gc: ConnectivityGraph, tp: TrainingParams) -> Overlay:
    """Algorithm 1 (Appendix D): candidates = {Hamiltonian path in MST^3}
    ∪ {δ-PRIM trees, δ=3..N}; return the candidate with the smallest
    *true* cycle time (node-capacitated Eq. 3 evaluation)."""
    weight = lambda i, j: node_capacitated_sym_delay_ms(gc, tp, i, j)
    candidates: List[Tuple[str, List[Tuple[Node, Node]]]] = []
    # 2-MBST approximation: Hamiltonian path in the cube of the MST.
    mst = mst_edges(gc, weight)
    adj: Dict[Node, List[Node]] = {v: [] for v in gc.silos}
    for (u, v) in mst:
        adj[u].append(v)
        adj[v].append(u)
    ham = _cube_hamiltonian_path(adj, gc.silos[0])
    path_edges = list(zip(ham[:-1], ham[1:]))
    # The cube path may use pairs missing from G_c^(u) if it is not complete;
    # only keep the candidate if all pairs exist.
    if all(gc.has_edge(i, j) and gc.has_edge(j, i) for (i, j) in path_edges):
        candidates.append(("2mbst_path", path_edges))
    for delta in range(3, gc.num_silos):
        try:
            candidates.append((f"{delta}-prim", delta_prim(gc, weight, delta)))
        except ValueError:
            continue
    # Score every candidate in one batched engine call.
    cand_edges = [_bidir(tree) for (_, tree) in candidates]
    W = np.stack([overlay_delay_matrix(gc, tp, e) for e in cand_edges])
    strong = batched_is_strongly_connected(W)
    taus = np.where(strong, batched_cycle_time(W), np.inf)
    k = int(np.argmin(taus))
    if not np.isfinite(taus[k]):
        raise ValueError("no strongly-connected delta-MBST candidate")
    return Overlay(
        name="delta_mbst", edges=tuple(cand_edges[k]), cycle_time_ms=float(taus[k])
    )


# ---------------------------------------------------------------------------
# Exact solver (for tests on small instances)

_BF_MAX_NODES = 7      # the enumeration is exponential in the arc count
_BF_BATCH = 4096       # candidate overlays scored per engine call


def _best_masked_candidate(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    arcs: List[Edge],
    subsets: Iterable[Tuple[int, ...]],
    best_tau: float,
    best_rows: Optional[List[int]],
) -> Tuple[float, Optional[List[int]]]:
    """Scan candidate arc-index subsets in batched engine calls.

    Returns the best (cycle time, arc-index list) seen, seeded with the
    incoming incumbent.  Non-strongly-connected candidates are skipped.
    """
    E = len(arcs)
    buf: List[Tuple[int, ...]] = []

    def flush() -> Tuple[float, Optional[List[int]]]:
        nonlocal best_tau, best_rows
        masks = np.zeros((len(buf), E), dtype=bool)
        for k, subset in enumerate(buf):
            masks[k, list(subset)] = True
        W = batched_overlay_delay_matrices(gc, tp, arcs, masks)
        strong = np.nonzero(batched_is_strongly_connected(W))[0]
        if strong.size:
            taus = batched_cycle_time(W[strong])
            k = int(np.argmin(taus))
            if taus[k] < best_tau:
                best_tau = float(taus[k])
                best_rows = list(buf[int(strong[k])])
        buf.clear()
        return best_tau, best_rows

    for subset in subsets:
        buf.append(subset)
        if len(buf) >= _BF_BATCH:
            best_tau, best_rows = flush()
    if buf:
        best_tau, best_rows = flush()
    return best_tau, best_rows


def brute_force_mct(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    undirected: bool = False,
    exhaustive: bool = True,
) -> Overlay:
    """Exact MCT solver by enumeration (exponential: tests and small N only).

    Candidates are scored through the batched max-plus engine on the host,
    thousands of overlays per call.  With ``exhaustive=True`` (default)
    every arc count is enumerated, which a *certificate* of optimality
    needs: minimally strong digraphs can have up to 2(N-1) arcs (e.g.
    bidirected trees), so the heuristic cut at ``r >= N + 2`` arcs could
    return a suboptimal overlay.  ``exhaustive=False`` re-enables that cut
    as a cheap heuristic.
    """
    n = gc.num_silos
    if n > _BF_MAX_NODES:
        raise ValueError("brute force limited to tiny instances")
    best_tau = math.inf
    best_rows: Optional[List[int]] = None
    if undirected:
        pairs = _sym_edges(gc)
        arcs = _bidir(pairs)  # pair p -> arc rows 2p, 2p+1
        for r in range(n - 1, len(pairs) + 1):
            subsets = (
                tuple(a for p in combo for a in (2 * p, 2 * p + 1))
                for combo in itertools.combinations(range(len(pairs)), r)
            )
            best_tau, best_rows = _best_masked_candidate(
                gc, tp, arcs, subsets, best_tau, best_rows)
        if best_rows is None:
            raise ValueError("no strongly-connected undirected overlay")
        return Overlay(name="bf", edges=tuple(arcs[a] for a in best_rows),
                       cycle_time_ms=best_tau)
    arcs = [e for e in gc.edges() if e[0] != e[1]]
    # Prune: a strong digraph needs >= n arcs.
    for r in range(n, len(arcs) + 1):
        best_tau, best_rows = _best_masked_candidate(
            gc, tp, arcs, itertools.combinations(range(len(arcs)), r),
            best_tau, best_rows)
        if not exhaustive and best_rows is not None and r >= n + 2:
            break  # heuristic cut: may miss optima that need many arcs
    if best_rows is None:
        raise ValueError("no strongly-connected overlay")
    return Overlay(name="bf", edges=tuple(arcs[a] for a in best_rows), cycle_time_ms=best_tau)


def _degrees_ok(arcs: Sequence[Tuple[int, int]], n: int, delta: int) -> bool:
    out = np.zeros(n, dtype=np.int64)
    inn = np.zeros(n, dtype=np.int64)
    for (i, j) in arcs:
        out[i] += 1
        inn[j] += 1
    return bool(out.max(initial=0) <= delta and inn.max(initial=0) <= delta)


def _seed_states(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    index: Dict[Node, int],
    n_restarts: int,
    slots: int,
    delta_max: int,
    rng: np.random.Generator,
    incumbent: Optional[Overlay],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[List[Tuple[int, int]]]]:
    """Initial ``[B, S]`` arc-slot states for the rewire climb, plus the
    list of structured seed arc lists (for exact f64 re-pricing).

    Restart seeds: the incumbent overlay (if given), the Christofides
    ring, the bidirected MST, then random Hamiltonian rings.  Seeds
    violating the ``delta_max`` degree bound are skipped — they would
    score ``+inf`` forever and burn their restart's whole move budget.
    On a non-complete connectivity graph random rings routinely hit
    unrouted pairs (instant ``+inf``), so the remaining restarts cycle
    over the feasible seeds instead.
    """
    n = gc.num_silos
    seeds: List[List[Tuple[int, int]]] = []
    if incumbent is not None and all(
        i in index and j in index and gc.has_edge(i, j)
        for (i, j) in incumbent.edges
        if i != j
    ):  # churn / link failure can invalidate the incumbent's silos or arcs
        edges = sorted(
            {(index[i], index[j]) for (i, j) in incumbent.edges if i != j}
        )
        if 0 < len(edges) <= slots and _degrees_ok(edges, n, delta_max):
            seeds.append(edges)
    try:  # Christofides ring: the strongest cheap designer (Prop. 3.3)
        tour = christofides_tour(
            list(gc.silos), lambda i, j: symmetrized_delay_ms(gc, tp, i, j)
        )
        ring_arcs = [
            (index[tour[k]], index[tour[(k + 1) % len(tour)]])
            for k in range(len(tour))
        ]
        if all(
            gc.has_edge(gc.silos[a], gc.silos[b]) for (a, b) in ring_arcs
        ):
            seeds.append(ring_arcs)
    except (ValueError, KeyError):
        pass
    try:
        tree = mst_edges(gc, lambda i, j: symmetrized_delay_ms(gc, tp, i, j))
        mst_arcs = [(index[i], index[j]) for (i, j) in _bidir(tree)]
        if len(mst_arcs) <= slots and _degrees_ok(mst_arcs, n, delta_max):
            seeds.append(mst_arcs)
    except ValueError:
        pass
    full_mesh = len([1 for (i, j) in gc.latency_ms if i != j]) == n * (n - 1)
    asrc = np.zeros((n_restarts, slots), dtype=np.int32)
    adst = np.zeros((n_restarts, slots), dtype=np.int32)
    aact = np.zeros((n_restarts, slots), dtype=bool)
    for b in range(n_restarts):
        if b < len(seeds):
            arcs = seeds[b]
        elif full_mesh or not seeds:
            perm = rng.permutation(n)
            arcs = [
                (int(perm[k]), int(perm[(k + 1) % n])) for k in range(n)
            ]
        else:
            arcs = seeds[b % len(seeds)]
        m = len(arcs)
        asrc[b, :m] = [a for (a, _) in arcs]
        adst[b, :m] = [a for (_, a) in arcs]
        aact[b, :m] = True
    return asrc, adst, aact, seeds


def _reprice_candidates(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    candidates: List[List[Tuple[int, int]]],
    name: str,
) -> Overlay:
    """Exact f64 re-pricing of index-space candidate arc lists through
    the size-dispatched engine; returns the best strongly-connected one.

    The climbs accept moves by approximate (f32 / delta-certificate)
    score, so comparing the final candidates exactly here is what turns
    "never worse than the seeds" from approximate into exact."""
    if not candidates:
        raise ValueError(
            f"{name} search found no strongly-connected candidate")
    pool = sorted({a for arcs in candidates for a in arcs})
    pool_index = {a: k for k, a in enumerate(pool)}
    masks = np.zeros((len(candidates), len(pool)), dtype=bool)
    for c, arcs in enumerate(candidates):
        masks[c, [pool_index[a] for a in arcs]] = True
    pool_lbl = [(gc.silos[i], gc.silos[j]) for (i, j) in pool]
    eb = batched_overlay_delay_edges(gc, tp, pool_lbl, masks)
    strong = batched_is_strongly_connected_sparse(eb)
    taus = np.where(strong, batched_cycle_time_auto(eb), np.inf)
    k = int(np.argmin(taus))
    if not np.isfinite(taus[k]):
        raise ValueError(
            f"{name} search found no strongly-connected candidate")
    edges = tuple(pool_lbl[e] for e in np.nonzero(masks[k])[0])
    return Overlay(name=name, edges=edges, cycle_time_ms=float(taus[k]))


# Below this many silos the device climb is cheaper than host-side
# proposal bookkeeping; above it, per-proposal Karp dominates and the
# O(deg) delta pricer wins.
_DELTA_ENGINE_MIN_N = 384


def _strong_arcs(n: int, arcs: Iterable[Tuple[int, int]]) -> bool:
    """Strong connectivity of an index-space arc set (host BFS both ways)."""
    adj: List[List[int]] = [[] for _ in range(n)]
    radj: List[List[int]] = [[] for _ in range(n)]
    for (u, v) in arcs:
        adj[u].append(v)
        radj[v].append(u)

    def full(a: List[List[int]]) -> bool:
        seen = bytearray(n)
        seen[0] = 1
        stack = [0]
        count = 1
        while stack:
            x = stack.pop()
            for y in a[x]:
                if not seen[y]:
                    seen[y] = 1
                    count += 1
                    stack.append(y)
        return count == n

    return full(adj) and full(radj)


@span_fn("designer.search_delta")
def search_overlays_delta(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_restarts: int = 4,
    n_steps: int = 768,
    delta_max: int = 8,
    max_arcs: Optional[int] = None,
    seed: int = 0,
    incumbent: Optional[Overlay] = None,
    pricing: str = "delta",
    reanchor_every: int = 1024,
    sa_t0: float = 0.05,
    sa_t1: float = 1e-3,
    stats_out: Optional[Dict[str, int]] = None,
) -> Overlay:
    """Host-side rewire search with **delta-evaluated** cycle-time
    pricing (:class:`repro_torch.core.maxplus_sparse.DeltaPricer`).

    Same move set as the device climb — endpoint swap, arc add, arc
    drop, 2-opt double rewire — and the same simulated-annealing
    acceptance, but each proposal is priced incrementally: the pricer
    keeps per-node longest-path potentials and a critical circuit as a
    certificate of the current tau, so a move that touches O(deg) arcs
    re-prices in O(deg) instead of a full O(N·E) Karp pass.  Weight
    maintenance is incremental too: a move perturbs silo degrees, and
    only the arcs incident to those silos re-derive their Eq. 3 delay
    (the degree-dependent access-link sharing term).  Together this is
    what pushes the feasible search size from ~10^3 to ~10^4 silos.

    ``pricing="full"`` forces the full-Karp oracle on every proposal —
    the benchmark's baseline arm for the >= 5x proposals/s acceptance
    gate.  ``reanchor_every`` bounds certificate drift by rebuilding it
    from scratch every K accepted moves (with the default f64 pricer
    the fast paths are already bit-exact; the knob exists for f32
    pricers and as a belt-and-suspenders invariant).  ``stats_out``
    (optional dict) receives proposal/accept counters and the pricer's
    fast/propagated/reanchor path counts.

    Returns the best of {per-restart best states, structured seeds},
    re-priced exactly like every other search (``name="delta_rewire"``).
    """
    n = gc.num_silos
    if n < 2:
        raise ValueError("delta-rewire search needs at least 2 silos")
    if pricing not in ("delta", "full"):
        raise ValueError(f"unknown pricing mode {pricing!r}")
    index = {v: k for k, v in enumerate(gc.silos)}
    slots = max(max_arcs if max_arcs is not None else 2 * n, n)
    if incumbent is not None:
        slots = max(slots, len({e for e in incumbent.edges if e[0] != e[1]}))
    latd: Dict[Tuple[int, int], Tuple[float, float]] = {}
    nbr: List[List[int]] = [[] for _ in range(n)]
    for (i, j), l in gc.latency_ms.items():
        if i == j:
            continue
        a, b = index[i], index[j]
        # host dict of python floats: nothing here touches a device
        latd[(a, b)] = (float(l), float(gc.available_bw_gbps[(i, j)]))
        nbr[a].append(b)
    nbrs = [
        np.array(v, dtype=np.int64) if v else np.empty(0, dtype=np.int64)
        for v in nbr
    ]
    comp = np.array(
        [tp.local_steps * gc.silo_params[v].comp_time_ms for v in gc.silos],
        dtype=np.float64,
    )
    up = np.array(
        [gc.silo_params[v].uplink_gbps for v in gc.silos], dtype=np.float64
    )
    dn = np.array(
        [gc.silo_params[v].downlink_gbps for v in gc.silos], dtype=np.float64
    )
    mbits = float(tp.model_size_mbits)

    def arc_w(u: int, v: int, od: int, idg: int) -> float:
        # Same expressions in the same order as batched_overlay_delay_edges
        # so search-time weights match the exact re-pricing bit-for-bit.
        l, bwv = latd[(u, v)]
        rate = min(min(up[u] / max(od, 1.0), dn[v] / max(idg, 1.0)), bwv)
        return comp[u] + l + mbits / rate

    rng = np.random.default_rng(seed)
    asrc, adst, aact, seed_arcs = _seed_states(
        gc, tp, index, n_restarts, slots, delta_max, rng, incumbent
    )
    totals = {"proposals": 0, "accepts": 0, "fast": 0, "propagated": 0,
              "reanchor": 0}
    candidates: List[List[Tuple[int, int]]] = []
    for b in range(n_restarts):
        arcs0: List[Tuple[int, int]] = []
        seen: Set[Tuple[int, int]] = set()
        for s, d, a in zip(asrc[b], adst[b], aact[b]):
            arc = (int(s), int(d))
            # Random-ring seeds may propose unrouted pairs on sparse
            # connectivity graphs; the climb starts from the routable
            # subset and reconnects through add moves.
            if a and arc in latd and arc not in seen:
                seen.add(arc)
                arcs0.append(arc)
        best = _delta_climb_one(
            n, slots, arcs0, latd, nbrs, arc_w, comp, delta_max,
            int(n_steps), rng, pricing, int(reanchor_every),
            float(sa_t0), float(sa_t1), totals,
        )
        if best is not None:
            candidates.append(best)
    candidates.extend(seed_arcs)
    if stats_out is not None:
        stats_out.update(totals)
    return _reprice_candidates(gc, tp, candidates, "delta_rewire")


def _delta_climb_one(
    n: int,
    slots: int,
    arcs0: List[Tuple[int, int]],
    latd: Dict[Tuple[int, int], Tuple[float, float]],
    nbrs: List[np.ndarray],
    arc_w: Callable[[int, int, int, int], float],
    comp: np.ndarray,
    delta_max: int,
    n_steps: int,
    rng: np.random.Generator,
    pricing: str,
    reanchor_every: int,
    sa_t0: float,
    sa_t1: float,
    totals: Dict[str, int],
) -> Optional[List[Tuple[int, int]]]:
    """One delta-priced annealing climb; returns the best feasible arc
    list found (index space), or None if no strongly-connected state was
    ever visited."""
    S = slots
    ssrc = np.zeros(S + n, dtype=np.int64)
    sdst = np.zeros(S + n, dtype=np.int64)
    sw = np.full(S + n, MISSING, dtype=np.float64)
    # Self-loop slots S..S+n-1 carry the computation delays (Eq. 3's
    # always-present diagonal) and never move.
    ssrc[S:] = np.arange(n)
    sdst[S:] = np.arange(n)
    sw[S:] = comp
    out_deg = np.zeros(n, dtype=np.int64)
    in_deg = np.zeros(n, dtype=np.int64)
    out_slots: List[Set[int]] = [set() for _ in range(n)]
    in_slots: List[Set[int]] = [set() for _ in range(n)]
    arc_slot: Dict[Tuple[int, int], int] = {}
    for s, (u, v) in enumerate(arcs0):
        ssrc[s], sdst[s] = u, v
        out_deg[u] += 1
        in_deg[v] += 1
        out_slots[u].add(s)
        in_slots[v].add(s)
        arc_slot[(u, v)] = s
    for s, (u, v) in enumerate(arcs0):
        sw[s] = arc_w(u, v, int(out_deg[u]), int(in_deg[v]))
    free = list(range(S - 1, len(arcs0) - 1, -1))  # stack of empty slots
    act_list: List[int] = list(range(len(arcs0)))
    act_pos: Dict[int, int] = {s: k for k, s in enumerate(act_list)}

    def act_add(s: int) -> None:
        act_pos[s] = len(act_list)
        act_list.append(s)

    def act_remove(s: int) -> None:
        i = act_pos.pop(s)
        last = act_list.pop()
        if last != s:
            act_list[i] = last
            act_pos[last] = i

    dp = DeltaPricer(ssrc, sdst, sw, n)
    cur_strong = _strong_arcs(n, arc_slot.keys())
    best_arcs = list(arc_slot.keys()) if cur_strong else None
    btau = dp.tau if cur_strong else np.inf
    accepts = 0
    denom = float(max(n_steps - 1, 1))
    force_full = pricing == "full"

    def reweight(upd, dout, din, moved):
        """Re-derive Eq. 3 weights of arcs incident to degree changes."""
        for node, dd in dout.items():
            if dd:
                for s2 in out_slots[node]:
                    if s2 in moved:
                        continue
                    uu, vv = int(ssrc[s2]), int(sdst[s2])
                    upd[s2] = (uu, vv, arc_w(
                        uu, vv,
                        int(out_deg[uu]) + dout.get(uu, 0),
                        int(in_deg[vv]) + din.get(vv, 0)))
        for node, dd in din.items():
            if dd:
                for s2 in in_slots[node]:
                    if s2 in moved:
                        continue
                    uu, vv = int(ssrc[s2]), int(sdst[s2])
                    upd[s2] = (uu, vv, arc_w(
                        uu, vv,
                        int(out_deg[uu]) + dout.get(uu, 0),
                        int(in_deg[vv]) + din.get(vv, 0)))

    for t in range(n_steps):
        totals["proposals"] += 1
        mtype = int(rng.integers(0, 4))
        upd: Dict[int, Tuple[int, int, float]] = {}
        dout: Dict[int, int] = {}
        din: Dict[int, int] = {}
        structural = True  # does the move remove/redirect any arc?
        if mtype == 0:  # endpoint swap: (u, v) -> (u, v2)
            if not act_list:
                continue
            s = act_list[int(rng.integers(len(act_list)))]
            u, v = int(ssrc[s]), int(sdst[s])
            cand = nbrs[u]
            if cand.size == 0:
                continue
            v2 = int(cand[int(rng.integers(cand.size))])
            if v2 == v or v2 == u or (u, v2) in arc_slot:
                continue
            if in_deg[v2] + 1 > delta_max:
                continue
            din[v] = din.get(v, 0) - 1
            din[v2] = din.get(v2, 0) + 1
            reweight(upd, dout, din, {s})
            upd[s] = (u, v2, arc_w(
                u, v2, int(out_deg[u]), int(in_deg[v2]) + 1))
            removed, added = ((u, v),), ((u, v2),)
        elif mtype == 1:  # add
            if not free:
                continue
            u = int(rng.integers(n))
            cand = nbrs[u]
            if cand.size == 0:
                continue
            v = int(cand[int(rng.integers(cand.size))])
            if (u, v) in arc_slot:
                continue
            if out_deg[u] + 1 > delta_max or in_deg[v] + 1 > delta_max:
                continue
            s = free[-1]
            dout[u] = 1
            din[v] = 1
            reweight(upd, dout, din, {s})
            upd[s] = (u, v, arc_w(
                u, v, int(out_deg[u]) + 1, int(in_deg[v]) + 1))
            removed, added = (), ((u, v),)
            structural = False  # adds cannot disconnect
        elif mtype == 2:  # drop
            if len(act_list) <= 1:
                continue
            s = act_list[int(rng.integers(len(act_list)))]
            u, v = int(ssrc[s]), int(sdst[s])
            dout[u] = -1
            din[v] = -1
            reweight(upd, dout, din, {s})
            upd[s] = (u, v, MISSING)
            removed, added = ((u, v),), ()
        else:  # 2-opt: (a, b), (c, d) -> (a, d), (c, b); degree-neutral
            if len(act_list) < 2:
                continue
            s1 = act_list[int(rng.integers(len(act_list)))]
            s2 = act_list[int(rng.integers(len(act_list)))]
            if s1 == s2:
                continue
            a, bb = int(ssrc[s1]), int(sdst[s1])
            c, d = int(ssrc[s2]), int(sdst[s2])
            if a == d or c == bb:
                continue
            if (a, d) in arc_slot or (c, bb) in arc_slot:
                continue  # also rejects the degenerate b==d / a==c swaps
            if (a, d) not in latd or (c, bb) not in latd:
                continue
            upd[s1] = (a, d, arc_w(a, d, int(out_deg[a]), int(in_deg[d])))
            upd[s2] = (c, bb, arc_w(c, bb, int(out_deg[c]), int(in_deg[bb])))
            removed, added = ((a, bb), (c, d)), ((a, d), (c, bb))
        slots_arr = np.fromiter(upd.keys(), dtype=np.int64, count=len(upd))
        su = np.fromiter((x[0] for x in upd.values()), dtype=np.int64,
                         count=len(upd))
        du = np.fromiter((x[1] for x in upd.values()), dtype=np.int64,
                         count=len(upd))
        wu = np.fromiter((x[2] for x in upd.values()), dtype=np.float64,
                         count=len(upd))
        pm = dp.price(slots_arr, su, du, wu, force_full=force_full)
        dtau = pm.tau - dp.tau
        accept = dtau < 0
        if not accept and sa_t0 > 0:
            temp = max(sa_t0 * (sa_t1 / sa_t0) ** (t / denom), 1e-12)
            rel = dtau / max(abs(dp.tau), 1.0)
            accept = rng.random() < math.exp(-min(rel / temp, 700.0))
        if not accept:
            continue
        if structural or not cur_strong:
            rm = set(removed)
            new_arcs = [x for x in arc_slot if x not in rm]
            new_arcs.extend(added)
            strong2 = _strong_arcs(n, new_arcs)
            if cur_strong and not strong2:
                continue  # never walk out of the feasible region
            cur_strong = strong2
        dp.commit(pm)
        totals["accepts"] += 1
        accepts += 1
        # apply bookkeeping for the moved slots
        for s, (uu, vv, ww) in upd.items():
            ou, ov = int(ssrc[s]), int(sdst[s])
            was = bool(np.isfinite(sw[s]))
            now = bool(np.isfinite(ww))
            if was and (not now or (ou, ov) != (uu, vv)):
                out_slots[ou].discard(s)
                in_slots[ov].discard(s)
                arc_slot.pop((ou, ov), None)
                if not now:
                    act_remove(s)
                    free.append(s)
            if now and (not was or (ou, ov) != (uu, vv)):
                out_slots[uu].add(s)
                in_slots[vv].add(s)
                arc_slot[(uu, vv)] = s
                if not was:
                    act_add(s)
                    if free and free[-1] == s:
                        free.pop()
            ssrc[s], sdst[s], sw[s] = uu, vv, ww
        for node, dd in dout.items():
            out_deg[node] += dd
        for node, dd in din.items():
            in_deg[node] += dd
        if reanchor_every > 0 and accepts % reanchor_every == 0:
            dp.reanchor()
        if cur_strong and dp.tau < btau:
            btau = dp.tau
            best_arcs = list(arc_slot.keys())
    totals["fast"] += dp.stats["fast"]
    totals["propagated"] += dp.stats["propagated"]
    totals["reanchor"] += dp.stats["reanchor"]
    return best_arcs


def cluster_silos(
    gc: ConnectivityGraph,
    *,
    n_clusters: Optional[int] = None,
    labels: Optional[Union[Mapping[Node, Hashable], Sequence[Hashable]]] = None,
    seed: int = 0,
) -> List[List[Node]]:
    """Partition the silos into delay clusters.

    With ``labels`` (a mapping silo -> label, or a sequence aligned with
    ``gc.silos`` — e.g. geographic regions), clusters are the label
    groups, ordered by label.  Otherwise clusters come from
    farthest-point medoid seeding on the symmetrized latency (a missing
    pair counts as infinitely far, so disconnected components separate
    first) with nearest-medoid assignment; ``n_clusters`` defaults to
    ``round(sqrt(N))`` — the balance point where both the intra searches
    and the inter-cluster ring stay ~sqrt(N)-sized.  Within each
    cluster, silo order follows ``gc.silos``.
    """
    silos = list(gc.silos)
    n = len(silos)
    if labels is not None:
        if isinstance(labels, Mapping):
            lab = [labels[v] for v in silos]
        else:
            lab = list(labels)
            if len(lab) != n:
                raise ValueError(
                    f"labels: expected {n} entries, got {len(lab)}")
        groups: Dict[Hashable, List[Node]] = {}
        for v, l in zip(silos, lab):
            groups.setdefault(l, []).append(v)
        keys = list(groups)
        try:
            keys.sort()
        except TypeError:  # mixed/incomparable labels
            keys.sort(key=repr)
        return [groups[k] for k in keys]
    k = int(n_clusters) if n_clusters is not None else max(
        1, int(round(math.sqrt(n))))
    k = min(max(k, 1), n)
    if k <= 1:
        return [silos]
    index = {v: i for i, v in enumerate(silos)}
    D = np.full((n, n), np.inf, dtype=np.float64)
    np.fill_diagonal(D, 0.0)
    for (i, j), l in gc.latency_ms.items():
        if i == j:
            continue
        a, b = index[i], index[j]
        D[a, b] = min(D[a, b], float(l))
        D[b, a] = min(D[b, a], float(l))
    rng = np.random.default_rng(seed)
    meds = [int(rng.integers(n))]
    dmin = D[meds[0]].copy()
    for _ in range(k - 1):
        nxt = int(np.argmax(dmin))
        meds.append(nxt)
        dmin = np.minimum(dmin, D[nxt])
    assign = np.argmin(D[:, meds], axis=1)
    out = [[silos[i] for i in range(n) if int(assign[i]) == c]
           for c in range(k)]
    return [c for c in out if c]


def _subgraph(gc: ConnectivityGraph, nodes: Sequence[Node]) -> ConnectivityGraph:
    """Connectivity restricted to ``nodes`` (order preserved)."""
    keep = set(nodes)
    return ConnectivityGraph(
        tuple(nodes),
        {k: v for k, v in gc.latency_ms.items()
         if k[0] in keep and k[1] in keep},
        {k: v for k, v in gc.available_bw_gbps.items()
         if k[0] in keep and k[1] in keep},
        {v: gc.silo_params[v] for v in nodes},
    )


def _cluster_medoid(gc: ConnectivityGraph, members: Sequence[Node]) -> Node:
    """The member minimizing total round-trip latency to the others
    (unrouted pairs count as a large constant, so well-connected silos
    win)."""
    if len(members) == 1:
        return members[0]
    best: Optional[Tuple[float, int]] = None
    for k, a in enumerate(members):
        tot = 0.0
        for b in members:
            if a == b:
                continue
            la = gc.latency_ms.get((a, b))
            lb = gc.latency_ms.get((b, a))
            tot += ((float(la) + float(lb))
                    if la is not None and lb is not None else 1e9)
        if best is None or tot < best[0]:
            best = (tot, k)
    return members[best[1]]


# ---------------------------------------------------------------------------
# Rewire climb on a torch device


def rewire_climb(lat: torch.Tensor, bw: torch.Tensor, allowed: torch.Tensor,
                 comp: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                 model_mbits: float, asrc: torch.Tensor, adst: torch.Tensor,
                 aact: torch.Tensor, *, generator: torch.Generator, n_steps: int,
                 delta_max: int, sa_t0: float = 0.05, sa_t1: float = 1e-3,
                 multi: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched simulated-annealing rewire climb over ``[B, S]`` arc-slot
    states (``asrc``/``adst`` int64, ``aact`` bool), on the inputs' device.

    ``multi=False``: one connectivity universe shared by all restarts
    (``lat/bw/allowed`` are ``[n, n]``, ``comp/up/dn`` are ``[n]``).
    ``multi=True``: every restart carries its own universe (``[B, n, n]``
    / ``[B, n]``); padded nodes have ``allowed`` all False and
    ``comp = -inf`` (their self-loop becomes padding) and are exempt from
    the strong-connectivity requirement.

    Each step proposes one local move per restart -- endpoint swap, arc
    add, arc drop, or a 2-opt double rewire (two arcs exchange
    destinations) -- re-derives every arc's Eq. 3 delay from the
    proposal's degrees, scores it with the device Karp, and accepts
    improvements plus Metropolis-accepted uphill moves under a geometric
    temperature schedule ``sa_t0 -> sa_t1`` (relative-tau scale;
    ``sa_t0 = 0`` is pure hill climbing).  Infeasible proposals (not
    strongly connected, or a degree above ``delta_max``) score ``+inf``.
    The best state ever visited is returned as ``(b_src, b_dst, b_act,
    btau)``; with ``n_steps=0`` that is the seeds and their score.

    Random draws come from ``generator`` alone.  A draw over a row's
    active (or free) slots is Gumbel-max over masked logits; a row with no
    such slot draws a garbage slot that the move's validity mask rejects.
    The steps are a Python loop with no host synchronisation in it.
    """
    B, S = asrc.shape
    n = lat.shape[-1]
    dev, dt = lat.device, lat.dtype
    inf = float("inf")
    boff = torch.arange(B, device=dev)[:, None] * n
    rows = torch.arange(B, device=dev)
    sl32 = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    slot_ids = torch.arange(S, device=dev)
    mbits = torch.as_tensor(model_mbits, dtype=dt, device=dev)
    if multi:
        comp_sl = comp
        active = ~torch.isneginf(comp)  # [B, n]; padded nodes are -inf
        n_active = active.sum(dim=1).clamp_min(1)

        def pick2(M, s, d):  # M[B, n, n] gathered at per-row indices
            return M[rows.view((B,) + (1,) * (s.dim() - 1)), s, d]

        def pick1(V, s):  # V[B, n]
            return V[rows.view((B,) + (1,) * (s.dim() - 1)), s]

    else:
        comp_sl = comp.expand(B, n)

        def pick2(M, s, d):
            return M[s, d]

        def pick1(V, s):
            return V[s]

    def score(a_src, a_dst, a_act):
        present = a_act & pick2(allowed, a_src, a_dst) & (a_src != a_dst)
        pf = present.to(dt)
        seg_dst = (boff + a_dst).ravel()
        seg_src = (boff + a_src).ravel()
        out_deg = torch.zeros(B * n, dtype=dt, device=dev).index_add_(
            0, seg_src, pf.ravel()).view(B, n)
        in_deg = torch.zeros(B * n, dtype=dt, device=dev).index_add_(
            0, seg_dst, pf.ravel()).view(B, n)
        od = torch.gather(out_deg, 1, a_src)
        idg = torch.gather(in_deg, 1, a_dst)
        rate = torch.minimum(
            torch.minimum(pick1(up, a_src) / od.clamp_min(1.0),
                          pick1(dn, a_dst) / idg.clamp_min(1.0)),
            pick2(bw, a_src, a_dst))
        # true division by a tensor: ``float / tensor`` would multiply by
        # a rounded reciprocal and drift from the reference's f32 pricing
        warc = pick1(comp, a_src) + pick2(lat, a_src, a_dst) + torch.div(mbits, rate)
        warc = torch.where(present, warc, MISSING)
        src32, dst32 = a_src.to(torch.int32), a_dst.to(torch.int32)
        src_all = torch.cat([src32, sl32], dim=1)
        dst_all = torch.cat([dst32, sl32], dim=1)
        w_all = torch.cat([warc, comp_sl], dim=1)
        # Feasible states bound present in-degree by delta_max (+1
        # self-loop, +1 single-move transient), so the degree-padded
        # layout is lossless; infeasible states are masked to +inf below.
        tau = batched_cycle_time_sparse_torch(src_all, dst_all, w_all, n,
                                              max_in_degree=delta_max + 2)
        # strong connectivity: everything reaches vertex 0 and back
        fwd, bwd = reach_from_zero(src32, dst32, present, n)
        reached = fwd & bwd
        strong = (reached | ~active).all(dim=1) if multi else reached.all(dim=1)
        deg_ok = (out_deg <= delta_max).all(dim=1) & (in_deg <= delta_max).all(dim=1)
        return torch.where(strong & deg_ok, tau, inf)

    def categorical(logits):  # Gumbel-max over each row's masked logits
        u = torch.rand(logits.shape, generator=generator, device=dev, dtype=dt)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(dt).tiny)))
        return torch.argmax(logits + gumbel, dim=1)

    def randint(high):
        return torch.randint(0, high, (B,), generator=generator, device=dev)

    def step(t, a_src, a_dst, a_act, tau, b_src, b_dst, b_act, btau):
        mtype = randint(4)
        is_add, is_drop, is_two = mtype == 1, mtype == 2, mtype == 3
        act_logits = torch.where(a_act, 0.0, MISSING)
        slot_act = categorical(act_logits)
        slot_inact = categorical(torch.where(a_act, MISSING, 0.0))
        slot = torch.where(is_add, slot_inact, slot_act)
        rand_i, rand_j = randint(n), randint(n)
        if multi:  # sample endpoints among each universe's live nodes
            rand_i, rand_j = rand_i % n_active, rand_j % n_active
        cur_src, cur_dst, cur_act = a_src[rows, slot], a_dst[rows, slot], a_act[rows, slot]
        new_src = torch.where(is_add, rand_i, cur_src)
        new_dst = torch.where(is_drop, cur_dst, rand_j)
        # Slot sanity (a draw over a row with no candidate slot is
        # garbage), connectivity-graph membership, and arc uniqueness.
        slot_ok = torch.where(is_add, ~cur_act, cur_act)
        arc_ok = (new_src != new_dst) & pick2(allowed, new_src, new_dst)
        other = slot_ids[None, :] != slot[:, None]
        dup = (a_act & (a_src == new_src[:, None]) & (a_dst == new_dst[:, None])
               & other).any(dim=1)
        one_ok = slot_ok & (is_drop | (arc_ok & ~dup))
        p_src, p_dst, p_act = a_src.clone(), a_dst.clone(), a_act.clone()
        p_src[rows, slot] = new_src
        p_dst[rows, slot] = new_dst
        p_act[rows, slot] = ~is_drop
        # 2-opt double rewire: slots (slot, slot2) holding (a, b) and
        # (c, d) exchange destinations -> (a, d), (c, b).
        slot2 = categorical(act_logits)
        c_src, c_dst, c_act = a_src[rows, slot2], a_dst[rows, slot2], a_act[rows, slot2]
        other2 = other & (slot_ids[None, :] != slot2[:, None])

        def not_dup(ns, nd):
            return ~(a_act & (a_src == ns[:, None]) & (a_dst == nd[:, None])
                     & other2).any(dim=1)

        two_ok = (
            cur_act & c_act & (slot != slot2)
            & (cur_src != c_dst) & pick2(allowed, cur_src, c_dst)
            & (c_src != cur_dst) & pick2(allowed, c_src, cur_dst)
            & not_dup(cur_src, c_dst) & not_dup(c_src, cur_dst)
            & ~((cur_src == c_src) & (cur_dst == c_dst))
        )
        q_dst = a_dst.clone()
        q_dst[rows, slot] = c_dst
        q_dst[rows, slot2] = cur_dst
        two = is_two[:, None]
        p_src = torch.where(two, a_src, p_src)
        p_dst = torch.where(two, q_dst, p_dst)
        p_act = torch.where(two, a_act, p_act)
        ok = torch.where(is_two, two_ok, one_ok)
        ptau = torch.where(ok, score(p_src, p_dst, p_act), inf)
        accept = ptau < tau
        u = torch.rand((B,), generator=generator, device=dev, dtype=dt)
        if sa_t0 > 0:  # Metropolis acceptance on the relative-tau scale
            temp = max(sa_t0 * (sa_t1 / sa_t0) ** (t / max(n_steps - 1, 1)), 1e-12)
            rel = (ptau - tau) / tau.abs().clamp_min(1.0)
            accept = accept | (torch.isfinite(ptau) & torch.isfinite(tau)
                               & (u < torch.exp(-rel / temp)))
        acc = accept[:, None]
        rec = ptau < btau
        recc = rec[:, None]
        return (torch.where(acc, p_src, a_src), torch.where(acc, p_dst, a_dst),
                torch.where(acc, p_act, a_act), torch.where(accept, ptau, tau),
                torch.where(recc, p_src, b_src), torch.where(recc, p_dst, b_dst),
                torch.where(recc, p_act, b_act), torch.where(rec, ptau, btau))

    tau0 = score(asrc, adst, aact)
    state = (asrc, adst, aact, tau0, asrc, adst, aact, tau0)
    for t in range(n_steps):
        state = step(t, *state)
    return state[4:]


def _universe(gc: ConnectivityGraph, tp: TrainingParams, index: Dict[Node, int]
              ) -> Tuple[np.ndarray, ...]:
    """One connectivity universe as float32 arrays for the climb:
    ``lat, bw`` ``[n, n]`` (1 off the graph), ``allowed`` ``[n, n]`` bool,
    and ``comp, up, dn`` ``[n]``."""
    n = gc.num_silos
    lat = np.ones((n, n), dtype=np.float32)
    bw = np.ones((n, n), dtype=np.float32)
    allowed = np.zeros((n, n), dtype=bool)
    for (i, j), l in gc.latency_ms.items():
        if i == j:
            continue
        a, b = index[i], index[j]
        lat[a, b] = l
        bw[a, b] = gc.available_bw_gbps[(i, j)]
        allowed[a, b] = True
    comp = np.array(
        [tp.local_steps * gc.silo_params[v].comp_time_ms for v in gc.silos],
        dtype=np.float32,
    )
    up = np.array([gc.silo_params[v].uplink_gbps for v in gc.silos], dtype=np.float32)
    dn = np.array([gc.silo_params[v].downlink_gbps for v in gc.silos], dtype=np.float32)
    return lat, bw, allowed, comp, up, dn


def _on_device(device: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """Host arrays as device tensors; integer arrays become int64 (the
    index type of torch's gathers)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        out.append(t.to(device))
    return out


def _best_climbed(b_src, b_dst, b_act, tau, allowed) -> List[List[Tuple[int, int]]]:
    """The best climbed state as an index-space arc list (empty if no
    restart reached a feasible state)."""
    best = int(np.argmin(tau))
    if not np.isfinite(tau[best]):
        return []
    s, d = b_src[best], b_dst[best]
    universe = allowed[best] if allowed.ndim == 3 else allowed
    keep = b_act[best] & (s != d) & universe[s, d]
    return [[(int(i), int(j)) for (i, j) in zip(s[keep], d[keep])]]


@span_fn("designer.search_jit")
def search_overlays_jit(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_restarts: int = 16,
    n_steps: int = 96,
    delta_max: int = 8,
    max_arcs: Optional[int] = None,
    seed: int = 0,
    incumbent: Optional[Overlay] = None,
    engine: str = "auto",
    sa_t0: float = 0.05,
    sa_t1: float = 1e-3,
    device: DeviceLike = "cuda",
) -> Overlay:
    """Topology search on a device: batched rewire climb with random
    restarts (:func:`rewire_climb`), scored by the device Karp.

    Parameters
    ----------
    gc, tp:
        Connectivity measurements and workload, as for every designer.
    n_restarts:
        Parallel climb states.  Seeds, in order: the ``incumbent`` (if
        any), the Christofides ring, the bidirected MST, then random
        Hamiltonian rings.  With the ring seed in the pool (and the exact
        f64 re-pricing below) the result is never worse than RING.
    n_steps:
        Rewire moves proposed per restart.
    delta_max:
        Max in-degree and out-degree per silo.
    max_arcs:
        Arc-slot capacity S (default ``2 N``).
    seed:
        Seeds both the restart rings and the climb's generator.
    incumbent:
        Optional overlay to seed restart 0 from.
    engine:
        ``"jit"`` runs the device climb; ``"delta"`` delegates to
        :func:`search_overlays_delta` (host incremental pricing);
        ``"auto"`` picks ``"jit"`` under :data:`_DELTA_ENGINE_MIN_N`
        silos and ``"delta"`` above, where per-proposal Karp dominates.
    sa_t0, sa_t1:
        Simulated-annealing start/end temperature (relative-tau scale).
    device:
        Where the climb runs (default ``"cuda"``; raises without a GPU
        unless the caller passes ``"cpu"``).

    Returns the best of {climb result, structured seeds}, re-priced
    exactly (f64 host engine) as ``name="sparse_rewire"``.  Raises
    ``ValueError`` if neither reaches a strongly-connected,
    degree-feasible state.
    """
    dev = resolve_device(device)
    n = gc.num_silos
    if n < 2:
        raise ValueError("sparse-rewire search needs at least 2 silos")
    if engine not in ("auto", "jit", "delta"):
        raise ValueError(f"unknown search engine {engine!r}")
    if engine == "delta" or (engine == "auto" and n >= _DELTA_ENGINE_MIN_N):
        found = search_overlays_delta(
            gc, tp,
            n_restarts=n_restarts,
            # Delta proposals cost O(deg), not a Karp pass: spend the
            # saved work on a deeper move budget per restart.
            n_steps=max(8 * n_steps, 256),
            delta_max=delta_max, max_arcs=max_arcs, seed=seed,
            incumbent=incumbent, sa_t0=sa_t0, sa_t1=sa_t1,
        )
        return dataclasses.replace(found, name="sparse_rewire")
    index = {v: k for k, v in enumerate(gc.silos)}
    slots = max(max_arcs if max_arcs is not None else 2 * n, n)
    if incumbent is not None:
        slots = max(slots, len({e for e in incumbent.edges if e[0] != e[1]}))
    universe = _universe(gc, tp, index)
    rng = np.random.default_rng(seed)
    asrc, adst, aact, seed_arcs = _seed_states(
        gc, tp, index, n_restarts, slots, delta_max, rng, incumbent
    )
    res = rewire_climb(
        *_on_device(dev, *universe), np.float32(tp.model_size_mbits),
        *_on_device(dev, asrc, adst, aact),
        generator=torch.Generator(device=dev).manual_seed(seed),
        n_steps=int(n_steps), delta_max=int(delta_max),
        sa_t0=float(sa_t0), sa_t1=float(sa_t1),
    )
    b_src, b_dst, b_act, tau = (x.cpu().numpy() for x in res)
    candidates = _best_climbed(b_src, b_dst, b_act, tau, universe[2])
    candidates.extend(seed_arcs)
    return _reprice_candidates(gc, tp, candidates, "sparse_rewire")


def _pack_universes(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    clusters: Sequence[Sequence[Node]],
    n_restarts: int,
    delta_intra: int,
    rng: np.random.Generator,
    incumbent: Optional[Overlay],
) -> Tuple[Tuple[np.ndarray, ...], List[Tuple[ConnectivityGraph, List[List[Tuple[int, int]]]]]]:
    """Pack every cluster's sub-problem as ``n_restarts`` universes of one
    multi-universe climb, padded to the largest cluster.  Returns the
    climb's host arrays ``(lat, bw, allowed, comp, up, dn, asrc, adst,
    aact)`` and, per cluster, its subgraph and structured seed arcs."""
    nmax = max(len(c) for c in clusters)
    slots = 2 * nmax
    U = len(clusters) * n_restarts
    latA = np.ones((U, nmax, nmax), dtype=np.float32)
    bwA = np.ones((U, nmax, nmax), dtype=np.float32)
    alA = np.zeros((U, nmax, nmax), dtype=bool)
    compA = np.full((U, nmax), MISSING, dtype=np.float32)
    upA = np.ones((U, nmax), dtype=np.float32)
    dnA = np.ones((U, nmax), dtype=np.float32)
    asrcA = np.zeros((U, slots), dtype=np.int32)
    adstA = np.zeros((U, slots), dtype=np.int32)
    aactA = np.zeros((U, slots), dtype=bool)
    subs: List[Tuple[ConnectivityGraph, List[List[Tuple[int, int]]]]] = []
    for ci, members in enumerate(clusters):
        sub = _subgraph(gc, members)
        m = sub.num_silos
        sidx = {v: k for k, v in enumerate(sub.silos)}
        sl = slice(ci * n_restarts, (ci + 1) * n_restarts)
        lat, bw, allowed, comp, up, dn = _universe(sub, tp, sidx)
        latA[sl, :m, :m], bwA[sl, :m, :m], alA[sl, :m, :m] = lat, bw, allowed
        compA[sl, :m], upA[sl, :m], dnA[sl, :m] = comp, up, dn
        inc = None
        if incumbent is not None:
            mem = set(members)
            proj = tuple(
                (i, j) for (i, j) in incumbent.edges
                if i in mem and j in mem and i != j
            )
            if proj:
                inc = Overlay(name="incumbent", edges=proj, cycle_time_ms=np.inf)
        a_s, a_d, a_a, s_arcs = _seed_states(
            sub, tp, sidx, n_restarts, slots, delta_intra, rng, inc)
        asrcA[sl], adstA[sl], aactA[sl] = a_s, a_d, a_a
        subs.append((sub, s_arcs))
    return (latA, bwA, alA, compA, upA, dnA, asrcA, adstA, aactA), subs


@span_fn("designer.search_hierarchical")
def search_overlays_hierarchical(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_clusters: Optional[int] = None,
    labels: Optional[Union[Mapping[Node, Hashable], Sequence[Hashable]]] = None,
    n_restarts: int = 2,
    n_steps: int = 64,
    delta_max: int = 8,
    seed: int = 0,
    incumbent: Optional[Overlay] = None,
    sa_t0: float = 0.05,
    sa_t1: float = 1e-3,
    device: DeviceLike = "cuda",
) -> Overlay:
    """Hierarchical topology search: cluster the silos by delay (or by
    the caller's ``labels``), search every cluster's internal overlay,
    compose with an inter-cluster ring, and price the composition
    exactly.

    The intra-cluster searches are batched: each cluster's sub-problem
    is padded to the largest cluster size and packed as ``n_restarts``
    universes of one multi-universe :func:`rewire_climb` on ``device``,
    so every cluster's search runs in one climb of
    O(B · n_steps · nmax · S) work.  Intra-cluster searches run under
    ``max(2, delta_max - 1)`` so border silos keep degree headroom; the
    inter-cluster ring visits clusters in Christofides order over their
    medoids and joins consecutive clusters through their cheapest
    bidirectionally-routed border pair (``ValueError`` if two adjacent
    clusters share none).  The composed overlay is re-priced by the
    exact f64 engine (``name="hierarchical"``), with the ``incumbent``
    (when still routable) competing as a candidate.
    """
    dev = resolve_device(device)
    n = gc.num_silos
    if n < 2:
        raise ValueError("hierarchical search needs at least 2 silos")
    if incumbent is None and n <= 512:
        # Where the O(n^2) Christofides build is cheap, the global ring
        # competes in the final exact pricing, so the decomposition can
        # never lose to RING on a small problem.
        try:
            incumbent = ring_overlay(gc, tp)
        except (KeyError, ValueError):
            pass
    clusters = cluster_silos(gc, n_clusters=n_clusters, labels=labels, seed=seed)
    index = {v: k for k, v in enumerate(gc.silos)}
    if len(clusters) <= 1:
        found = search_overlays_jit(
            gc, tp, n_restarts=max(n_restarts, 4), n_steps=n_steps,
            delta_max=delta_max, seed=seed, incumbent=incumbent,
            sa_t0=sa_t0, sa_t1=sa_t1, device=dev)
        return dataclasses.replace(found, name="hierarchical")
    delta_intra = max(2, delta_max - 1)
    rng = np.random.default_rng(seed)
    multi = [c for c in clusters if len(c) >= 2]
    intra_arcs: List[Tuple[Node, Node]] = []
    if multi:
        packed, subs = _pack_universes(gc, tp, multi, n_restarts, delta_intra, rng,
                                       incumbent)
        res = rewire_climb(
            *_on_device(dev, *packed[:6]), np.float32(tp.model_size_mbits),
            *_on_device(dev, *packed[6:]),
            generator=torch.Generator(device=dev).manual_seed(seed),
            n_steps=int(n_steps), delta_max=int(delta_intra),
            sa_t0=float(sa_t0), sa_t1=float(sa_t1), multi=True,
        )
        b_src, b_dst, b_act, tauU = (x.cpu().numpy() for x in res)
        alA = packed[2]
        for ci, (sub, s_arcs) in enumerate(subs):
            sl = slice(ci * n_restarts, (ci + 1) * n_restarts)
            cands = _best_climbed(b_src[sl], b_dst[sl], b_act[sl], tauU[sl], alA[sl])
            cands.extend(s_arcs)
            best = _reprice_candidates(sub, tp, cands, "hierarchical_intra")
            intra_arcs.extend(best.edges)
    medoids = [_cluster_medoid(gc, c) for c in clusters]
    med_ci = {m: ci for ci, m in enumerate(medoids)}
    try:
        tour = christofides_tour(
            medoids, lambda i, j: symmetrized_delay_ms(gc, tp, i, j))
        order = [med_ci[m] for m in tour]
    except (KeyError, ValueError):
        order = list(range(len(clusters)))  # sparse medoid mesh: keep order
    inter: Set[Tuple[Node, Node]] = set()
    for k in range(len(order)):
        A = clusters[order[k]]
        B = clusters[order[(k + 1) % len(order)]]
        best_pair: Optional[Tuple[float, Node, Node]] = None
        for a in A:
            for b in B:
                if gc.has_edge(a, b) and gc.has_edge(b, a):
                    c = float(gc.latency_ms[(a, b)]) + float(gc.latency_ms[(b, a)])
                    if best_pair is None or c < best_pair[0]:
                        best_pair = (c, a, b)
        if best_pair is None:
            raise ValueError(
                "hierarchical search: no bidirectionally-routed border "
                f"pair between clusters {order[k]} and "
                f"{order[(k + 1) % len(order)]}")
        inter.add((best_pair[1], best_pair[2]))
        inter.add((best_pair[2], best_pair[1]))
    composed = sorted(
        {(index[i], index[j])
         for (i, j) in itertools.chain(intra_arcs, inter) if i != j})
    candidates = [composed]
    if incumbent is not None and all(
        i in index and j in index and gc.has_edge(i, j)
        for (i, j) in incumbent.edges if i != j
    ):
        candidates.append(sorted(
            {(index[i], index[j]) for (i, j) in incumbent.edges if i != j}))
    return _reprice_candidates(gc, tp, candidates, "hierarchical")


# ---------------------------------------------------------------------------
# Registry


@span_fn("designer.design_overlay")
def design_overlay(
    kind: str,
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    center: Optional[Node] = None,
    device: DeviceLike = "cuda",
) -> Overlay:
    """Run one named designer on (``gc``, ``tp``) and return its
    :class:`Overlay`.

    ``kind`` is one of :data:`OVERLAY_KINDS`: ``star``, ``mst``,
    ``ring``, ``ring_2opt``, ``delta_mbst`` (Algorithm 1),
    ``sparse_rewire`` (the rewire search behind its size-dispatched
    engine), ``delta_rewire`` (the host delta-priced climb, forced), or
    ``hierarchical`` (cluster / compose); ``center`` pins the STAR
    orchestrator.  ``device`` is where the climbs of ``sparse_rewire``
    and ``hierarchical`` run (default ``"cuda"``; like every entry point
    of the port it raises without a GPU unless the caller passes
    ``"cpu"``)."""
    dev = resolve_device(device)
    kind = kind.lower()
    if kind == "star":
        return star_overlay(gc, tp, center=center)
    if kind == "mst":
        return mst_overlay(gc, tp)
    if kind == "ring":
        return ring_overlay(gc, tp)
    if kind == "ring_2opt":
        return two_opt_ring_overlay(gc, tp)
    if kind in ("delta_mbst", "dmbst"):
        return algorithm1_mbst(gc, tp)
    if kind in ("sparse_rewire", "sparse-rewire"):
        return search_overlays_jit(gc, tp, device=dev)
    if kind in ("delta_rewire", "delta-rewire"):
        return search_overlays_delta(gc, tp)
    if kind == "hierarchical":
        return search_overlays_hierarchical(gc, tp, device=dev)
    raise KeyError(f"unknown overlay kind {kind!r}")


OVERLAY_KINDS = (
    "star", "mst", "delta_mbst", "ring", "ring_2opt", "sparse_rewire",
    "delta_rewire", "hierarchical",
)


def design_schedule(
    kind: str,
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    center: Optional[Node] = None,
    budgets: Optional[Sequence[float]] = None,
    rounds: int = 150,
    seeds: Sequence[int] = (0, 1, 2),
    sample_seed: int = 0,
    objective: str = "tau",
    mixing_rounds: int = 128,
    device: DeviceLike = "cuda",
):
    """Run one named designer and return a :class:`repro_torch.core.schedule.Schedule`.

    The schedule-valued superset of :func:`design_overlay`: every
    :data:`OVERLAY_KINDS` designer is wrapped in a
    :class:`~repro_torch.core.schedule.FixedSchedule`, and ``kind="matcha"``
    runs the randomized designer — a budget sweep
    (:func:`~repro_torch.core.schedule.design_matcha_schedule`) that prices
    every budget × seed Monte-Carlo chain in one call, its Eq. 4
    recursion on ``device`` (one launch of the K1 recursion on the card),
    and returns the budget minimizing ``objective`` (``"tau"``: mean τ̄;
    ``"time_to_eps"``: the composite ``τ̄ / −log(ρ)`` with ρ the expected
    contraction over ``mixing_rounds`` sampled rounds — see
    :mod:`repro_torch.core.mixing`).
    ``budgets``/``rounds``/``seeds``/``sample_seed``/``objective``
    parameterize the sweep; fixed kinds design by cycle time alone and
    pass ``device`` to :func:`design_overlay`.
    """
    from .schedule import (
        DEFAULT_MATCHA_BUDGETS,
        FixedSchedule,
        design_matcha_schedule,
    )

    kind = kind.lower()
    if kind == "matcha":
        schedule, _ = design_matcha_schedule(
            gc,
            tp,
            budgets=DEFAULT_MATCHA_BUDGETS if budgets is None else budgets,
            rounds=rounds,
            seeds=seeds,
            sample_seed=sample_seed,
            objective=objective,
            mixing_rounds=mixing_rounds,
            device=device,
        )
        return schedule
    return FixedSchedule(design_overlay(kind, gc, tp, center=center, device=device))


SCHEDULE_KINDS = OVERLAY_KINDS + ("matcha",)
