"""Max-plus linear system analysis for synchronous decentralized training
(a copy of the reference's ``repro/core/maxplus.py``).

The paper (Sect. 2.3) models the start times ``t_i(k)`` of each silo's k-th
computation phase as a linear system in the max-plus algebra:

    t_i(k+1) = max_{j in N_i^+ ∪ {i}} ( t_j(k) + d_o(j, i) )        (Eq. 4)

The asymptotic *cycle time* tau = lim t_i(k)/k equals the **maximum cycle
mean** of the weighted delay digraph (Eq. 5, [Baccelli et al., Thm 3.23]):

    tau(G_o) = max_gamma  d_o(gamma) / |gamma|

over all circuits gamma. We compute it with Karp's algorithm [Karp 1978],
which is exact and O(|V||E|). Throughput = 1 / tau.

This module is the node-labelled front end on the host (numpy and plain
Python).  The heavy lifting (Karp, the timing recursion, strong
connectivity) is delegated to :mod:`repro_torch.core.maxplus_vec`, which
runs the same DP as dense array sweeps; the device engines live in
:mod:`repro_torch.core.maxplus_sparse`.  The original pure-Python
implementations are kept as ``*_legacy``: they are the oracles of the
equivalence tests, in the reference and here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import maxplus_vec as _vec
from .maxplus_vec import NEG_INF, missing_mask

Node = Hashable
Edge = Tuple[Node, Node]


@dataclass(frozen=True)
class DelayDigraph:
    """A weighted digraph of inter-silo delays (the overlay + self loops).

    ``delays[(i, j)]`` is the total delay between the *start* of a
    computation at ``i`` and the moment ``j`` has received ``i``'s model
    (Eq. 3).  Self-delays ``delays[(i, i)] = s * T_c(i)`` model the local
    computation phase (the paper defines d_o(i, i) this way).
    """

    nodes: Tuple[Node, ...]
    delays: Mapping[Edge, float]

    @staticmethod
    def from_edges(delays: Mapping[Edge, float]) -> "DelayDigraph":
        nodes: List[Node] = []
        seen = set()
        for (i, j) in delays:
            for v in (i, j):
                if v not in seen:
                    seen.add(v)
                    nodes.append(v)
        return DelayDigraph(tuple(nodes), dict(delays))

    def successors(self, i: Node) -> List[Node]:
        return [j for (a, j) in self.delays if a == i]

    def predecessors(self, j: Node) -> List[Node]:
        return [i for (i, b) in self.delays if b == j]

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.delays)

    def to_matrix(self):
        """Dense ``[N, N]`` weight matrix (``-inf`` holes) + node order."""
        return _vec.graph_to_matrix(self)


def max_cycle_mean(graph: DelayDigraph) -> float:
    """Maximum cycle mean of a digraph (Karp; -inf for acyclic graphs).

    Delegates to the vectorized engine; ``max_cycle_mean_legacy`` is the
    original dict-based implementation, kept as the equivalence oracle.
    """
    W, _ = _vec.graph_to_matrix(graph)
    return _vec.cycle_time_dense(W)


def max_cycle_mean_legacy(graph: DelayDigraph) -> float:
    """Original pure-Python Karp-per-SCC (reference / benchmark baseline)."""
    comp_means = [
        _karp_scc(graph, scc) for scc in strongly_connected_components(graph)
    ]
    return max(comp_means, default=NEG_INF)


def _karp_scc(graph: DelayDigraph, scc: Sequence[Node]) -> float:
    nodes = list(scc)
    index = {v: k for k, v in enumerate(nodes)}
    n = len(nodes)
    if n == 0:
        return NEG_INF
    # Collect intra-SCC edges (including self loops).
    edges = [
        (index[i], index[j], w)
        for (i, j), w in graph.delays.items()
        if i in index and j in index
    ]
    if not edges:
        return NEG_INF
    # D[k][v] = max weight of a walk with exactly k edges from source to v.
    # The table holds host Python floats whose -inf only ever comes from
    # this fill, never from an overflow, so the oracle's raw sentinel
    # tests below are exact (kept as the reference wrote them).
    src = 0
    D = [[NEG_INF] * n for _ in range(n + 1)]
    D[0][src] = 0.0
    for k in range(1, n + 1):
        row_prev, row = D[k - 1], D[k]
        for (u, v, w) in edges:
            if row_prev[u] != NEG_INF:  # repro-lint: ignore[sentinel-discipline]
                cand = row_prev[u] + w
                if cand > row[v]:
                    row[v] = cand
    best = NEG_INF
    for v in range(n):
        if D[n][v] == NEG_INF:  # repro-lint: ignore[sentinel-discipline]
            continue
        # min over k of (D_n - D_k) / (n - k)
        worst = math.inf
        for k in range(n):
            if D[k][v] == NEG_INF:  # repro-lint: ignore[sentinel-discipline]
                continue
            worst = min(worst, (D[n][v] - D[k][v]) / (n - k))
        if worst != math.inf:
            best = max(best, worst)
    return best


def strongly_connected_components(graph: DelayDigraph) -> List[List[Node]]:
    """Tarjan's algorithm (iterative)."""
    adj: Dict[Node, List[Node]] = {v: [] for v in graph.nodes}
    for (i, j) in graph.delays:
        if i != j:
            adj[i].append(j)
    index_counter = [0]
    stack: List[Node] = []
    lowlink: Dict[Node, int] = {}
    index: Dict[Node, int] = {}
    on_stack: Dict[Node, bool] = {}
    result: List[List[Node]] = []

    for root in graph.nodes:
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = index_counter[0]
                lowlink[v] = index_counter[0]
                index_counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            succ = adj[v]
            for i in range(pi, len(succ)):
                w = succ[i]
                if w not in index:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack.get(w, False):
                    lowlink[v] = min(lowlink[v], index[w])
            if recurse:
                continue
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                result.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
    return result


def is_strongly_connected(graph: DelayDigraph) -> bool:
    """True iff every silo can reach every other over the overlay arcs
    (self-loops ignored) — the precondition for a finite cycle time."""
    W, _ = _vec.graph_to_matrix(graph)
    return bool(_vec.batched_is_strongly_connected(W))


def cycle_time(graph: DelayDigraph) -> float:
    """Cycle time tau(G_o) of the overlay delay digraph (Eq. 5)."""
    return max_cycle_mean(graph)


def throughput(graph: DelayDigraph) -> float:
    """Communication rounds per time unit = 1 / tau."""
    tau = cycle_time(graph)
    if tau <= 0 or missing_mask(tau):
        return math.inf
    return 1.0 / tau


def timing_recursion(
    graph: DelayDigraph, num_rounds: int, t0: Optional[Mapping[Node, float]] = None
) -> Dict[Node, List[float]]:
    """Evolve the max-plus recursion (Eq. 4) for ``num_rounds`` rounds.

    Returns ``{i: [t_i(0), ..., t_i(num_rounds)]}``.  The key theoretical
    property (tested): ``t_i(k) / k -> tau`` for every silo i.

    Runs as a dense ``[N]``-state vector recursion; the dict-of-lists
    return shape is preserved for callers.
    """
    W, nodes = _vec.graph_to_matrix(graph)
    init = None
    if t0 is not None:
        init = np.array([float(t0.get(v, 0.0)) for v in nodes])
    series = _vec.timing_recursion_dense(W, num_rounds, init)
    return {v: series[:, k].tolist() for k, v in enumerate(nodes)}


def timing_recursion_legacy(
    graph: DelayDigraph, num_rounds: int, t0: Optional[Mapping[Node, float]] = None
) -> Dict[Node, List[float]]:
    """Original dict-based Eq. 4 recursion (reference / benchmark baseline)."""
    preds: Dict[Node, List[Node]] = {v: [] for v in graph.nodes}
    for (i, j) in graph.delays:
        if i != j:
            preds[j].append(i)
    t: Dict[Node, List[float]] = {
        v: [0.0 if t0 is None else float(t0.get(v, 0.0))] for v in graph.nodes
    }
    for k in range(num_rounds):
        cur = {v: t[v][k] for v in graph.nodes}
        for v in graph.nodes:
            self_d = graph.delays.get((v, v), 0.0)
            best = cur[v] + self_d
            for p in preds[v]:
                best = max(best, cur[p] + graph.delays[(p, v)])
            t[v].append(best)
    return t


def empirical_cycle_time(graph: DelayDigraph, num_rounds: int = 200) -> float:
    """Estimate tau by running the recursion; converges to Karp's value."""
    t = timing_recursion(graph, num_rounds)
    # Discard a warmup prefix: slope of the tail is within O(1/k) of tau.
    warmup = num_rounds // 2
    est = max(
        (series[num_rounds] - series[warmup]) / (num_rounds - warmup)
        for series in t.values()
    )
    return est


def critical_circuit(graph: DelayDigraph) -> Tuple[float, List[Node]]:
    """Return (tau, circuit) where circuit attains the max cycle mean.

    Delegates to :func:`repro_torch.core.maxplus_vec.critical_circuit_dense`
    (array-sweep potentials + boolean-closure cycle location); the
    original per-edge Bellman-Ford implementation is kept below as
    ``critical_circuit_legacy``, the equivalence oracle.
    """
    W, nodes = _vec.graph_to_matrix(graph)
    tau, circuit = _vec.critical_circuit_dense(W)
    if circuit:
        return tau, [nodes[c] for c in circuit]
    if missing_mask(tau):
        return tau, []
    return critical_circuit_legacy(graph)  # numerically degenerate fallback


def critical_circuit_legacy(graph: DelayDigraph) -> Tuple[float, List[Node]]:
    """Original per-edge Bellman-Ford critical-circuit recovery
    (reference oracle for :func:`critical_circuit`).

    Uses the standard reduction: run Karp for tau, relax longest-path
    potentials under the reduced weights (w - tau), then search the tight
    subgraph for a zero-reduced-mean cycle.
    """
    tau = max_cycle_mean(graph)
    # a float64 Karp result: -inf exactly when the graph is acyclic
    if tau == NEG_INF:  # repro-lint: ignore[sentinel-discipline]
        return tau, []
    nodes = list(graph.nodes)
    idx = {v: k for k, v in enumerate(nodes)}
    n = len(nodes)
    eps = 1e-9 * max(1.0, abs(tau))
    edges = [(idx[i], idx[j], w - tau) for (i, j), w in graph.delays.items()]
    # With reduced weights w - tau every circuit has mean <= 0 and critical
    # circuits have mean exactly 0.  Longest-path potentials converge; the
    # "tight" edges (dist[v] == dist[u] + w') contain a zero-mean cycle.
    dist = [0.0] * n
    for _ in range(n):
        changed = False
        for (u, v, w) in edges:
            if dist[u] + w > dist[v] + eps:
                dist[v] = dist[u] + w
                changed = True
        if not changed:
            break
    tight: Dict[int, List[int]] = {v: [] for v in range(n)}
    for (u, v, w) in edges:
        if abs(dist[u] + w - dist[v]) <= 10 * eps:
            tight[u].append(v)
    # find a cycle in the tight subgraph (iterative DFS with colors)
    color = [0] * n  # 0 unvisited, 1 on stack, 2 done
    parent: Dict[int, int] = {}
    for root in range(n):
        if color[root]:
            continue
        stack = [(root, iter(tight[root]))]
        color[root] = 1
        while stack:
            v, it = stack[-1]
            advanced = False
            for u in it:
                if color[u] == 1:
                    # found cycle u -> ... -> v -> u
                    cyc = [v]
                    w_ = v
                    while w_ != u:
                        w_ = parent[w_]
                        cyc.append(w_)
                    cyc.reverse()
                    cyc.append(cyc[0])
                    return tau, [nodes[c] for c in cyc]
                if color[u] == 0:
                    color[u] = 1
                    parent[u] = v
                    stack.append((u, iter(tight[u])))
                    advanced = True
                    break
            if not advanced:
                color[v] = 2
                stack.pop()
    return tau, []
