"""MATCHA / MATCHA+ baseline [104] (Sect. 4, Appendix G.3) -- a copy of
the reference's ``repro/core/matcha.py``.

MATCHA decomposes a base topology into matchings (via edge coloring) and
activates each matching independently with probability p ~= C_b at every
communication round.  MATCHA starts from the connectivity graph; MATCHA+
starts from the underlay graph.

The paper computes MATCHA's *average cycle time* by simulation (footnote
6); we do the same: sample per-round topologies, run the max-plus timing
recursion with time-varying delays, and report the average round duration.
Per Appendix G.3 we resample whenever no matching is selected, so every
round has at least one active matching.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Hashable, List, Sequence, Set, Tuple

from .delays import ConnectivityGraph, TrainingParams, edge_delay_ms

Node = Hashable
Pair = Tuple[Node, Node]


def greedy_edge_coloring(edges: Sequence[Pair]) -> List[List[Pair]]:
    """Greedy edge coloring -> matchings.  Uses at most 2*Delta - 1 colors;
    on the sparse ISP graphs considered it lands near the Vizing bound
    Delta + 1 used by MATCHA's Misra-Gries step."""
    colors: List[List[Pair]] = []
    used: Dict[Node, Set[int]] = {}
    # Sort: high-degree-incident edges first improves the bound in practice.
    deg: Dict[Node, int] = {}
    for (u, v) in edges:
        deg[u] = deg.get(u, 0) + 1
        deg[v] = deg.get(v, 0) + 1
    for (u, v) in sorted(edges, key=lambda e: -(deg[e[0]] + deg[e[1]])):
        taken = used.setdefault(u, set()) | used.setdefault(v, set())
        c = 0
        while c in taken:
            c += 1
        while c >= len(colors):
            colors.append([])
        colors[c].append((u, v))
        used[u].add(c)
        used[v].add(c)
    return colors


@dataclass
class Matcha:
    """Sampler of per-round MATCHA topologies."""

    matchings: List[List[Pair]]
    budget: float  # C_b

    def __post_init__(self):
        # budget <= 0 never activates a matching, so the Appendix G.3
        # resample-until-nonempty loop in sample_round would spin forever;
        # budget > 1 is not a probability.  Fail at construction instead.
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(
                f"MATCHA budget C_b must be in (0, 1], got {self.budget!r}"
            )

    @staticmethod
    def from_base_graph(pairs: Sequence[Pair], budget: float = 0.5) -> "Matcha":
        return Matcha(matchings=greedy_edge_coloring(list(pairs)), budget=budget)

    def sample_round(self, rng: random.Random) -> List[Pair]:
        """Independently activate each matching w.p. C_b; resample until at
        least one matching is active (Appendix G.3)."""
        while True:
            active: List[Pair] = []
            for m in self.matchings:
                if rng.random() < self.budget:
                    active.extend(m)
            if active:
                return active

    def average_cycle_time(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        *,
        rounds: int = 300,
        seed: int = 0,
    ) -> float:
        """Average round duration via the time-varying max-plus recursion."""
        rng = random.Random(seed)
        t: Dict[Node, float] = {v: 0.0 for v in gc.silos}
        for _ in range(rounds):
            active = self.sample_round(rng)
            # per-round degrees (undirected matchings -> degree = #matchings
            # covering the node; communication is bidirectional)
            deg: Dict[Node, int] = {v: 0 for v in gc.silos}
            for (u, v) in active:
                deg[u] += 1
                deg[v] += 1
            nxt: Dict[Node, float] = {}
            for v in gc.silos:
                start = t[v] + tp.local_steps * gc.silo_params[v].comp_time_ms
                nxt[v] = start
            for (u, v) in active:
                for (a, b) in ((u, v), (v, u)):
                    d = edge_delay_ms(gc, tp, a, b, max(deg[a], 1), max(deg[b], 1))
                    nxt[b] = max(nxt[b], t[a] + d)
            t = nxt
        return max(t.values()) / rounds

    @property
    def num_matchings(self) -> int:
        return len(self.matchings)


def matcha_from_connectivity(gc: ConnectivityGraph, budget: float = 0.5) -> Matcha:
    """MATCHA over the symmetric pairs of a connectivity graph.

    Greedy-colors the undirected pair graph into matchings and allocates
    activation probabilities so the expected number of active matchings
    per round is ``budget * num_matchings``.  Returns a :class:`Matcha`
    sampler of per-round overlays."""
    pairs: List[Pair] = []
    seen: Set[frozenset] = set()
    for (i, j) in gc.latency_ms:
        k = frozenset((i, j))
        if i != j and k not in seen and gc.has_edge(j, i):
            seen.add(k)
            pairs.append((i, j))
    return Matcha.from_base_graph(pairs, budget)


def matcha_plus_from_underlay(underlay, budget: float = 0.5) -> Matcha:
    """MATCHA+: matchings computed on the *underlay* core graph."""
    return Matcha.from_base_graph(list(underlay.core_edges), budget)
