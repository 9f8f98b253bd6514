"""Node-labelled delay digraph (copy of the reference's
``repro/core/maxplus.py``, the part Eq. 3 pricing builds on).

The paper (Sect. 2.3) models the start times ``t_i(k)`` of each silo's
k-th computation phase as a max-plus linear system whose cycle time is
the maximum cycle mean of this digraph (Eq. 5).  The engines that price
it live in :mod:`repro_torch.core.maxplus_vec` (dense, numpy) and
:mod:`repro_torch.core.maxplus_sparse` (edge lists, numpy and torch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, List, Mapping, Tuple

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
