"""Bridge: designed overlay -> runtime gossip plan.

:func:`plan_from_overlay` derives the consensus matrix of an overlay from
:mod:`repro_torch.core.topologies` (Appendix G.3) and compiles it into a
:class:`GossipPlan` of Birkhoff transfers; :func:`plan_for_n_silos` does
the same for a bare silo count with homogeneous links.  Counterparts of
``repro.fed.topology_runtime``.
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.consensus import local_degree_matrix, ring_matrix
from repro_torch.core.topologies import Overlay
from .gossip import GossipPlan

Node = Hashable


def _silo_index(overlay: Overlay, n_silos: int,
                silos: Optional[Sequence[Node]]) -> Dict[Node, int]:
    """Map silo labels -> mesh positions 0..n-1.

    Silo ids need not be a 0-based contiguous int range (string labels,
    sparse ids).  The caller can fix the mesh order via ``silos``;
    otherwise the labels found on the overlay edges are sorted for a
    deterministic assignment.
    """
    labels = {v for e in overlay.edges for v in e}
    if silos is None:
        try:
            silos = sorted(labels)
        except TypeError:  # mixed label types
            silos = sorted(labels, key=repr)
    else:
        missing = labels - set(silos)
        if missing:
            raise ValueError(
                f"overlay uses silo labels not in `silos`: {sorted(missing, key=repr)}"
            )
    if len(silos) != n_silos:
        raise ValueError(
            f"overlay spans {len(silos)} silos but n_silos={n_silos}"
        )
    return {v: k for k, v in enumerate(silos)}


def _ring_tour(edges: Sequence[Tuple[int, int]], n_silos: int) -> list:
    """Recover the tour order of a directed ring from its edge list.

    Starts from ``edges[0][0]`` (node 0 may not exist), walks the
    successor map, and validates that the walk closes into a single
    Hamiltonian cycle covering every silo.
    """
    nxt: Dict[int, int] = {}
    for (i, j) in edges:
        if i in nxt:
            raise ValueError(
                f"not a ring overlay: silo {i} has out-degree > 1"
            )
        nxt[i] = j
    if len(nxt) != n_silos:
        raise ValueError(
            f"not a ring overlay: {len(nxt)} edges for {n_silos} silos"
        )
    start = edges[0][0]
    tour = [start]
    cur = start
    for _ in range(n_silos):
        cur = nxt.get(cur)
        if cur is None:
            raise ValueError(f"broken ring: no successor for silo {tour[-1]}")
        if cur == start:
            break
        tour.append(cur)
    else:
        raise ValueError("broken ring: walk does not close into a cycle")
    if len(tour) != n_silos:
        raise ValueError(
            f"ring tour covers {len(tour)} of {n_silos} silos "
            "(disconnected sub-rings?)"
        )
    return tour


def plan_from_overlay(overlay: Overlay, n_silos: int,
                      kind: Optional[str] = None,
                      silos: Optional[Sequence[Node]] = None) -> GossipPlan:
    """Consensus matrix per Appendix G.3 -> Birkhoff ppermute schedule.

    ``silos`` optionally pins the silo-label -> mesh-position order;
    by default labels are taken from the overlay edges and sorted.
    """
    name = kind or overlay.name
    index = _silo_index(overlay, n_silos, silos)
    edges = [(index[i], index[j]) for (i, j) in overlay.edges]
    if name.startswith("ring"):
        tour = _ring_tour(edges, n_silos)
        A = ring_matrix(n_silos, tour)
    elif name == "star":
        # FedAvg: full averaging each (two-phase) round
        A = np.full((n_silos, n_silos), 1.0 / n_silos)
    else:
        A = local_degree_matrix(n_silos, edges)
    return GossipPlan.from_matrix(A)


def plan_for_n_silos(kind: str, n_silos: int) -> GossipPlan:
    """Homogeneous-link plans: ring = 1 transfer, star = O(N)."""
    if kind.startswith("ring"):
        A = ring_matrix(n_silos, list(range(n_silos)))
    elif kind == "star":
        A = np.full((n_silos, n_silos), 1.0 / n_silos)
    elif kind in ("chain", "mst"):
        edges = []
        for i in range(n_silos - 1):
            edges += [(i, i + 1), (i + 1, i)]
        A = local_degree_matrix(n_silos, edges)
    elif kind == "none":
        A = np.eye(n_silos)
    else:
        raise KeyError(kind)
    return GossipPlan.from_matrix(A)
