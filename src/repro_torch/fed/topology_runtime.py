"""Topology plans for a bare silo count (no network measurements).

Counterpart of ``repro.fed.topology_runtime.plan_for_n_silos``.  The
bridge from a designed overlay (``plan_from_overlay``) needs the
designers and comes with the design slice.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.consensus import local_degree_matrix, ring_matrix
from .gossip import GossipPlan


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
