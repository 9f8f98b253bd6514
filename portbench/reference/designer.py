"""The reference's view of a re-design: the paper's delay model (Eq. 3),
the cycle time of an overlay under it (Karp's maximum cycle mean, or a
star's two-phase round), and the consensus matrix that an overlay's
arcs give (Appendix G.3).
Imports nothing of the program.

A network is given as plain data: ``silos``, ``latency_ms`` and
``available_bw_gbps`` keyed by ``(i, j)``, ``comp_time_ms``,
``uplink_gbps`` and ``downlink_gbps`` keyed by silo, and the workload's
``model_size_mbits`` and ``local_steps``.  Times are in ms, capacities in
Gbit/s (one Mbit a ms).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .model import ring_matrix_from_arcs
from .recipes import local_degree_matrix

Arc = Tuple[int, int]


def overlay_delays(net: Dict, arcs: Sequence[Arc]) -> Dict[Arc, float]:
    """Eq. 3: ``d(i, j) = s Tc(i) + l(i, j) + M / min(C_up(i) / out(i),
    C_dn(j) / in(j), A(i, j))`` for each arc of the overlay, the degrees
    counted over its arcs, and ``d(i, i) = s Tc(i)`` for every silo."""
    arcs = [(i, j) for i, j in arcs if i != j]
    out_deg: Dict[int, int] = {}
    in_deg: Dict[int, int] = {}
    for i, j in arcs:
        out_deg[i] = out_deg.get(i, 0) + 1
        in_deg[j] = in_deg.get(j, 0) + 1
    s, M = net["local_steps"], net["model_size_mbits"]
    w = {}
    for i, j in arcs:
        rate = min(net["uplink_gbps"][i] / out_deg[i], net["downlink_gbps"][j] / in_deg[j],
                   net["available_bw_gbps"][(i, j)])
        w[(i, j)] = s * net["comp_time_ms"][i] + net["latency_ms"][(i, j)] + M / rate
    for v in net["silos"]:
        w[(v, v)] = s * net["comp_time_ms"][v]
    return w


def cycle_time_ms(nodes: Sequence[int], delays: Dict[Arc, float], dtype=np.float64) -> float:
    """Karp's maximum cycle mean of a strongly connected delay graph, in
    ``dtype``: ``max_v min_k (D_n(v) - D_k(v)) / (n - k)``, where ``D_k(v)``
    is the heaviest walk of exactly k arcs from the first node to v."""
    idx = {v: k for k, v in enumerate(nodes)}
    n = len(nodes)
    D = np.full((n + 1, n), -np.inf, dtype=dtype)
    D[0, 0] = 0
    arcs = [(idx[i], idx[j], dtype(x)) for (i, j), x in delays.items()]
    for k in range(1, n + 1):
        for i, j, x in arcs:
            D[k, j] = max(D[k, j], D[k - 1, i] + x)
    best = -np.inf
    for v in range(n):
        if D[n, v] == -np.inf:
            continue
        best = max(best, min((D[n, v] - D[k, v]) / dtype(n - k)
                             for k in range(n) if D[k, v] > -np.inf))
    return float(best)


def overlay_cycle_time_ms(net: Dict, name: str, arcs: Sequence[Arc], dtype=np.float64) -> float:
    """An overlay's cycle time: Karp's over its Eq. 3 delays, or for a star
    (a FedAvg round, two phases: Appendix B) the slowest upload into the
    centre plus the slowest download from it, each link's rate shared
    over the centre's N leaves."""
    if name != "star":
        return cycle_time_ms(net["silos"], overlay_delays(net, arcs), dtype)
    ends = [{i, j} for i, j in arcs if i != j]
    centre = set.intersection(*ends).pop()
    leaves = [v for v in net["silos"] if v != centre]
    s, M, n = net["local_steps"], net["model_size_mbits"], len(leaves)
    up = max(s * net["comp_time_ms"][v] + net["latency_ms"][(v, centre)]
             + M / min(net["uplink_gbps"][v], net["downlink_gbps"][centre] / n,
                       net["available_bw_gbps"][(v, centre)]) for v in leaves)
    down = max(net["latency_ms"][(centre, v)]
               + M / min(net["uplink_gbps"][centre] / n, net["downlink_gbps"][v],
                         net["available_bw_gbps"][(centre, v)]) for v in leaves)
    return float(dtype(up) + dtype(down))


def consensus_matrix(name: str, arcs: Sequence[Arc], order: Sequence[int]) -> List[List[float]]:
    """The consensus matrix of an overlay over the rows ``order`` (row k
    is silo ``order[k]``): ``(I + P) / 2`` for a ring, uniform averaging
    for a star, the local-degree rule otherwise.  Raises ``ValueError``
    when an arc leaves ``order`` or a ring is not one cycle."""
    pos = {v: k for k, v in enumerate(order)}
    n = len(order)
    try:
        local = [(pos[i], pos[j]) for i, j in arcs if i != j]
    except KeyError as exc:
        raise ValueError(f"arc to or from silo {exc} outside {tuple(order)}") from None
    if name.startswith("ring"):
        return ring_matrix_from_arcs(local, n)
    if name == "star":
        return [[1.0 / n] * n for _ in range(n)]
    return local_degree_matrix(n, local).tolist()
