"""Underlay network model (Sect. 2.2, Appendix F/G): a copy of the
reference's ``repro/core/underlay.py``.

The underlay G_u = (V ∪ V', E_u) connects access routers (V') with core
links; each silo i ∈ V attaches to one router i' via a symmetric access
link.  From the underlay we derive the *connectivity graph* G_c over the
silos with, per ordered pair (i, j):

* end-to-end latency l(i,j) = sum of link latencies along the shortest
  (distance-routed) path, with per-link latency
  ``0.0085 * distance_km + 4`` ms (Appendix F, [32]);
* available bandwidth A(i',j') = min core-link capacity along the path.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .delays import ConnectivityGraph, SiloParams

LatLon = Tuple[float, float]


EARTH_RADIUS_KM = 6371.0


def haversine_km(a: LatLon, b: LatLon) -> float:
    """Great-circle distance in km between two (lat, lon) points."""
    (lat1, lon1), (lat2, lon2) = a, b
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    h = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_KM * math.asin(math.sqrt(h))


def link_latency_ms(distance_km: float) -> float:
    """Per-link latency model of Appendix F: 0.0085 ms/km + 4 ms."""
    return 0.0085 * distance_km + 4.0


@dataclass(frozen=True)
class Underlay:
    """Router-level network: nodes are access routers, one silo per router."""

    name: str
    coords: Tuple[LatLon, ...]  # router i' position; silo i sits next to it
    core_edges: Tuple[Tuple[int, int], ...]  # undirected router pairs
    core_capacity_gbps: float = 1.0
    access_capacity_gbps: float = 10.0
    access_distance_km: float = 10.0

    @property
    def num_silos(self) -> int:
        return len(self.coords)

    @property
    def num_core_links(self) -> int:
        return len(self.core_edges)

    def core_adjacency(self) -> Dict[int, List[Tuple[int, float]]]:
        adj: Dict[int, List[Tuple[int, float]]] = {i: [] for i in range(self.num_silos)}
        for (u, v) in self.core_edges:
            d = haversine_km(self.coords[u], self.coords[v])
            adj[u].append((v, d))
            adj[v].append((u, d))
        return adj

    def shortest_paths(self) -> Dict[int, Tuple[List[float], List[Optional[int]]]]:
        """All-pairs distance-weighted Dijkstra over the core graph.

        Returns per-source (dist_km per node, predecessor per node).
        """
        adj = self.core_adjacency()
        out: Dict[int, Tuple[List[float], List[Optional[int]]]] = {}
        n = self.num_silos
        for s in range(n):
            dist = [math.inf] * n
            pred: List[Optional[int]] = [None] * n
            dist[s] = 0.0
            pq: List[Tuple[float, int]] = [(0.0, s)]
            while pq:
                d, u = heapq.heappop(pq)
                if d > dist[u]:
                    continue
                for (v, w) in adj[u]:
                    nd = d + w
                    if nd < dist[v] - 1e-12:
                        dist[v] = nd
                        pred[v] = u
                        heapq.heappush(pq, (nd, v))
            out[s] = (dist, pred)
        return out

    def path_nodes(self, pred: List[Optional[int]], src: int, dst: int) -> List[int]:
        path = [dst]
        while path[-1] != src:
            p = pred[path[-1]]
            if p is None:
                raise ValueError(f"{self.name}: no path {src}->{dst} (disconnected underlay)")
            path.append(p)
        path.reverse()
        return path

    def pair_metrics(
        self,
        *,
        core_capacity_gbps: Optional[Mapping[Tuple[int, int], float]] = None,
        silos: Optional[Sequence[int]] = None,
        skip_unreachable: bool = False,
    ) -> Tuple[Dict[Tuple[int, int], float], Dict[Tuple[int, int], float]]:
        """(latency_ms, available_bw_gbps) of every routed ordered silo pair.

        The single place the Sect. 2.2 path pricing lives: end-to-end
        latency = 2 access links + per-hop core latencies along the
        distance-routed shortest path; available bandwidth = min core-link
        capacity on that path.  ``core_capacity_gbps`` overrides per-link
        capacities (keyed by the sorted router pair — used by the dynamics
        layer for degraded links); ``silos`` restricts the pair set;
        ``skip_unreachable`` drops partitioned pairs instead of raising.
        """
        sp = self.shortest_paths()
        access_lat = link_latency_ms(self.access_distance_km)
        nodes = range(self.num_silos) if silos is None else sorted(silos)
        latency: Dict[Tuple[int, int], float] = {}
        avail: Dict[Tuple[int, int], float] = {}
        for i in nodes:
            dist, pred = sp[i]
            for j in nodes:
                if i == j:
                    continue
                if math.isinf(dist[j]):
                    if skip_unreachable:
                        continue
                    raise ValueError(
                        f"{self.name}: no path {i}->{j} (disconnected underlay)"
                    )
                path = self.path_nodes(pred, i, j)
                lat = 2 * access_lat
                bw = math.inf
                for (u, v) in zip(path[:-1], path[1:]):
                    lat += link_latency_ms(haversine_km(self.coords[u], self.coords[v]))
                    if core_capacity_gbps is None:
                        bw = min(bw, self.core_capacity_gbps)
                    else:
                        key = (u, v) if u <= v else (v, u)
                        bw = min(
                            bw,
                            core_capacity_gbps.get(key, self.core_capacity_gbps),
                        )
                latency[(i, j)] = lat
                avail[(i, j)] = bw
        return latency, avail

    def connectivity_graph(
        self,
        comp_time_ms: float,
        *,
        access_capacity_gbps: Optional[float] = None,
        per_silo_access_gbps: Optional[Mapping[int, float]] = None,
        per_silo_comp_ms: Optional[Mapping[int, float]] = None,
    ) -> ConnectivityGraph:
        """Derive the full-mesh connectivity graph over the silos."""
        access = access_capacity_gbps if access_capacity_gbps is not None else self.access_capacity_gbps
        n = self.num_silos
        latency, avail = self.pair_metrics()
        params: Dict[int, SiloParams] = {}
        for i in range(n):
            cap = access if per_silo_access_gbps is None else per_silo_access_gbps.get(i, access)
            ct = comp_time_ms if per_silo_comp_ms is None else per_silo_comp_ms.get(i, comp_time_ms)
            params[i] = SiloParams(comp_time_ms=ct, uplink_gbps=cap, downlink_gbps=cap)
        return ConnectivityGraph(
            silos=tuple(range(n)),
            latency_ms=latency,
            available_bw_gbps=avail,
            silo_params=params,
        )

    def load_centrality_center(self) -> int:
        """Node with the highest shortest-path load (betweenness-like)
        centrality — the paper places the STAR orchestrator there [11]."""
        n = self.num_silos
        sp = self.shortest_paths()
        load = [0.0] * n
        for s in range(n):
            _, pred = sp[s]
            for t in range(n):
                if t == s:
                    continue
                for v in self.path_nodes(pred, s, t):
                    load[v] += 1.0
        return max(range(n), key=lambda v: load[v])
