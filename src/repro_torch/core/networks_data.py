"""The five underlays of the paper (Table 3): a copy of the reference's
``repro/core/networks_data.py``.

* **Gaia** (11 silos, 55 links): full mesh over the AWS regions used by
  Gaia [38] -- four continents.
* **AWS North America** (22 silos, 231 links): full mesh over 22 AWS
  North-American locations [96].
* **Géant / Exodus / Ebone**: deterministic stand-ins with the exact node
  and link counts of Table 3 (40/61, 79/147, 87/161) over the right
  geographic boxes: a distance-MST backbone plus the shortest remaining
  pairs, which yields ISP-like sparse graphs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from .underlay import Underlay, haversine_km

LatLon = Tuple[float, float]

# Gaia: 11 AWS regions spanning four continents [38].
GAIA_SITES: Tuple[Tuple[str, LatLon], ...] = (
    ("virginia", (38.95, -77.45)),
    ("oregon", (45.84, -119.70)),
    ("california", (37.35, -121.96)),
    ("saopaulo", (-23.55, -46.63)),
    ("ireland", (53.35, -6.26)),
    ("frankfurt", (50.11, 8.68)),
    ("tokyo", (35.68, 139.69)),
    ("seoul", (37.57, 126.98)),
    ("singapore", (1.35, 103.82)),
    ("sydney", (-33.87, 151.21)),
    ("mumbai", (19.08, 72.88)),
)

# AWS North America: 22 locations (regions + local zones) [96].
AWS_NA_SITES: Tuple[Tuple[str, LatLon], ...] = (
    ("ashburn", (39.04, -77.49)),
    ("columbus", (39.96, -83.00)),
    ("sanfrancisco", (37.77, -122.42)),
    ("portland", (45.52, -122.68)),
    ("montreal", (45.50, -73.57)),
    ("toronto", (43.65, -79.38)),
    ("calgary", (51.05, -114.07)),
    ("mexicocity", (19.43, -99.13)),
    ("atlanta", (33.75, -84.39)),
    ("boston", (42.36, -71.06)),
    ("chicago", (41.88, -87.63)),
    ("dallas", (32.78, -96.80)),
    ("denver", (39.74, -104.99)),
    ("houston", (29.76, -95.37)),
    ("kansascity", (39.10, -94.58)),
    ("lasvegas", (36.17, -115.14)),
    ("losangeles", (34.05, -118.24)),
    ("miami", (25.76, -80.19)),
    ("minneapolis", (44.98, -93.27)),
    ("newyork", (40.71, -74.01)),
    ("phoenix", (33.45, -112.07)),
    ("seattle", (47.61, -122.33)),
)


def _full_mesh(n: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, j) for i in range(n) for j in range(i + 1, n))


def _lcg(seed: int):
    """Tiny deterministic PRNG (no numpy dependency at import time)."""
    state = seed & 0xFFFFFFFF

    def rnd() -> float:
        nonlocal state
        state = (1103515245 * state + 12345) & 0x7FFFFFFF
        return state / 0x7FFFFFFF

    return rnd


def _synthetic_coords(
    n: int, lat_range: Tuple[float, float], lon_range: Tuple[float, float], seed: int
) -> Tuple[LatLon, ...]:
    rnd = _lcg(seed)
    out: List[LatLon] = []
    for _ in range(n):
        lat = lat_range[0] + (lat_range[1] - lat_range[0]) * rnd()
        lon = lon_range[0] + (lon_range[1] - lon_range[0]) * rnd()
        out.append((round(lat, 4), round(lon, 4)))
    return tuple(out)


def _mst_plus_shortest(coords: Sequence[LatLon], n_edges: int) -> Tuple[Tuple[int, int], ...]:
    """Distance MST (Prim) + shortest remaining pairs up to ``n_edges``."""
    n = len(coords)
    assert n_edges >= n - 1, "need at least a spanning tree"
    dist = [[haversine_km(coords[i], coords[j]) for j in range(n)] for i in range(n)]
    in_tree = [False] * n
    best = [math.inf] * n
    best_to = [-1] * n
    in_tree[0] = True
    for j in range(1, n):
        best[j] = dist[0][j]
        best_to[j] = 0
    edges: List[Tuple[int, int]] = []
    for _ in range(n - 1):
        v = min((j for j in range(n) if not in_tree[j]), key=lambda j: best[j])
        edges.append((min(v, best_to[v]), max(v, best_to[v])))
        in_tree[v] = True
        for j in range(n):
            if not in_tree[j] and dist[v][j] < best[j]:
                best[j] = dist[v][j]
                best_to[j] = v
    chosen = set(edges)
    rest = sorted(
        ((i, j) for i in range(n) for j in range(i + 1, n) if (i, j) not in chosen),
        key=lambda e: dist[e[0]][e[1]],
    )
    for e in rest:
        if len(edges) >= n_edges:
            break
        edges.append(e)
    return tuple(edges)


def make_underlay(
    name: str,
    *,
    core_capacity_gbps: float = 1.0,
    access_capacity_gbps: float = 10.0,
) -> Underlay:
    """Factory for the paper's five networks."""
    key = name.lower().replace("-", "_").replace(" ", "_")
    if key == "gaia":
        coords = tuple(c for _, c in GAIA_SITES)
        edges = _full_mesh(len(coords))  # 55
    elif key in ("aws_na", "aws_north_america", "awsna"):
        coords = tuple(c for _, c in AWS_NA_SITES)
        edges = _full_mesh(len(coords))  # 231
    elif key == "geant":
        coords = _synthetic_coords(40, (36.0, 60.0), (-9.0, 26.0), seed=0x6EA7)
        edges = _mst_plus_shortest(coords, 61)
    elif key == "exodus":
        coords = _synthetic_coords(79, (30.0, 48.0), (-122.0, -71.0), seed=0xE50D)
        edges = _mst_plus_shortest(coords, 147)
    elif key == "ebone":
        coords = _synthetic_coords(87, (36.0, 60.0), (-9.0, 30.0), seed=0xEB0E)
        edges = _mst_plus_shortest(coords, 161)
    else:
        raise KeyError(f"unknown underlay {name!r}")
    return Underlay(
        name=key,
        coords=coords,
        core_edges=edges,
        core_capacity_gbps=core_capacity_gbps,
        access_capacity_gbps=access_capacity_gbps,
    )


NETWORK_NAMES: Tuple[str, ...] = ("gaia", "aws_na", "geant", "exodus", "ebone")

# (silos, links) from Table 3.
EXPECTED_SIZES: Dict[str, Tuple[int, int]] = {
    "gaia": (11, 55),
    "aws_na": (22, 231),
    "geant": (40, 61),
    "exodus": (79, 147),
    "ebone": (87, 161),
}

# Workloads of Table 2: (model size Mbits, computation time ms on P100).
WORKLOADS: Dict[str, Tuple[float, float]] = {
    "shakespeare": (3.23, 389.6),
    "femnist": (4.62, 4.6),
    "sent140": (18.38, 9.8),
    "inaturalist": (42.88, 25.4),
    "full_inaturalist": (161.06, 946.7),  # Appendix H.4 (ResNet-50)
}
