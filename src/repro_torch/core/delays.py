"""Delay model of the paper (Eq. 3): a copy of the reference's
``repro/core/delays.py``.

For an overlay edge (i, j):

    d_o(i,j) = s*T_c(i) + l(i,j) + M / min( C_UP(i)/|N_i^-|,
                                            C_DN(j)/|N_j^+|,
                                            A(i',j') )

and d_o(i,i) = s*T_c(i).  All times in milliseconds, capacities in
megabits/ms (== Gbit/s), model size M in megabits.

A network is *edge-capacitated* when access-link sharing can be neglected
(the min is attained by A(i',j')); otherwise *node-capacitated*.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, Mapping, Sequence, Tuple

import numpy as np

from ..obs.spans import span_fn
from .maxplus import DelayDigraph
from .maxplus_vec import MISSING

Node = Hashable
Edge = Tuple[Node, Node]


@dataclass(frozen=True)
class SiloParams:
    """Per-silo measurable characteristics."""

    comp_time_ms: float  # T_c(i): one local update
    uplink_gbps: float  # C_UP(i)
    downlink_gbps: float  # C_DN(i)


@dataclass(frozen=True)
class ConnectivityGraph:
    """The connectivity graph G_c with measurable per-pair characteristics.

    ``latency_ms[(i,j)]`` is the end-to-end delay l(i,j) and
    ``available_bw_gbps[(i,j)]`` the available bandwidth A(i',j') of the
    underlay path between the access routers of i and j.
    """

    silos: Tuple[Node, ...]
    latency_ms: Mapping[Edge, float]
    available_bw_gbps: Mapping[Edge, float]
    silo_params: Mapping[Node, SiloParams]

    def edges(self):
        return list(self.latency_ms.keys())

    @property
    def num_silos(self) -> int:
        return len(self.silos)

    def has_edge(self, i: Node, j: Node) -> bool:
        return (i, j) in self.latency_ms

    def is_symmetric(self) -> bool:
        return all((j, i) in self.latency_ms for (i, j) in self.latency_ms)


@dataclass(frozen=True)
class TrainingParams:
    """Workload parameters entering the delay model."""

    model_size_mbits: float  # M
    local_steps: int = 1  # s


def effective_rate_gbps(
    gc: ConnectivityGraph,
    i: Node,
    j: Node,
    out_degree_i: int,
    in_degree_j: int,
) -> float:
    """min(C_UP(i)/|N_i^-|, C_DN(j)/|N_j^+|, A(i',j'))."""
    up = gc.silo_params[i].uplink_gbps / max(out_degree_i, 1)
    dn = gc.silo_params[j].downlink_gbps / max(in_degree_j, 1)
    return min(up, dn, gc.available_bw_gbps[(i, j)])


def edge_delay_ms(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    i: Node,
    j: Node,
    out_degree_i: int,
    in_degree_j: int,
) -> float:
    """d_o(i, j) per Eq. 3 (times in ms; 1 Gbps == 1 Mbit/ms)."""
    rate = effective_rate_gbps(gc, i, j, out_degree_i, in_degree_j)
    return (
        tp.local_steps * gc.silo_params[i].comp_time_ms
        + gc.latency_ms[(i, j)]
        + tp.model_size_mbits / rate
    )


def connectivity_delay_ms(gc: ConnectivityGraph, tp: TrainingParams, i: Node, j: Node) -> float:
    """d_c(i,j) = s*T_c(i) + l(i,j) + M/A(i',j') — the *edge-capacitated*
    delay used to weigh the connectivity graph for topology design."""
    return (
        tp.local_steps * gc.silo_params[i].comp_time_ms
        + gc.latency_ms[(i, j)]
        + tp.model_size_mbits / gc.available_bw_gbps[(i, j)]
    )


def symmetrized_delay_ms(gc: ConnectivityGraph, tp: TrainingParams, i: Node, j: Node) -> float:
    """d_c^(u)(i,j) = (d_c(i,j) + d_c(j,i)) / 2 (Prop. 3.1)."""
    return 0.5 * (connectivity_delay_ms(gc, tp, i, j) + connectivity_delay_ms(gc, tp, j, i))


def node_capacitated_sym_delay_ms(
    gc: ConnectivityGraph, tp: TrainingParams, i: Node, j: Node
) -> float:
    """The symmetric weight used by Algorithm 1 (lines 1-3):

    [ s*(T_c(i)+T_c(j)) + l(i,j) + l(j,i) + M/C_UP(i) + M/C_UP(j) ] / 2
    """
    pi, pj = gc.silo_params[i], gc.silo_params[j]
    return 0.5 * (
        tp.local_steps * (pi.comp_time_ms + pj.comp_time_ms)
        + gc.latency_ms[(i, j)]
        + gc.latency_ms[(j, i)]
        + tp.model_size_mbits / pi.uplink_gbps
        + tp.model_size_mbits / pj.uplink_gbps
    )


def overlay_delay_digraph(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlay_edges,
) -> DelayDigraph:
    """Build the full delay digraph of an overlay (directed edge list),
    applying the degree-dependent access-link sharing of Eq. 3 and adding
    the self-loop computation delays d_o(i,i) = s*T_c(i)."""
    overlay_edges = list(overlay_edges)
    out_deg: Dict[Node, int] = {v: 0 for v in gc.silos}
    in_deg: Dict[Node, int] = {v: 0 for v in gc.silos}
    for (i, j) in overlay_edges:
        if i == j:
            continue
        out_deg[i] += 1
        in_deg[j] += 1
    delays: Dict[Edge, float] = {}
    for (i, j) in overlay_edges:
        if i == j:
            continue
        if not gc.has_edge(i, j):
            raise ValueError(f"overlay edge {(i, j)} not in connectivity graph")
        delays[(i, j)] = edge_delay_ms(gc, tp, i, j, out_deg[i], in_deg[j])
    for v in gc.silos:
        delays[(v, v)] = tp.local_steps * gc.silo_params[v].comp_time_ms
    return DelayDigraph(tuple(gc.silos), delays)


def overlay_delay_matrix(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlay_edges,
) -> np.ndarray:
    """Dense ``[N, N]`` Eq. 3 delay matrix of one overlay (``-inf`` holes).

    Row/column order follows ``gc.silos``; diagonal carries the self-loop
    computation delays ``d_o(i, i) = s * T_c(i)``.  This is the matrix
    form consumed by :mod:`repro_torch.core.maxplus_vec`.
    """
    arcs = [e for e in overlay_edges if e[0] != e[1]]
    for (i, j) in arcs:
        if not gc.has_edge(i, j):
            raise ValueError(f"overlay edge {(i, j)} not in connectivity graph")
    masks = np.ones((1, len(arcs)), dtype=bool)
    return batched_overlay_delay_matrices(gc, tp, arcs, masks)[0]


@span_fn("engine.price_matrices")
def batched_overlay_delay_matrices(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    arcs: Sequence[Edge],
    masks: np.ndarray,
) -> np.ndarray:
    """Eq. 3 delay matrices for a batch of candidate overlays at once.

    ``arcs`` is the pool of distinct directed silo pairs and ``masks`` a
    ``[B, E]`` boolean selection (candidate b uses arc e iff
    ``masks[b, e]``).  Degrees — and therefore the access-link sharing
    term of Eq. 3 — are recomputed per candidate, fully vectorized.
    Returns ``[B, N, N]`` with ``-inf`` holes and self-loop diagonals.
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
    W = np.full((B, n, n), MISSING, dtype=np.float64)
    idx = np.arange(n)
    W[:, idx, idx] = comp[None, :]
    if E == 0:
        return W
    src = np.array([index[i] for (i, _) in arcs])
    dst = np.array([index[j] for (_, j) in arcs])
    if np.any(src == dst):
        raise ValueError("arc pool must not contain self-loops")
    lat = np.array([gc.latency_ms[(i, j)] for (i, j) in arcs])
    bwa = np.array([gc.available_bw_gbps[(i, j)] for (i, j) in arcs])
    up = np.array([gc.silo_params[v].uplink_gbps for v in gc.silos])
    dn = np.array([gc.silo_params[v].downlink_gbps for v in gc.silos])
    # Per-candidate degrees: one matmul against arc-endpoint one-hots
    # (cast first: numpy's bool-times-float matmul path is far slower).
    eye = np.eye(n)
    maskf = masks.astype(np.float64)
    out_deg = maskf @ eye[src]  # [B, N]
    in_deg = maskf @ eye[dst]
    rate = np.minimum(
        up[src][None, :] / np.maximum(out_deg[:, src], 1.0),
        dn[dst][None, :] / np.maximum(in_deg[:, dst], 1.0),
    )
    rate = np.minimum(rate, bwa[None, :])
    delay = comp[src][None, :] + lat[None, :] + tp.model_size_mbits / rate
    W[:, src, dst] = np.where(masks, delay, MISSING)
    return W


def is_edge_capacitated(gc: ConnectivityGraph) -> bool:
    """Sufficient condition from Sect. 3.1:
    min(C_UP(i), C_DN(j)) / N >= A(i',j') for every connectivity edge."""
    n = gc.num_silos
    for (i, j) in gc.latency_ms:
        if i == j:
            continue
        up = gc.silo_params[i].uplink_gbps
        dn = gc.silo_params[j].downlink_gbps
        if min(up, dn) / n < gc.available_bw_gbps[(i, j)]:
            return False
    return True
