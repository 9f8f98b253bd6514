"""Time simulator (Algorithm 3, Appendix F): a copy of the reference's
``repro/core/simulator.py`` on the port's host engines.

Reconstructs the wall-clock instants ``t_i(k)`` at which every silo starts
its k-th computation phase, for a fixed overlay, directly from the
max-plus recursion with the Eq. 3 delays.  The asymptotic slope of
``t_i(k)`` is the cycle time, which the tests hold against Karp's
algorithm (the paper's key theoretical identity, Thm 3.23 of [6]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .delays import ConnectivityGraph, TrainingParams, overlay_delay_matrix
from .maxplus_vec import batched_timing_recursion, cycle_time_dense, timing_recursion_dense

Node = Hashable


@dataclass
class Timeline:
    """t[i][k] = time silo i starts computing w_i((s+1)k + 1)."""

    times: Dict[Node, List[float]]
    num_rounds: int

    def finish_time(self, k: Optional[int] = None) -> float:
        k = self.num_rounds if k is None else k
        return max(series[k] for series in self.times.values())

    def empirical_cycle_time(self) -> float:
        k0, k1 = self.num_rounds // 2, self.num_rounds
        return max((s[k1] - s[k0]) / (k1 - k0) for s in self.times.values())

    def rounds_completed_by(self, t_ms: float) -> int:
        """Max k such that every silo has started round k by time t."""
        k = 0
        while k < self.num_rounds and self.finish_time(k + 1) <= t_ms:
            k += 1
        return k


def simulate_overlay(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlay_edges: Sequence[Tuple[Node, Node]],
    num_rounds: int = 100,
) -> Timeline:
    """Run Eq. 4 as a dense ``[N]``-state vector recursion (one
    ``np.max`` sweep per round) and repackage per-silo series."""
    W = overlay_delay_matrix(gc, tp, overlay_edges)
    series = timing_recursion_dense(W, num_rounds)  # [R+1, N]
    times = {v: series[:, k].tolist() for k, v in enumerate(gc.silos)}
    return Timeline(times=times, num_rounds=num_rounds)


def simulate_overlays_batched(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlays: Sequence[Sequence[Tuple[Node, Node]]],
    num_rounds: int = 100,
) -> np.ndarray:
    """Timelines for many candidate overlays in one engine call.

    Returns ``[B, num_rounds + 1, N]`` start times (silo order =
    ``gc.silos``): the bulk companion of :func:`simulate_overlay` for
    scenario sweeps.
    """
    W = np.stack([overlay_delay_matrix(gc, tp, e) for e in overlays])
    return batched_timing_recursion(W, num_rounds)


def predicted_cycle_time(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlay_edges: Sequence[Tuple[Node, Node]],
) -> float:
    """Cycle time of an overlay straight from its measured inputs: build
    the Eq. 3 delay matrix and take the max cycle mean (Eq. 5).  The
    scalar the designers minimize and the simulator's slope converges
    to."""
    return cycle_time_dense(overlay_delay_matrix(gc, tp, overlay_edges))


def training_time_ms(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    overlay_edges: Sequence[Tuple[Node, Node]],
    rounds_to_target: int,
) -> float:
    """Wall-clock time for ``rounds_to_target`` communication rounds: the
    product the paper optimizes (cycle time x rounds, Sect. 4)."""
    tl = simulate_overlay(gc, tp, overlay_edges, num_rounds=rounds_to_target)
    return tl.finish_time(rounds_to_target)
