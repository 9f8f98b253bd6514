"""Host-side math and topology design of the port.

* numpy copies of the reference's host code: Birkhoff decomposition and
  consensus matrices, the delay digraph and Eq. 3 pricing
  (:mod:`.delays`), the underlays of the paper (:mod:`.underlay`,
  :mod:`.networks_data`), the dense and sparse Karp engines and
  ``DeltaPricer`` (:mod:`.maxplus_vec`, :mod:`.maxplus_sparse`) and the
  host designers (:mod:`.topologies`);
* numpy copies of the time simulator of Algorithm 3 (:mod:`.simulator`)
  and the exact brute-force MCT solver (``brute_force_mct``), an oracle
  for tiny N;
* numpy copies of MATCHA (:mod:`.matcha`), the schedule API
  (:mod:`.schedule`: ``FixedSchedule``, ``MatchaSchedule``, the budget
  sweep) and mixing-rate pricing (:mod:`.mixing`);
* on a torch device: the sparse Karp twin
  :func:`~repro_torch.core.maxplus_sparse.batched_cycle_time_sparse_torch`,
  the rewire climb behind ``search_overlays_jit`` and
  ``search_overlays_hierarchical``, and the round-varying Eq. 4 recursion
  that prices every MATCHA chain
  (:func:`~repro_torch.core.maxplus_sparse.timing_recursion_unique_rounds_sparse_torch`).
"""

from .birkhoff import birkhoff_decomposition, reconstruct, schedule_cost
from .consensus import (
    is_doubly_stochastic,
    local_degree_matrix,
    metropolis_matrix,
    ring_matrix,
    spectral_gap,
    star_matrix,
)
from .delays import (
    ConnectivityGraph,
    SiloParams,
    TrainingParams,
    batched_overlay_delay_matrices,
    connectivity_delay_ms,
    edge_delay_ms,
    is_edge_capacitated,
    overlay_delay_digraph,
    overlay_delay_matrix,
    symmetrized_delay_ms,
)
from .maxplus import DelayDigraph
from .maxplus_sparse import (
    DeltaPricer,
    EdgeBatch,
    batched_cycle_time_auto,
    batched_cycle_time_sparse,
    batched_cycle_time_sparse_torch,
    batched_is_strongly_connected_sparse,
    batched_overlay_delay_edges,
    critical_circuit_sparse,
    cycle_time_engine,
    reachable_from_sparse,
    scc_labels_sparse,
    timing_recursion_unique_rounds_sparse_torch,
)
from .maxplus_vec import (
    MISSING,
    batched_cycle_time,
    batched_is_strongly_connected,
    cycle_time_dense,
    edges_to_matrix,
    graph_to_matrix,
    karp_from_levels,
    missing_mask,
    reachability_closure,
    scc_labels,
)
from .networks_data import EXPECTED_SIZES, GAIA_SITES, NETWORK_NAMES, WORKLOADS, make_underlay
from .topologies import (
    OVERLAY_KINDS,
    SCHEDULE_KINDS,
    Overlay,
    algorithm1_mbst,
    brute_force_mct,
    christofides_tour,
    cluster_silos,
    delta_prim,
    design_overlay,
    design_schedule,
    evaluate_overlay,
    mst_overlay,
    ring_overlay,
    search_overlays_delta,
    search_overlays_hierarchical,
    search_overlays_jit,
    star_overlay,
    two_opt_ring_overlay,
)
from .simulator import (
    Timeline,
    predicted_cycle_time,
    simulate_overlay,
    simulate_overlays_batched,
    training_time_ms,
)
from .underlay import Underlay, haversine_km, link_latency_ms
from .matcha import Matcha, greedy_edge_coloring, matcha_from_connectivity, matcha_plus_from_underlay
from .schedule import (
    DEFAULT_MATCHA_BUDGETS,
    FixedSchedule,
    MatchaSchedule,
    Schedule,
    ScheduleEstimate,
    ScheduleInfeasibleError,
    average_cycle_times_batched,
    design_matcha_schedule,
    matcha_schedule_from_connectivity,
    matcha_schedule_from_underlay,
    schedule_from_matcha,
)
from .mixing import (
    OBJECTIVES,
    WEIGHT_RULES,
    batched_mixing_matrices,
    batched_rho,
    batched_rho_torch,
    batched_spectral_gap,
    batched_spectral_gap_torch,
    contraction_from_gram,
    matcha_expected_gram,
    mixing_matrix,
    overlay_mixing_matrix,
    overlay_rho,
    overlay_rho_batch,
    pareto_frontier,
    schedule_rho,
    score_estimate,
    wall_clock_to_eps,
)

__all__ = [
    "birkhoff_decomposition", "reconstruct", "schedule_cost",
    "is_doubly_stochastic", "local_degree_matrix", "metropolis_matrix", "ring_matrix",
    "spectral_gap", "star_matrix",
    "ConnectivityGraph", "SiloParams", "TrainingParams",
    "batched_overlay_delay_matrices", "connectivity_delay_ms", "edge_delay_ms",
    "is_edge_capacitated", "overlay_delay_digraph", "overlay_delay_matrix",
    "symmetrized_delay_ms", "DelayDigraph",
    "DeltaPricer", "EdgeBatch", "batched_cycle_time_auto", "batched_cycle_time_sparse",
    "batched_cycle_time_sparse_torch", "batched_is_strongly_connected_sparse",
    "batched_overlay_delay_edges", "critical_circuit_sparse", "cycle_time_engine",
    "reachable_from_sparse", "scc_labels_sparse", "timing_recursion_unique_rounds_sparse_torch",
    "MISSING", "batched_cycle_time", "batched_is_strongly_connected", "cycle_time_dense",
    "edges_to_matrix", "graph_to_matrix", "karp_from_levels", "missing_mask",
    "reachability_closure", "scc_labels",
    "EXPECTED_SIZES", "GAIA_SITES", "NETWORK_NAMES", "WORKLOADS", "make_underlay",
    "OVERLAY_KINDS", "SCHEDULE_KINDS", "Overlay", "algorithm1_mbst", "brute_force_mct",
    "christofides_tour",
    "cluster_silos", "delta_prim", "design_overlay", "design_schedule", "evaluate_overlay", "mst_overlay", "ring_overlay",
    "search_overlays_delta", "search_overlays_hierarchical", "search_overlays_jit",
    "star_overlay", "two_opt_ring_overlay",
    "Timeline", "predicted_cycle_time", "simulate_overlay", "simulate_overlays_batched",
    "training_time_ms",
    "Underlay", "haversine_km", "link_latency_ms",
    "Matcha", "greedy_edge_coloring", "matcha_from_connectivity", "matcha_plus_from_underlay",
    "DEFAULT_MATCHA_BUDGETS", "FixedSchedule", "MatchaSchedule", "Schedule", "ScheduleEstimate",
    "ScheduleInfeasibleError", "average_cycle_times_batched", "design_matcha_schedule",
    "matcha_schedule_from_connectivity", "matcha_schedule_from_underlay", "schedule_from_matcha",
    "OBJECTIVES", "WEIGHT_RULES", "batched_mixing_matrices", "batched_rho", "batched_rho_torch",
    "batched_spectral_gap", "batched_spectral_gap_torch", "contraction_from_gram",
    "matcha_expected_gram", "mixing_matrix", "overlay_mixing_matrix", "overlay_rho",
    "overlay_rho_batch", "pareto_frontier", "schedule_rho", "score_estimate", "wall_clock_to_eps",
]
