"""Dynamic-network subsystem of the port: time-varying underlays,
event-driven simulation, and online topology re-design (the reference's
``repro.dynamics``, in three layers):

* :mod:`~repro_torch.dynamics.events` — **scenario model** (host numpy).
  A typed event stream (:class:`LinkDegraded`, :class:`LinkFailed`,
  :class:`LinkRestored`, :class:`SiloJoin`, :class:`SiloLeave`,
  :class:`ComputeStraggler`, plus seeded random generators) folds over an
  :class:`~repro_torch.core.underlay.Underlay` into piecewise-constant
  :class:`NetworkEpoch` segments, each with a freshly re-routed
  :class:`~repro_torch.core.delays.ConnectivityGraph`.

* :mod:`~repro_torch.dynamics.simulate` — **event-driven simulator**
  (host numpy).  The Eq. 4 max-plus timing recursion over an ``[E, N,
  N]`` per-epoch stack, and :class:`DynamicTimeline`, the round-by-round
  plant the training loop steps.

* :mod:`~repro_torch.dynamics.controller` — **online controller**.
  Watches measured round durations against the max-plus prediction, and
  on sustained regression (or at once on churn) re-designs — designer
  heuristics and a batched random-ring search on the host, the rewire
  climb :func:`~repro_torch.core.topologies.search_overlays_jit` on its
  ``device`` (K1's ``karp`` and ``reach`` entries on the card) — and
  hot-swaps the result through a :class:`~repro_torch.fed.gossip.PlanSlot`
  or :class:`~repro_torch.fed.gossip.ScheduleSlot`; MATCHA re-fits and the
  calibration run the Eq. 4 recursion on ``device`` (K1's ``timing``
  entry).

Membership is elastic end to end: churn flows from the scenario
(:meth:`DynamicTimeline.current_active`) through the controller's
``membership_provider`` into a :class:`~repro_torch.fed.gossip.MembershipSlot`
that the training loop watches to re-stack its ``[n, P]`` state
(:func:`repro_torch.fed.dpasgd.migrate_silo_state`: survivors
bit-identical, joiners at the survivors' float64 consensus average).
"""

from .events import (
    ComputeStraggler,
    LinkDegraded,
    LinkFailed,
    LinkRestored,
    NetworkEpoch,
    NetworkEvent,
    NetworkState,
    Scenario,
    SiloJoin,
    SiloLeave,
    active_subgraph,
    busiest_core_link,
    churn_scenario,
    link_failure_scenario,
    random_scenario,
    silo_degrade_scenario,
    static_scenario,
)
from .simulate import (
    DynamicRun,
    DynamicTimeline,
    epoch_delay_matrices,
    schedule_epoch_estimates,
    simulate_dynamic,
    simulate_scenarios_batched,
)
from .controller import (
    ControllerConfig,
    OnlineTopologyController,
    Redesign,
    design_best_overlay,
    design_best_schedule,
    design_schedule_portfolio,
    search_ring_candidates,
)

__all__ = [
    "ComputeStraggler", "LinkDegraded", "LinkFailed", "LinkRestored", "NetworkEpoch",
    "NetworkEvent", "NetworkState", "Scenario", "SiloJoin", "SiloLeave", "active_subgraph",
    "busiest_core_link", "churn_scenario", "link_failure_scenario", "random_scenario",
    "silo_degrade_scenario", "static_scenario",
    "DynamicRun", "DynamicTimeline", "epoch_delay_matrices", "schedule_epoch_estimates",
    "simulate_dynamic", "simulate_scenarios_batched",
    "ControllerConfig", "OnlineTopologyController", "Redesign", "design_best_overlay",
    "design_best_schedule", "design_schedule_portfolio", "search_ring_candidates",
]
