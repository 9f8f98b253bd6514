"""Event-driven simulator: the Eq. 4 recursion on a time-varying network
(a copy of the reference's ``repro/dynamics/simulate.py``).

Extends Algorithm 3 (Appendix F) from one delay matrix to the ``[E, N, N]``
stack of per-epoch Eq. 3 matrices produced by the scenario layer.  Each
round, every silo transmits with the delays of the epoch containing its
start time (rows of the effective matrix are gathered per silo — see
:func:`repro_torch.core.maxplus_vec.timing_recursion_piecewise`), so
failures and stragglers show up as transients exactly at the event
boundary.

Three entry points, all host numpy:

* :func:`simulate_dynamic`          — one (scenario, overlay) run with full
                                      reporting: realized round times,
                                      per-epoch empirical vs predicted
                                      cycle times, throughput loss vs the
                                      static-optimal overlay;
* :func:`simulate_scenarios_batched`— many scenarios at once through
                                      ``batched_timing_recursion_piecewise``
                                      (epoch grids padded to a common E);
* :class:`DynamicTimeline`          — a round-by-round stepper with a
                                      swappable overlay: the plant the
                                      online controller closes its loop
                                      around.

:func:`schedule_epoch_estimates` prices a schedule per epoch; a randomized
schedule's Monte-Carlo recursion runs on ``device`` (one launch of K1's
timing entry per epoch on the card).  :meth:`DynamicTimeline.attach_recorder`
makes the timeline write an ``epoch`` flight-recorder record
(:mod:`repro_torch.obs.events`) whenever its round front enters a new
network epoch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.delays import TrainingParams, overlay_delay_matrix
from ..core.maxplus_vec import (
    NEG_INF,
    _epoch_of,
    batched_cycle_time,
    batched_timing_recursion_piecewise,
    missing_mask,
)
from ..core.schedule import Schedule, ScheduleEstimate
from ..device import DeviceLike
from .events import NetworkEpoch, Scenario, active_subgraph

Arc = Tuple[int, int]


def _epoch_matrix(
    epoch: NetworkEpoch, tp: TrainingParams, overlay_edges: Sequence[Arc]
) -> np.ndarray:
    """Eq. 3 delay matrix of one epoch, overlay arcs filtered to the pairs
    that still exist (both endpoints active, pair routed)."""
    keep = set(epoch.active)
    arcs = [
        (i, j)
        for (i, j) in overlay_edges
        if i != j and i in keep and j in keep and epoch.gc.has_edge(i, j)
    ]
    return overlay_delay_matrix(epoch.gc, tp, arcs)


def epoch_delay_matrices(
    scenario: Scenario, tp: TrainingParams, overlay_edges: Sequence[Arc]
) -> Tuple[np.ndarray, np.ndarray, List[NetworkEpoch]]:
    """``([E, N, N] delay stack, [E] epoch starts, epochs)`` for a fixed
    overlay riding through the scenario."""
    epochs = scenario.segments()
    Ws = np.stack([_epoch_matrix(e, tp, overlay_edges) for e in epochs])
    starts = np.array([e.t_start_ms for e in epochs])
    return Ws, starts, epochs


@dataclass(frozen=True)
class DynamicRun:
    """Result of one (scenario, overlay) simulation."""

    times: np.ndarray  # [R+1, N] silo start times
    round_finish_ms: np.ndarray  # [R+1] max over silos
    round_durations_ms: np.ndarray  # [R] finish-to-finish increments
    epoch_starts_ms: np.ndarray  # [E]
    predicted_tau_ms: np.ndarray  # [E] Karp cycle time of each epoch matrix
    empirical_tau_ms: np.ndarray  # [E] realized slope inside each epoch (nan if <4 rounds)

    @property
    def num_rounds(self) -> int:
        return len(self.round_durations_ms)

    def rounds_completed_by(self, t_ms: float) -> int:
        """Max k such that every silo has started round k by ``t_ms``."""
        return int(np.searchsorted(self.round_finish_ms, t_ms, side="right")) - 1

    def throughput_loss_vs(self, tau_static_ms: float, deadline_ms: float) -> float:
        """1 - realized/ideal rounds by the deadline, against an idealized
        static network where every round costs ``tau_static_ms``."""
        ideal = deadline_ms / tau_static_ms
        return 1.0 - self.rounds_completed_by(deadline_ms) / ideal


def simulate_dynamic(
    scenario: Scenario,
    tp: TrainingParams,
    overlay_edges: Sequence[Arc],
    num_rounds: int = 200,
) -> DynamicRun:
    """Ride a *fixed* overlay through the scenario (the non-adaptive
    baseline an online controller is judged against)."""
    Ws, starts, _ = epoch_delay_matrices(scenario, tp, overlay_edges)
    times = batched_timing_recursion_piecewise(
        Ws[None], starts[None], num_rounds
    )[0]
    finish = times.max(axis=1)
    predicted = np.atleast_1d(batched_cycle_time(Ws))
    empirical = _per_epoch_slopes(finish, starts)
    return DynamicRun(
        times=times,
        round_finish_ms=finish,
        round_durations_ms=np.diff(finish),
        epoch_starts_ms=starts,
        predicted_tau_ms=predicted,
        empirical_tau_ms=empirical,
    )


def _per_epoch_slopes(finish: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Realized cycle time inside each epoch: slope of the round-finish
    sequence over the rounds fully contained in the epoch (with one round
    of settling after the boundary; nan when fewer than 4 rounds land)."""
    E = len(starts)
    bounds = np.append(starts, np.inf)
    out = np.full(E, np.nan)
    for e in range(E):
        inside = np.nonzero(
            (finish >= bounds[e]) & (finish < bounds[e + 1])
        )[0]
        if len(inside) >= 4:
            ks = inside[1:]  # drop the boundary-straddling round
            out[e] = (finish[ks[-1]] - finish[ks[0]]) / (ks[-1] - ks[0])
    return out


def simulate_scenarios_batched(
    scenarios: Sequence[Scenario],
    tp: TrainingParams,
    overlay_edges: Sequence[Arc],
    num_rounds: int = 200,
) -> np.ndarray:
    """``[B, R+1, N]`` start times for one overlay under many scenarios.

    Scenarios must share the silo universe; epoch grids are padded to a
    common depth by repeating each scenario's final epoch (a start of
    ``+inf`` is never selected by the epoch gather)."""
    n = scenarios[0].num_silos
    if any(s.num_silos != n for s in scenarios):
        raise ValueError("batched scenarios must share one silo universe")
    stacks = [epoch_delay_matrices(s, tp, overlay_edges)[:2] for s in scenarios]
    E = max(Ws.shape[0] for Ws, _ in stacks)
    B = len(scenarios)
    Ws_all = np.full((B, E, n, n), NEG_INF)
    starts_all = np.full((B, E), np.inf)
    for b, (Ws, starts) in enumerate(stacks):
        e = Ws.shape[0]
        Ws_all[b, :e] = Ws
        Ws_all[b, e:] = Ws[-1]
        starts_all[b, :e] = starts
    return batched_timing_recursion_piecewise(Ws_all, starts_all, num_rounds)


def schedule_epoch_estimates(
    scenario: Scenario,
    tp: TrainingParams,
    schedule: Schedule,
    *,
    rounds: int = 150,
    seeds: Sequence[int] = (0, 1),
    device: DeviceLike = "cuda",
) -> List[ScheduleEstimate]:
    """Price a schedule on *every epoch* of a scenario — the average
    cycle time of a plan distribution per epoch.

    The fixed-overlay analogue is ``DynamicRun.predicted_tau_ms`` (one
    Karp value per epoch); for a randomized schedule each epoch gets a
    Monte-Carlo :class:`~repro_torch.core.schedule.ScheduleEstimate` (τ̄ +
    CI) on that epoch's re-measured, active-silo connectivity graph, its
    recursion on ``device`` (default ``"cuda"``; raises without a GPU
    unless the caller passes ``"cpu"``).
    """
    out: List[ScheduleEstimate] = []
    for epoch in scenario.segments():
        gc = active_subgraph(epoch.gc, epoch.active)
        out.append(schedule.price(gc, tp, rounds=rounds, seeds=seeds, device=device))
    return out


class DynamicTimeline:
    """Round-by-round stepper over a scenario, with a hot-swappable overlay.

    This is the *plant* for closed-loop control: the training loop calls
    :meth:`step` once per communication round and reads off the realized
    duration (what a wall clock would measure); the controller may call
    :meth:`set_overlay` between rounds, which rebuilds the per-epoch delay
    stack while preserving the current silo start times — models swapped
    mid-flight keep their progress.  Host numpy throughout.
    """

    def __init__(self, scenario: Scenario, tp: TrainingParams):
        self.scenario = scenario
        self.tp = tp
        self.epochs = scenario.segments()
        self.starts = np.array([e.t_start_ms for e in self.epochs])
        self.t = np.zeros(scenario.num_silos)
        self.round_finish_ms: List[float] = [0.0]
        self.overlay_edges: Optional[Tuple[Arc, ...]] = None
        self._Weff: Optional[np.ndarray] = None
        self._schedule: Optional[Schedule] = None
        self._sched_cache: dict = {}
        self.recorder = None  # optional flight recorder (attach_recorder)
        self._epoch_emitted = -1

    @property
    def now_ms(self) -> float:
        return self.round_finish_ms[-1]

    @property
    def rounds_done(self) -> int:
        return len(self.round_finish_ms) - 1

    def set_overlay(self, overlay_edges: Sequence[Arc]) -> None:
        self._schedule = None
        self.overlay_edges = tuple(overlay_edges)
        Ws = np.stack(
            [_epoch_matrix(e, self.tp, self.overlay_edges) for e in self.epochs]
        )
        idx = np.arange(Ws.shape[-1])
        diag = Ws[:, idx, idx]
        Ws[:, idx, idx] = np.where(missing_mask(diag), 0.0, diag)
        self._Weff = Ws

    def set_schedule(self, schedule: Schedule) -> None:
        """Install a :class:`~repro_torch.core.schedule.Schedule` as the
        plant's communication topology.

        A deterministic schedule takes the precomputed per-epoch fast
        path of :meth:`set_overlay`; a randomized one samples its overlay
        per round from the shared round counter (``round_edges(k)`` with
        ``k = rounds_done``), pricing the sampled arcs on whichever epoch
        each sender currently sits in — delay matrices are cached per
        (sampled edge set, epoch).
        """
        if not schedule.is_randomized:
            self.set_overlay(schedule.round_edges(0))
            self._schedule = schedule
            return
        self.overlay_edges = None
        self._Weff = None
        self._schedule = schedule
        self._sched_cache.clear()

    @property
    def schedule(self) -> Optional[Schedule]:
        return self._schedule

    _SCHED_CACHE_MAX = 512  # FIFO bound: many-matching schedules rarely repeat

    def _epoch_matrix_cached(self, edges: Tuple[Arc, ...], ei: int) -> np.ndarray:
        key = (edges, ei)
        W = self._sched_cache.get(key)
        if W is None:
            W = _epoch_matrix(self.epochs[ei], self.tp, edges)
            idx = np.arange(W.shape[-1])
            diag = W[idx, idx]
            W[idx, idx] = np.where(missing_mask(diag), 0.0, diag)
            if len(self._sched_cache) >= self._SCHED_CACHE_MAX:
                self._sched_cache.pop(next(iter(self._sched_cache)))
            self._sched_cache[key] = W
        return W

    def attach_recorder(self, recorder) -> None:
        """Emit an ``epoch`` trace record (index, start time, active set)
        whenever the plant's round front crosses into a new network
        epoch, starting with the epoch it is in right now."""
        self.recorder = recorder
        self._emit_epochs_through(
            int(_epoch_of(self.starts, np.array([self.now_ms]))[0])
        )

    def _emit_epochs_through(self, ei: int) -> None:
        for k in range(self._epoch_emitted + 1, ei + 1):
            ep = self.epochs[k]
            self.recorder.emit(
                "epoch",
                index=k,
                t_start_ms=ep.t_start_ms,  # a host float by construction
                active=list(ep.active),
            )
        self._epoch_emitted = max(self._epoch_emitted, ei)

    def current_epoch(self) -> NetworkEpoch:
        """Epoch containing the current round front — what a measurement
        service would report if probed right now."""
        e = int(_epoch_of(self.starts, np.array([self.now_ms]))[0])
        return self.epochs[e]

    def current_active(self) -> Tuple[int, ...]:
        """Active silo labels of the current epoch — the control-plane
        membership signal (``SiloJoin``/``SiloLeave`` are *known*, not
        inferred from timings).  Feed this as the controller's
        ``membership_provider`` to drive elastic state rebuilds."""
        return self.current_epoch().active

    def step(self) -> float:
        """Advance one communication round; return its realized duration."""
        if self._Weff is None and (
            self._schedule is None or not self._schedule.is_randomized
        ):
            raise RuntimeError("set_overlay()/set_schedule() before stepping")
        e = _epoch_of(self.starts, self.t)  # [N] epoch per sender
        if self._Weff is not None:
            e0 = int(e[0])
            if np.all(e == e0):
                # Common case: every sender sits in the same epoch, so the
                # per-sender gather reduces to a view of one epoch matrix.
                Wk = self._Weff[e0]
            else:
                Wk = self._Weff[e, np.arange(len(self.t)), :]
        else:
            edges = tuple(self._schedule.round_edges(self.rounds_done))
            Wk = np.empty((len(self.t), len(self.t)))
            for ei in np.unique(e):
                rows = e == ei
                Wk[rows] = self._epoch_matrix_cached(edges, int(ei))[rows]
        self.t = np.max(self.t[:, None] + Wk, axis=0)
        finish = float(self.t.max())
        duration = finish - self.round_finish_ms[-1]
        self.round_finish_ms.append(finish)
        if self.recorder is not None:
            self._emit_epochs_through(
                int(_epoch_of(self.starts, np.array([finish]))[0])
            )
        return duration
