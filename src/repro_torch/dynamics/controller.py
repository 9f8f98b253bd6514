"""Online topology re-design controller (a copy of the reference's
``repro/dynamics/controller.py``; every step that reaches a torch device
runs on the controller's ``device``).

Closes the loop the paper leaves open: the designed overlay is
throughput-optimal for the network *as measured*, so when the network
drifts (failure, degradation, straggler, churn) the measured round time
detaches from the max-plus prediction.  The controller

1. **monitors** realized round durations against the simulated max-plus
   round-time profile of the active overlay (a rolling window, a
   two-sided deviation ratio — slow rounds mean congestion, suspiciously
   fast rounds mean vanished arcs — and a strike count to ignore
   one-off jitter);
2. on sustained regression, pulls a fresh connectivity estimate from the
   measurement service and **re-designs**: every Table 1 designer,
   hundreds of seeded ring perturbations scored in one call to the
   batched max-plus engine (`[B, N, N]` Karp — re-scoring ~256 overlays
   at N=22 takes well under a second, cheap enough to live inside the
   training loop), plus the device-side sparse-rewire hill climb
   (:func:`repro_torch.core.topologies.search_overlays_jit`, on the card
   one ``karp`` and one ``reach`` launch of K1 per scored climb step)
   seeded from the *incumbent* overlay — local arc repairs the ring/tree
   candidate families cannot express;
3. **explains** the winning overlay's bottleneck via the critical
   circuit — edge-list extraction
   (:func:`repro_torch.core.maxplus_sparse.critical_circuit_sparse`), so
   the explanation never densifies at scale;
4. **emits** the new :class:`~repro_torch.fed.gossip.GossipPlan` through
   :func:`~repro_torch.fed.topology_runtime.plan_from_overlay` into a
   :class:`~repro_torch.fed.gossip.PlanSlot`, the hot-swap hook the
   training loop rebuilds its step from.

Randomized schedules are in the loop too: with
:attr:`ControllerConfig.matcha_budgets` set, re-design also prices a
MATCHA plan distribution (one batched budgets × seeds sweep) and — under
``schedule_family="matcha"`` — re-fits it to every fresh estimate,
hot-swapping fixed ↔ randomized through a
:class:`~repro_torch.fed.gossip.ScheduleSlot` (whose per-round sampled
plans need no step rebuild: the consensus matrix is a step input).  The
Monte-Carlo pricing of a schedule and the calibration of the expected
round-time profile run the Eq. 4 recursion on ``device`` (one launch of
K1's timing entry per call on the card).

Every decision is traced as in the reference: ``controller.calibrate``
and ``controller.redesign`` spans (:mod:`repro_torch.obs.spans`), the
``controller.*`` metrics, and — with a ``recorder`` — ``regression``,
``membership``, ``swap`` and ``redesign`` flight-recorder records whose
payloads are host floats and ints.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from ..core.delays import (
    ConnectivityGraph,
    TrainingParams,
    batched_overlay_delay_matrices,
)
from ..core.maxplus_sparse import (
    batched_overlay_delay_edges,
    critical_circuit_sparse,
)
from ..core.maxplus_vec import (
    batched_cycle_time,
    batched_is_strongly_connected,
)
from ..core.mixing import (
    OBJECTIVES,
    overlay_rho_batch,
    score_estimate,
)
from ..core.schedule import (
    FixedSchedule,
    Schedule,
    ScheduleEstimate,
    ScheduleInfeasibleError,
    design_matcha_schedule,
)
from ..core.topologies import Overlay, design_overlay, search_overlays_jit
from ..device import DeviceLike, resolve_device
from ..fed.gossip import GossipPlan, MembershipSlot, PlanSlot, ScheduleSlot
from ..fed.topology_runtime import plan_from_overlay
from ..obs import metrics as obs_metrics
from ..obs.events import FlightRecorder
from ..obs.spans import span_fn
from .events import active_subgraph

Arc = Tuple[int, int]


@dataclass(frozen=True)
class ControllerConfig:
    """Tuning knobs of :class:`OnlineTopologyController`.

    ``rewire_restarts``/``rewire_steps`` budget the device-side
    sparse-rewire search (:func:`repro_torch.core.topologies.search_overlays_jit`)
    that extends the re-design candidate pool beyond rings and the
    designer heuristics with local edge rewires of the *incumbent*
    overlay; ``rewire_restarts=0`` disables it (and with it every
    random draw of a torch generator, so a re-design is then the same on
    every device and in both packages).
    """

    window: Optional[int] = None  # rolling-mean span; None = one ring period (N)
    regression_ratio: float = 1.04  # measured / predicted-profile max triggering a strike
    patience: int = 2  # consecutive regressed rounds before re-design
    cooldown_rounds: int = 12  # min rounds between re-designs
    warmup_rounds: Optional[int] = None  # rounds ignored after init/swap; None = window
    calibration_rounds: int = 64  # simulated rounds behind the expected profile
    n_candidates: int = 256  # seeded ring perturbations per re-design
    designers: Tuple[str, ...] = ("ring", "ring_2opt", "mst", "delta_mbst")
    rewire_restarts: int = 8  # parallel sparse-rewire climb states (0 = off)
    rewire_steps: int = 48  # device-side rewire moves per restart
    # Which engine prices the rewire search's proposals: "jit" (device
    # climb, full Karp per proposal), "delta" (host climb, incremental
    # DeltaPricer certificates), or "auto" (size-dispatched — delta
    # above ~384 silos, where per-proposal Karp dominates).
    rewire_engine: str = "auto"  # "auto" | "jit" | "delta"
    # Randomized-schedule candidates: with a nonempty budget tuple every
    # re-design also prices a MATCHA schedule at these budgets (one
    # batched sweep).  Under ``schedule_family="auto"`` it competes with
    # the fixed pool on Monte-Carlo τ̄ — which it rarely wins, since RING
    # tends to dominate cycle time (the paper's headline result); under
    # ``schedule_family="matcha"`` the operator has pinned the family
    # (for its mixing-per-traffic properties) and re-design *re-fits* the
    # distribution — matchings from the fresh estimate, budget re-swept —
    # falling back to the fixed pool only when no matcha schedule is
    # feasible.  Empty budgets (default) keep the controller
    # fixed-overlay-only.
    schedule_family: str = "auto"  # "auto" | "matcha"
    matcha_budgets: Tuple[float, ...] = ()
    matcha_rounds: int = 150  # Monte-Carlo rounds per pricing chain
    matcha_seeds: Tuple[int, ...] = (0, 1, 2)  # chains per budget (CI)
    calibration_seeds: Tuple[int, ...] = (0, 1, 2)  # randomized-profile envelope
    # What re-design optimizes (repro_torch.core.mixing.OBJECTIVES): "tau"
    # ranks every candidate on cycle time alone (the paper's Table 1
    # regime); "time_to_eps" prices each candidate's consensus
    # contraction rho as well and ranks on the composite wall-clock-
    # to-epsilon score tau / -log(rho) — the Sect. 4 framing, under
    # which a well-mixing MATCHA can beat a sparse ring that wins
    # rounds-per-second but mixes at 1 - O(1/N^2) per round.
    objective: str = "tau"  # "tau" | "time_to_eps"
    mixing_rounds: int = 128  # sampled rounds behind E[W^T W] pricing
    seed: int = 0


@dataclass(frozen=True)
class Redesign:
    """One controller actuation, with its audit trail."""

    round_idx: int
    overlay: Optional[Overlay]  # None when a randomized schedule won
    plan: Optional[GossipPlan]  # round-0 plan for randomized schedules
    predicted_tau_ms: float
    measured_ms: float  # rolling round-duration estimate that tripped it
    n_candidates: int  # overlays scored by the batched engine
    elapsed_s: float  # wall time of the whole re-design step
    bottleneck: Tuple[int, ...]  # critical circuit of the new overlay
    expected_window_ms: float = float("nan")  # calibrated profile at trip time
    drift: float = float("nan")  # measured / expected - 1 at trip time
    schedule: Optional[Schedule] = None  # the winning schedule (always set)
    membership: Optional[Tuple[int, ...]] = None  # new active set, when churn
    # triggered this actuation (None: same universe as the previous design)
    rho: float = float("nan")  # winner's consensus contraction (NaN when
    # mixing was not priced, i.e. objective="tau")
    objective: str = "tau"  # the objective this actuation optimized


def search_ring_candidates(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    n_candidates: int,
    rng: np.random.Generator,
) -> Optional[Overlay]:
    """Score ``n_candidates`` random ring tours in one batched engine call.

    Rings are the paper's asymptotically dominant family (Prop. 3.3), and
    as N-arc overlays they are the cheapest candidates to mass-produce;
    the designer heuristics cover the tree-shaped part of the space.
    Returns the best strongly-connected tour (None if every tour hits an
    unrouted pair — e.g. a partitioned network)."""
    silos = list(gc.silos)
    n = len(silos)
    if n < 2 or n_candidates == 0:
        return None
    arcs = [e for e in gc.edges() if e[0] != e[1]]
    arc_index = {a: k for k, a in enumerate(arcs)}
    masks = np.zeros((n_candidates, len(arcs)), dtype=bool)
    tours: List[Optional[List[Arc]]] = []
    for b in range(n_candidates):
        perm = rng.permutation(n)
        tour = [silos[p] for p in perm]
        hops = [(tour[k], tour[(k + 1) % n]) for k in range(n)]
        rows = [arc_index.get(h) for h in hops]
        if any(r is None for r in rows):
            tours.append(None)  # tour uses an unrouted pair; leave mask empty
            continue
        masks[b, rows] = True
        tours.append(hops)
    W = batched_overlay_delay_matrices(gc, tp, arcs, masks)
    valid = np.array([t is not None for t in tours])
    strong = batched_is_strongly_connected(W) & valid
    taus = np.where(strong, batched_cycle_time(W), np.inf)
    k = int(np.argmin(taus))
    if not np.isfinite(taus[k]):
        return None
    return Overlay(
        name="ring_search", edges=tuple(tours[k]), cycle_time_ms=float(taus[k])
    )


def design_best_overlay(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_candidates: int = 256,
    designers: Sequence[str] = ControllerConfig.designers,
    rng: Optional[np.random.Generator] = None,
    incumbent: Optional[Overlay] = None,
    rewire_restarts: int = 0,
    rewire_steps: int = 48,
    rewire_engine: str = "auto",
    device: DeviceLike = "cuda",
) -> Tuple[Overlay, int]:
    """(best overlay, number of candidates scored) on the given estimate.

    Candidates = each designer heuristic (skipping any that cannot run on
    the current graph, e.g. δ-MBST on a partitioned estimate), the
    batched random-ring search, and — when ``rewire_restarts > 0`` — the
    device-side sparse-rewire hill climb seeded from ``incumbent``
    (:func:`repro_torch.core.topologies.search_overlays_jit`, on
    ``device``), which explores local repairs of the running overlay the
    ring/tree families cannot express.  A rewire search that finds no
    feasible state adds no candidate."""
    candidates, scored = _overlay_candidates(
        gc,
        tp,
        n_candidates=n_candidates,
        designers=designers,
        rng=rng,
        incumbent=incumbent,
        rewire_restarts=rewire_restarts,
        rewire_steps=rewire_steps,
        rewire_engine=rewire_engine,
        device=device,
    )
    if not candidates:
        raise ValueError("no feasible overlay candidate on the current estimate")
    return min(candidates, key=lambda ov: ov.cycle_time_ms), scored


def _overlay_candidates(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_candidates: int = 256,
    designers: Sequence[str] = ControllerConfig.designers,
    rng: Optional[np.random.Generator] = None,
    incumbent: Optional[Overlay] = None,
    rewire_restarts: int = 0,
    rewire_steps: int = 48,
    rewire_engine: str = "auto",
    device: DeviceLike = "cuda",
) -> Tuple[List[Overlay], int]:
    """The fixed-overlay candidate pool: (feasible candidates, number of
    overlays scored).  Shared by :func:`design_best_overlay` (τ argmin)
    and :func:`design_schedule_portfolio` (which keeps the whole pool so
    every candidate can be priced under any objective).  Designers and the
    ring search run on the host; the rewire climb on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    candidates: List[Overlay] = []
    scored = 0
    for kind in designers:
        try:
            candidates.append(design_overlay(kind, gc, tp, device=dev))
            scored += 1
        except (ValueError, KeyError):
            continue
    ring = search_ring_candidates(gc, tp, n_candidates, rng)
    scored += n_candidates
    if ring is not None:
        candidates.append(ring)
    if rewire_restarts > 0:
        try:
            rewired = search_overlays_jit(
                gc,
                tp,
                n_restarts=rewire_restarts,
                n_steps=rewire_steps,
                seed=int(rng.integers(1 << 31)),
                incumbent=incumbent,
                engine=rewire_engine,
                device=dev,
            )
        except ValueError:
            rewired = None
        if rewired is not None:
            scored += rewire_restarts * rewire_steps
            if _deployable(rewired, gc):
                candidates.append(rewired)
    return candidates, scored


def _deployable(overlay: Overlay, gc: ConnectivityGraph) -> bool:
    """Whether the overlay's consensus matrix (Appendix G.3) is doubly
    stochastic, so that it becomes a gossip plan.  A directed rewire
    result with unbalanced degrees is not (the local-degree rule then
    leaves column sums off 1): the reference keeps it in the pool and
    fails in ``plan_from_overlay`` when it wins; here it is left out, which
    changes nothing when a deployable candidate wins."""
    try:
        plan_from_overlay(overlay, len(gc.silos), silos=gc.silos)
    except ValueError:
        return False
    return True


def design_schedule_portfolio(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_candidates: int = 256,
    designers: Sequence[str] = ControllerConfig.designers,
    rng: Optional[np.random.Generator] = None,
    incumbent: Optional[Overlay] = None,
    rewire_restarts: int = 0,
    rewire_steps: int = 48,
    rewire_engine: str = "auto",
    matcha_budgets: Sequence[float] = (),
    matcha_rounds: int = 150,
    matcha_seeds: Sequence[int] = (0, 1, 2),
    sample_seed: int = 0,
    objective: str = "tau",
    mixing_rounds: int = 128,
    device: DeviceLike = "cuda",
) -> Tuple[List[Tuple[Schedule, ScheduleEstimate]], int]:
    """The whole priced candidate portfolio: ([(schedule, estimate)],
    number of candidates scored).

    Every feasible fixed candidate (designers + ring search + sparse
    rewire) enters as a :class:`FixedSchedule` with its exact Karp τ;
    with a nonempty ``matcha_budgets`` the winning MATCHA budget enters
    too (one batched budgets × seeds sweep).  Under
    ``objective="time_to_eps"`` each estimate also carries its ρ — the
    fixed pool's deployed-matrix contractions priced in *one* batched
    SVD (:func:`repro_torch.core.mixing.overlay_rho_batch`), MATCHA's expected
    contraction from its own sampled activation rows — so callers can
    scalarize (:func:`repro_torch.core.mixing.score_estimate`) or keep the
    (τ, ρ) Pareto frontier (:func:`repro_torch.core.mixing.pareto_frontier`).
    Under ``objective="tau"`` ρ stays NaN and no spectral cost is paid.
    The rewire climb and the MATCHA sweep's recursion run on ``device``.
    """
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; one of {OBJECTIVES}"
        )
    rng = np.random.default_rng(0) if rng is None else rng
    overlays, scored = _overlay_candidates(
        gc,
        tp,
        n_candidates=n_candidates,
        designers=designers,
        rng=rng,
        incumbent=incumbent,
        rewire_restarts=rewire_restarts,
        rewire_steps=rewire_steps,
        rewire_engine=rewire_engine,
        device=device,
    )
    if objective == "time_to_eps" and overlays:
        rhos = overlay_rho_batch(
            overlays, gc.num_silos, silos=tuple(gc.silos)
        )
    else:
        rhos = np.full(len(overlays), float("nan"), dtype=np.float64)
    portfolio: List[Tuple[Schedule, ScheduleEstimate]] = [
        (
            FixedSchedule(ov),
            ScheduleEstimate(
                tau_ms=ov.cycle_time_ms,
                ci95_ms=0.0,
                per_seed_ms=(ov.cycle_time_ms,),
                rho=float(rho),
            ),
        )
        for ov, rho in zip(overlays, rhos)
    ]
    if matcha_budgets:
        try:
            sched, est = design_matcha_schedule(
                gc,
                tp,
                budgets=tuple(matcha_budgets),
                rounds=matcha_rounds,
                seeds=tuple(matcha_seeds),
                sample_seed=sample_seed,
                objective=objective,
                mixing_rounds=mixing_rounds,
                device=device,
            )
            scored += len(matcha_budgets) * len(matcha_seeds)
            portfolio.append((sched, est))
        except ScheduleInfeasibleError:  # no routable pairs on this estimate
            pass
    return portfolio, scored


def design_best_schedule(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    n_candidates: int = 256,
    designers: Sequence[str] = ControllerConfig.designers,
    rng: Optional[np.random.Generator] = None,
    incumbent: Optional[Overlay] = None,
    rewire_restarts: int = 0,
    rewire_steps: int = 48,
    rewire_engine: str = "auto",
    matcha_budgets: Sequence[float] = (),
    matcha_rounds: int = 150,
    matcha_seeds: Sequence[int] = (0, 1, 2),
    sample_seed: int = 0,
    objective: str = "tau",
    mixing_rounds: int = 128,
    device: DeviceLike = "cuda",
) -> Tuple[Schedule, int]:
    """(best schedule, number of candidates scored): the schedule-valued
    superset of :func:`design_best_overlay`.

    Scalarizes :func:`design_schedule_portfolio` under ``objective``:
    ``"tau"`` compares candidates on cycle time alone (randomized
    schedules on mean Monte-Carlo τ̄ — which they rarely win, the
    paper's headline result); ``"time_to_eps"`` on the composite
    ``τ / −log(ρ)``, under which MATCHA's mixing-per-traffic advantage
    is finally visible to the auto-family arbitration.  Exact ties go
    to the fixed pool (listed first).
    """
    portfolio, scored = design_schedule_portfolio(
        gc,
        tp,
        n_candidates=n_candidates,
        designers=designers,
        rng=rng,
        incumbent=incumbent,
        rewire_restarts=rewire_restarts,
        rewire_steps=rewire_steps,
        rewire_engine=rewire_engine,
        matcha_budgets=matcha_budgets,
        matcha_rounds=matcha_rounds,
        matcha_seeds=matcha_seeds,
        sample_seed=sample_seed,
        objective=objective,
        mixing_rounds=mixing_rounds,
        device=device,
    )
    if not portfolio:
        raise ValueError("no feasible overlay candidate on the current estimate")
    best, _ = min(portfolio, key=lambda c: score_estimate(c[1], objective))
    return best, scored


class OnlineTopologyController:
    """Monitor -> detect -> re-design -> hot-swap, one overlay at a time.

    ``connectivity_provider`` is the measurement service: it returns the
    current connectivity estimate (restricted to active silos) whenever
    the controller decides to re-design.  In the simulator it is backed by
    the scenario's current epoch; in a deployment it would be the same
    probing that produced the initial measurements (Sect. 2.2).
    """

    def __init__(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        overlay: Overlay,
        *,
        config: ControllerConfig = ControllerConfig(),
        connectivity_provider: Optional[Callable[[], ConnectivityGraph]] = None,
        plan_slot: Optional[PlanSlot] = None,
        schedule_slot: Optional[ScheduleSlot] = None,
        schedule: Optional[Schedule] = None,
        membership_slot: Optional[MembershipSlot] = None,
        membership_provider: Optional[Callable[[], Sequence[int]]] = None,
        recorder: Optional[FlightRecorder] = None,
        silo_names: Optional[Sequence[str]] = None,
        device: DeviceLike = "cuda",
    ):
        """``overlay`` is the initial (or fallback) fixed overlay; pass
        ``schedule`` to start on a randomized one instead (``overlay``
        still seeds the incumbent-local rewire search at re-design).
        ``schedule_slot`` is the schedule-valued hot-swap hook — it
        receives *every* winner, fixed or randomized; ``plan_slot`` keeps
        the fixed-plan interface and is skipped (with an audit note) when
        a randomized schedule wins.

        ``membership_provider`` is the control-plane signal of elastic
        membership: the current active silo set (in a deployment, the
        consortium's registration service; in the simulator, the
        scenario's current epoch).  Unlike congestion — which must be
        *inferred* from round timings through the strike detector — churn
        is *known*, so a membership change triggers an immediate
        re-design over the surviving universe, bypassing warmup, strikes,
        and cooldown.  The new active set is published through
        ``membership_slot`` (see :class:`~repro_torch.fed.gossip.MembershipSlot`)
        *before* the plan/schedule slots are resized onto it, so the
        training loop always observes membership first and can rebuild
        its state before its step.

        ``recorder`` (a :class:`repro_torch.obs.events.FlightRecorder`)
        makes every decision externally auditable: a ``regression`` record
        when the strike detector trips, a ``redesign`` record per actuation
        (with the critical circuit, by silo name when ``silo_names`` maps
        labels to sites), ``membership`` and ``swap`` records as the slots
        move.  ``None`` (the default) emits nothing.

        ``device`` is where the rewire climb, the MATCHA sweeps and
        pricing, and the calibration's Eq. 4 recursion run (default
        ``"cuda"``; raises without a GPU unless the caller passes
        ``"cpu"``).  The designers, the ring search and the critical
        circuit run on the host."""
        self.device = resolve_device(device)
        self.tp = tp
        self.config = config
        self.gc = gc
        self._gc_full = gc  # launch-time estimate over the full universe
        self.overlay = overlay
        self.schedule: Schedule = (
            schedule if schedule is not None else FixedSchedule(overlay)
        )
        if self.schedule.is_randomized:
            est = self.schedule.price(
                gc, tp, rounds=config.matcha_rounds,
                seeds=(config.matcha_seeds[0],), device=self.device,
            )
            self.predicted_tau_ms = est.tau_ms
        else:
            self.predicted_tau_ms = overlay.cycle_time_ms
        self.connectivity_provider = connectivity_provider
        self.plan_slot = plan_slot
        self.schedule_slot = schedule_slot
        self.membership_slot = membership_slot
        self.membership_provider = membership_provider
        self._active: Tuple[int, ...] = (
            membership_slot.active
            if membership_slot is not None
            else tuple(sorted(gc.silos))
        )
        self.plan = plan_from_overlay(overlay, len(gc.silos), silos=gc.silos)
        if plan_slot is not None and plan_slot.version == 0:
            plan_slot.swap(self.plan, label="controller-init")
        if schedule_slot is not None and schedule_slot.version == 0:
            schedule_slot.swap_schedule(self.schedule, label="controller-init")
        self._rng = np.random.default_rng(config.seed)
        self._window_size = config.window or len(gc.silos)
        self._warmup = (
            config.warmup_rounds
            if config.warmup_rounds is not None
            else self._window_size
        )
        self._window: Deque[float] = deque(maxlen=self._window_size)
        self._window_sum = 0.0
        self._strikes = 0
        self._round = 0
        self._rounds_since_swap = 0
        self._last_redesign = -config.cooldown_rounds
        self.redesigns: List[Redesign] = []
        self.recorder = recorder
        self._silo_names = list(silo_names) if silo_names is not None else None
        # Last observed deviation (the rolling window and its drift
        # against the calibrated profile), for callers that report it.
        self.last_measured_ms: Optional[float] = None
        self.last_drift: Optional[float] = None
        self._calibrate()

    @span_fn("controller.calibrate")
    def _calibrate(self) -> None:
        """Expected rolling round-time profile of the active *schedule* on
        the current estimate, from the Eq. 4 recursion itself (on
        ``device``: one launch of K1's timing entry on the card).

        Max-plus round durations are not constant — they settle into a
        periodic regime oscillating around tau — so comparing a measured
        rolling mean against bare tau false-alarms on healthy networks.
        Simulating the recursion gives the *whole* predicted profile; the
        detector thresholds against its worst settled rolling mean, which
        lets ``regression_ratio`` sit a few percent above 1.  Randomized
        schedules add sampling variance on top of the max-plus transient,
        so their band is the envelope over several seeded rollouts
        (``calibration_seeds``)."""
        w = self._window_size
        rounds = max(self.config.calibration_rounds, 3 * w)
        seeds = (
            self.config.calibration_seeds
            if self.schedule.is_randomized
            else (0,)
        )
        profiles = self.schedule.simulate_rounds_batch(
            self.gc, self.tp, rounds, seeds, device=self.device
        )  # all seed chains in one engine call
        maxes, mins = [], []
        for durations in profiles:
            rolling = np.convolve(durations, np.ones(w) / w, mode="valid")
            settled = rolling[min(w, len(rolling) - 1):]
            maxes.append(settled.max())
            mins.append(settled.min())
        self.expected_window_ms = float(max(maxes))
        self.expected_window_min_ms = float(min(mins))

    @property
    def measured_ms(self) -> Optional[float]:
        if len(self._window) < self._window_size:
            return None
        # O(1) running sum: this property is read every observed round.
        return self._window_sum / self._window_size

    def _window_push(self, duration_ms: float) -> None:
        if len(self._window) == self._window_size:
            self._window_sum -= self._window[0]  # deque evicts leftmost
        self._window.append(duration_ms)
        self._window_sum += duration_ms

    def observe_round(self, duration_ms: float) -> Optional[Redesign]:
        """Feed one realized round duration; maybe returns an actuation."""
        self._round += 1
        self._rounds_since_swap += 1
        if self.membership_provider is not None:
            active = tuple(sorted(self.membership_provider()))
            if active != self._active:
                # Churn is control-plane knowledge, not a timing anomaly:
                # re-design immediately over the surviving universe (no
                # warmup / strikes / cooldown — a departed silo must stop
                # being mixed with, a joiner must start).
                measured = self.measured_ms
                return self._redesign(
                    measured if measured is not None else duration_ms,
                    membership=active,
                )
        if self._rounds_since_swap <= self._warmup:
            return None  # swap transient: not the network's fault
        self._window_push(duration_ms)
        measured = self.measured_ms
        self.last_measured_ms = measured
        self.last_drift = (
            measured / self.expected_window_ms - 1.0
            if measured is not None and self.expected_window_ms
            else None
        )
        if measured is None:
            return None
        # Two-sided: slower-than-predicted means congestion/failure/straggler;
        # *faster*-than-predicted means arcs silently vanished (e.g. a silo
        # left and the ring broke) — rounds speed up while mixing stops.
        # Either way the max-plus model is stale and the overlay needs
        # re-designing on a fresh estimate.
        ratio = self.config.regression_ratio
        deviates = (
            measured > ratio * self.expected_window_ms
            or measured < self.expected_window_min_ms / ratio
        )
        self._strikes = self._strikes + 1 if deviates else 0
        if self._strikes < self.config.patience:
            return None
        if self._round - self._last_redesign < self.config.cooldown_rounds:
            return None
        if self.recorder is not None:
            self.recorder.emit(
                "regression",
                round_idx=self._round,
                measured_ms=measured,
                expected_window_ms=self.expected_window_ms,
                drift=self.last_drift,
                strikes=self._strikes,
            )
        obs_metrics.counter("controller.regressions").inc()
        return self._redesign(measured)

    def _sparse_bottleneck(self, edges) -> Tuple[int, ...]:
        """Critical circuit of an edge list on the current estimate via
        the edge-list extractor — no dense [N, N] materialization, so the
        explanation step scales with the controller."""
        arcs = [e for e in edges if e[0] != e[1]]
        if not arcs:
            return ()
        eb = batched_overlay_delay_edges(
            self.gc, self.tp, arcs, np.ones((1, len(arcs)), dtype=bool)
        )
        _, circ = critical_circuit_sparse(
            eb.src[0], eb.dst[0], eb.w[0], self.gc.num_silos
        )
        return tuple(self.gc.silos[c] for c in circ)

    def _names(self, labels: Sequence[int]) -> List[str]:
        """Silo labels -> site names, where the launch-time mapping has
        one (labels index the full universe, so it survives churn)."""
        names = self._silo_names
        return [
            names[s] if names is not None and 0 <= s < len(names) else str(s)
            for s in labels
        ]

    @span_fn("controller.redesign")
    def _redesign(
        self, measured: float, membership: Optional[Tuple[int, ...]] = None
    ) -> Redesign:
        t0 = time.perf_counter()
        expected = self.expected_window_ms  # profile that tripped (pre-recal)
        drift = measured / expected - 1.0 if expected else float("nan")
        if self.connectivity_provider is not None:
            self.gc = self.connectivity_provider()
        elif membership is not None:
            # no measurement service: restrict the launch-time estimate
            # to the reported membership so the designed plan/schedule
            # spans exactly the silos the MembershipSlot publishes (the
            # full-universe snapshot also covers rejoining silos)
            self.gc = active_subgraph(self._gc_full, membership)
        if membership is not None and membership != self._active:
            old_active = self._active
            self._active = membership
            if self.membership_slot is not None:
                # Publish membership before resizing plan/schedule slots:
                # the training loop rebuilds its state off this.
                self.membership_slot.swap(
                    membership,
                    label=(
                        f"round{self._round}: {len(old_active)} -> "
                        f"{len(membership)} silos"
                    ),
                )
            if self.recorder is not None:
                self.recorder.emit(
                    "membership",
                    step=self._round,
                    version=(
                        self.membership_slot.version
                        if self.membership_slot is not None
                        else -1
                    ),
                    n_before=len(old_active),
                    n_after=len(membership),
                    left=self._names(sorted(set(old_active) - set(membership))),
                    joined=self._names(
                        sorted(set(membership) - set(old_active))
                    ),
                )
        else:
            membership = None  # unchanged universe: not a membership event
        best_sched: Optional[Schedule] = None
        sched_tau: Optional[float] = None
        sched_est: Optional[ScheduleEstimate] = None
        scored = 0
        if self.config.schedule_family == "matcha" and self.config.matcha_budgets:
            try:  # family pinned: re-fit the distribution to the estimate
                best_sched, est = design_matcha_schedule(
                    self.gc,
                    self.tp,
                    budgets=self.config.matcha_budgets,
                    rounds=self.config.matcha_rounds,
                    seeds=self.config.matcha_seeds,
                    sample_seed=int(self._rng.integers(1 << 31)),
                    objective=self.config.objective,
                    mixing_rounds=self.config.mixing_rounds,
                    device=self.device,
                )
                sched_tau = est.tau_ms
                sched_est = est
                scored = len(self.config.matcha_budgets) * len(
                    self.config.matcha_seeds
                )
            except ScheduleInfeasibleError as e:
                best_sched = None  # infeasible: fall back to the fixed pool
                if self.schedule_slot is not None:  # leave an audit trail
                    self.schedule_slot.history.append(
                        (
                            self.schedule_slot.version,
                            f"round{self._round}: matcha re-fit infeasible "
                            f"({e}); using the fixed pool",
                        )
                    )
        if best_sched is None:
            portfolio, scored = design_schedule_portfolio(
                self.gc,
                self.tp,
                n_candidates=self.config.n_candidates,
                designers=self.config.designers,
                rng=self._rng,
                incumbent=self.overlay,
                rewire_restarts=self.config.rewire_restarts,
                rewire_steps=self.config.rewire_steps,
                rewire_engine=self.config.rewire_engine,
                matcha_budgets=self.config.matcha_budgets,
                matcha_rounds=self.config.matcha_rounds,
                matcha_seeds=self.config.matcha_seeds,
                sample_seed=int(self._rng.integers(1 << 31)),
                objective=self.config.objective,
                mixing_rounds=self.config.mixing_rounds,
                device=self.device,
            )
            if not portfolio:
                raise ValueError(
                    "no feasible overlay candidate on the current estimate"
                )
            best_sched, sched_est = min(
                portfolio,
                key=lambda c: score_estimate(c[1], self.config.objective),
            )
            if not isinstance(best_sched, FixedSchedule):
                sched_tau = sched_est.tau_ms
        if isinstance(best_sched, FixedSchedule):
            best = best_sched.overlay
            name = best.name
            predicted = best.cycle_time_ms
            bottleneck = self._sparse_bottleneck(best.edges)
            plan = plan_from_overlay(
                best, len(self.gc.silos), silos=self.gc.silos
            )
        else:  # randomized winner: τ̄ of the distribution, not one Karp value
            best = None
            name = f"{best_sched.name}@{best_sched.budget:g}"
            predicted = (
                sched_tau
                if sched_tau is not None  # reuse the sweep's estimate
                else best_sched.price(
                    self.gc, self.tp, rounds=self.config.matcha_rounds,
                    seeds=(self.config.matcha_seeds[0],), device=self.device,
                ).tau_ms
            )
            # Explain with the support's circuit: every matching active —
            # the links the distribution can be throttled by at budget 1.
            bottleneck = self._sparse_bottleneck(
                best_sched._arc_pool(self.gc)[0]
            )
            plan = None
        elapsed = time.perf_counter() - t0
        label = f"round{self._round}:{name}"
        if self.schedule_slot is not None:
            # Re-pinning the label -> row order (silos=...) is only sound
            # when the MembershipSlot swap above published the new
            # universe to the training loop; without one the state is
            # sized at launch and cannot follow.
            resize = membership is not None and self.membership_slot is not None
            if resize or len(self.gc.silos) == self.schedule_slot.plan.n_silos:
                self.schedule_slot.swap_schedule(
                    best_sched,
                    label=label,
                    silos=tuple(self.gc.silos) if resize else None,
                )
                if self.recorder is not None:
                    self.recorder.emit(
                        "swap",
                        slot="schedule",
                        version=self.schedule_slot.version,
                        label=label,
                        resized=resize,
                    )
                if plan is None:
                    plan = self.schedule_slot.plan
            else:
                # Churn changed the silo count but no MembershipSlot can
                # tell the training loop to rebuild; keep the running
                # schedule and leave an audit note (same discipline as
                # the plan slot below).
                self.schedule_slot.history.append(
                    (
                        self.schedule_slot.version,
                        f"{label} NOT swapped ({len(self.gc.silos)} != "
                        f"{self.schedule_slot.plan.n_silos} silos without "
                        f"a MembershipSlot)",
                    )
                )
        if self.plan_slot is not None:
            if best is None:
                # The fixed-plan slot cannot follow a plan *distribution*;
                # callers that want randomized actuation listen on a
                # ScheduleSlot.  Audit-note it, as for churn below.
                self.plan_slot.history.append(
                    (
                        self.plan_slot.version,
                        f"{label} NOT swapped (randomized schedule needs "
                        "a ScheduleSlot)",
                    )
                )
            elif plan.n_silos == self.plan_slot.plan.n_silos:
                self.plan_slot.swap(plan, label=label)
                if self.recorder is not None:
                    self.recorder.emit(
                        "swap",
                        slot="plan",
                        version=self.plan_slot.version,
                        label=label,
                        resized=False,
                    )
            elif membership is not None and self.membership_slot is not None:
                # Elastic membership: the MembershipSlot swap above (this
                # actuation's, not a mere slot existing) told the training
                # loop to rebuild its state; the resized plan rides the
                # same actuation.
                self.plan_slot.swap(plan, label=label, allow_resize=True)
                if self.recorder is not None:
                    self.recorder.emit(
                        "swap",
                        slot="plan",
                        version=self.plan_slot.version,
                        label=label,
                        resized=True,
                    )
            else:
                # Churn changed the silo count but without a
                # MembershipSlot the state is sized at launch and cannot
                # follow.  Keep the old plan running and leave an audit
                # note instead of crashing the training loop from inside
                # observe_round.
                self.plan_slot.history.append(
                    (
                        self.plan_slot.version,
                        f"{label} NOT swapped "
                        f"({plan.n_silos} != {self.plan_slot.plan.n_silos} silos)",
                    )
                )
        if best is not None:
            self.overlay = best  # randomized winners keep the fixed fallback
            self.plan = plan
        self.schedule = best_sched
        self.predicted_tau_ms = predicted
        self._window.clear()
        self._window_sum = 0.0
        self._strikes = 0
        self._rounds_since_swap = 0
        self._last_redesign = self._round
        self._calibrate()
        rho = float(sched_est.rho) if sched_est is not None else float("nan")
        redesign = Redesign(
            round_idx=self._round,
            overlay=best,
            plan=plan,
            predicted_tau_ms=predicted,
            measured_ms=measured,
            n_candidates=scored,
            elapsed_s=elapsed,
            bottleneck=bottleneck,
            expected_window_ms=expected,
            drift=drift,
            schedule=best_sched,
            membership=membership,
            rho=rho,
            objective=self.config.objective,
        )
        self.redesigns.append(redesign)
        obs_metrics.counter("controller.redesigns").inc()
        obs_metrics.histogram("controller.redesign_s").observe(elapsed)
        if elapsed > 0:
            obs_metrics.gauge("controller.candidates_per_s").set(
                scored / elapsed
            )
        obs_metrics.gauge("controller.predicted_tau_ms").set(predicted)
        obs_metrics.histogram("controller.drift").observe(drift)
        if self.recorder is not None:
            self.recorder.emit(
                "redesign",
                round_idx=self._round,
                winner="fixed" if best is not None else "randomized",
                name=name,
                predicted_tau_ms=predicted,
                measured_ms=measured,
                expected_window_ms=expected,
                drift=drift,
                n_candidates=scored,
                elapsed_s=elapsed,
                bottleneck=list(bottleneck),
                bottleneck_names=self._names(bottleneck),
                membership=list(membership) if membership else None,
                # (tau, rho) co-design audit: extra fields, so traces
                # from tau-only runs stay schema-valid (NaN -> None:
                # JSON has no NaN and readers shouldn't need one).
                rho=rho if rho == rho else None,
                objective=self.config.objective,
            )
        return redesign
