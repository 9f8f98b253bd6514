"""Scenario model: typed network events over a piecewise-constant underlay
(host numpy; a copy of the reference's ``repro/dynamics/events.py`` on the
port's :class:`~repro_torch.core.underlay.Underlay`).

The paper measures the network once and designs the overlay for that
snapshot.  This module is the *scenario* layer of the dynamics subsystem:
a sorted stream of typed events (:class:`LinkDegraded`, :class:`LinkFailed`,
:class:`LinkRestored`, :class:`SiloJoin`, :class:`SiloLeave`,
:class:`ComputeStraggler`) rewrites an :class:`~repro_torch.core.underlay.Underlay`
into a sequence of :class:`NetworkEpoch` segments, each carrying the
re-derived :class:`~repro_torch.core.delays.ConnectivityGraph` (re-routed
shortest paths, degraded available bandwidths, scaled computation times,
shrunken/grown silo set) that holds on ``[t_start, t_end)``.

Every epoch keeps the *full* silo universe of the underlay so that the
per-epoch Eq. 3 delay matrices stack into one ``[E, N, N]`` array (the
shape the batched max-plus engine consumes); a silo that has left (or not
yet joined) is marked inactive — no overlay arcs touch it and its
self-loop computation delay is zeroed, so it contributes no circuit.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.delays import ConnectivityGraph, SiloParams
from ..core.underlay import Underlay, haversine_km

LinkKey = Tuple[int, int]


def _link_key(link: Sequence[int]) -> LinkKey:
    u, v = link
    return (u, v) if u <= v else (v, u)


# ---------------------------------------------------------------------------
# Event types


@dataclass(frozen=True)
class NetworkEvent:
    """Base event; ``t_ms`` is the instant the change takes effect."""

    t_ms: float


@dataclass(frozen=True)
class LinkDegraded(NetworkEvent):
    """Core link keeps operating at ``factor`` of its nominal capacity.

    ``factor=1.0`` *clears* a previous degradation (the link returns to
    full capacity) — the only way to undo one: degradation and failure
    are orthogonal state dimensions, and :class:`LinkRestored` touches
    only the failure."""

    link: LinkKey
    factor: float

    def __post_init__(self):
        if not (0.0 < self.factor <= 1.0):
            raise ValueError(f"degrade factor must be in (0, 1], got {self.factor}")


@dataclass(frozen=True)
class LinkFailed(NetworkEvent):
    """Core link goes down; traffic re-routes over surviving links."""

    link: LinkKey


@dataclass(frozen=True)
class LinkRestored(NetworkEvent):
    """Core link comes back up, undoing a :class:`LinkFailed`.

    Restore-to-degraded semantics: a :class:`LinkDegraded` factor applied
    before (or during) the outage *persists* after the restore — repairing
    a fiber cut does not also fix congestion.  A degrade → fail → restore
    interleaving therefore lands on the degraded capacity, not nominal;
    only ``LinkDegraded(factor=1.0)`` returns the link to full capacity."""

    link: LinkKey


@dataclass(frozen=True)
class SiloLeave(NetworkEvent):
    """Silo departs training (its router keeps forwarding core traffic)."""

    silo: int


@dataclass(frozen=True)
class SiloJoin(NetworkEvent):
    """Silo (re-)joins training and syncs from its overlay neighbours."""

    silo: int


@dataclass(frozen=True)
class ComputeStraggler(NetworkEvent):
    """Silo's computation time is scaled by ``factor`` (1.0 clears it)."""

    silo: int
    factor: float

    def __post_init__(self):
        if self.factor <= 0.0:
            raise ValueError(f"straggler factor must be positive, got {self.factor}")


# ---------------------------------------------------------------------------
# Network state folding


@dataclass(frozen=True)
class NetworkState:
    """Underlay + the cumulative effect of all events applied so far."""

    underlay: Underlay
    comp_time_ms: float
    active: FrozenSet[int]
    failed_links: FrozenSet[LinkKey] = frozenset()
    capacity_factor: Mapping[LinkKey, float] = dataclasses.field(default_factory=dict)
    comp_factor: Mapping[int, float] = dataclasses.field(default_factory=dict)

    def apply(self, ev: NetworkEvent) -> "NetworkState":
        if isinstance(ev, LinkFailed):
            key = _link_key(ev.link)
            self._check_link(key)
            return dataclasses.replace(self, failed_links=self.failed_links | {key})
        if isinstance(ev, LinkRestored):
            key = _link_key(ev.link)
            self._check_link(key)
            # restore-to-degraded: only the failure is undone; a prior
            # LinkDegraded factor survives the outage (see the event's
            # docstring for the decided semantics)
            return dataclasses.replace(self, failed_links=self.failed_links - {key})
        if isinstance(ev, LinkDegraded):
            key = _link_key(ev.link)
            self._check_link(key)
            caps = dict(self.capacity_factor)
            if ev.factor == 1.0:
                caps.pop(key, None)  # factor 1.0 = back to nominal capacity
            else:
                caps[key] = ev.factor
            return dataclasses.replace(self, capacity_factor=caps)
        if isinstance(ev, SiloLeave):
            self._check_silo(ev.silo)
            return dataclasses.replace(self, active=self.active - {ev.silo})
        if isinstance(ev, SiloJoin):
            self._check_silo(ev.silo)
            return dataclasses.replace(self, active=self.active | {ev.silo})
        if isinstance(ev, ComputeStraggler):
            self._check_silo(ev.silo)
            factors = dict(self.comp_factor)
            if ev.factor == 1.0:
                factors.pop(ev.silo, None)
            else:
                factors[ev.silo] = ev.factor
            return dataclasses.replace(self, comp_factor=factors)
        raise TypeError(f"unknown event type {type(ev).__name__}")

    def _check_link(self, key: LinkKey) -> None:
        if key not in {_link_key(e) for e in self.underlay.core_edges}:
            raise ValueError(f"{key} is not a core link of {self.underlay.name}")

    def _check_silo(self, silo: int) -> None:
        if not (0 <= silo < self.underlay.num_silos):
            raise ValueError(f"silo {silo} outside universe of {self.underlay.name}")

    def connectivity(self) -> ConnectivityGraph:
        """Derive the connectivity graph of this state over the *full*
        silo universe (inactive silos carry no pairs and zero computation).

        Re-runs distance-routed Dijkstra on the surviving core links, so a
        failure both re-routes latency and re-prices available bandwidth
        (min surviving-link capacity along the new path)."""
        u = self.underlay
        n = u.num_silos
        alive = tuple(
            e for e in u.core_edges if _link_key(e) not in self.failed_links
        )
        routed = dataclasses.replace(u, core_edges=alive)
        cap: Dict[LinkKey, float] = {
            key: u.core_capacity_gbps * factor
            for key, factor in self.capacity_factor.items()
        }
        # One pricing implementation: re-route + re-price through the
        # underlay itself; partitioned pairs simply vanish from G_c.
        latency, avail = routed.pair_metrics(
            core_capacity_gbps=cap if cap else None,
            silos=sorted(self.active),
            skip_unreachable=True,
        )
        params: Dict[int, SiloParams] = {}
        for v in range(n):
            if v in self.active:
                ct = self.comp_time_ms * self.comp_factor.get(v, 1.0)
            else:
                ct = 0.0  # no self-loop circuit for inactive silos
            params[v] = SiloParams(
                comp_time_ms=ct,
                uplink_gbps=u.access_capacity_gbps,
                downlink_gbps=u.access_capacity_gbps,
            )
        return ConnectivityGraph(
            silos=tuple(range(n)),
            latency_ms=latency,
            available_bw_gbps=avail,
            silo_params=params,
        )


# ---------------------------------------------------------------------------
# Scenario = initial state + event stream -> piecewise-constant epochs


@dataclass(frozen=True)
class NetworkEpoch:
    """One constant segment of the time-varying network."""

    t_start_ms: float
    t_end_ms: float  # +inf for the final epoch
    gc: ConnectivityGraph  # full silo universe; inactive silos isolated
    active: Tuple[int, ...]

    @property
    def duration_ms(self) -> float:
        return self.t_end_ms - self.t_start_ms


@dataclass(frozen=True)
class Scenario:
    """A named, reproducible time-varying network."""

    name: str
    underlay: Underlay
    comp_time_ms: float
    events: Tuple[NetworkEvent, ...]
    horizon_ms: float
    initially_inactive: Tuple[int, ...] = ()

    @property
    def num_silos(self) -> int:
        return self.underlay.num_silos

    def initial_state(self) -> NetworkState:
        active = frozenset(range(self.num_silos)) - set(self.initially_inactive)
        return NetworkState(
            underlay=self.underlay, comp_time_ms=self.comp_time_ms, active=active
        )

    def segments(self) -> List[NetworkEpoch]:
        """Fold the event stream into piecewise-constant epochs.

        Events at the same instant merge into one boundary; events at
        ``t <= 0`` fold into the initial epoch."""
        state = self.initial_state()
        pending = sorted(self.events, key=lambda ev: ev.t_ms)
        k = 0
        while k < len(pending) and pending[k].t_ms <= 0.0:
            state = state.apply(pending[k])
            k += 1
        epochs: List[NetworkEpoch] = []
        t_start = 0.0
        for t_ms, group in itertools.groupby(pending[k:], key=lambda ev: ev.t_ms):
            epochs.append(
                NetworkEpoch(
                    t_start_ms=t_start,
                    t_end_ms=t_ms,
                    gc=state.connectivity(),
                    active=tuple(sorted(state.active)),
                )
            )
            for ev in group:
                state = state.apply(ev)
            t_start = t_ms
        epochs.append(
            NetworkEpoch(
                t_start_ms=t_start,
                t_end_ms=math.inf,
                gc=state.connectivity(),
                active=tuple(sorted(state.active)),
            )
        )
        return epochs


def active_subgraph(gc: ConnectivityGraph, active: Sequence[int]) -> ConnectivityGraph:
    """Restrict a full-universe epoch graph to its active silos — the view
    the topology designers (and the online controller) operate on."""
    keep = set(active)
    return ConnectivityGraph(
        silos=tuple(sorted(keep)),
        latency_ms={e: v for e, v in gc.latency_ms.items() if set(e) <= keep},
        available_bw_gbps={
            e: v for e, v in gc.available_bw_gbps.items() if set(e) <= keep
        },
        silo_params={v: p for v, p in gc.silo_params.items() if v in keep},
    )


# ---------------------------------------------------------------------------
# Seeded scenario generators


def static_scenario(
    underlay: Underlay, comp_time_ms: float, horizon_ms: float = 60_000.0
) -> Scenario:
    """No events: the degenerate scenario that must reproduce the static
    dense recursion exactly (tested)."""
    return Scenario(
        name=f"{underlay.name}-static",
        underlay=underlay,
        comp_time_ms=comp_time_ms,
        events=(),
        horizon_ms=horizon_ms,
    )


def link_failure_scenario(
    underlay: Underlay,
    comp_time_ms: float,
    *,
    t_fail_ms: float,
    link: Optional[LinkKey] = None,
    overlay_edges: Optional[Sequence[Tuple[int, int]]] = None,
    horizon_ms: float = 60_000.0,
) -> Scenario:
    """Fail one core link mid-training.

    With ``link=None`` the busiest link is chosen: the core link carrying
    the most routed overlay arcs (or, without an overlay, the most
    shortest paths) — the failure an SDN monitor would flag first."""
    if link is None:
        link = busiest_core_link(underlay, overlay_edges)
    return Scenario(
        name=f"{underlay.name}-linkfail",
        underlay=underlay,
        comp_time_ms=comp_time_ms,
        events=(LinkFailed(t_ms=t_fail_ms, link=_link_key(link)),),
        horizon_ms=horizon_ms,
    )


def busiest_core_link(
    underlay: Underlay,
    overlay_edges: Optional[Sequence[Tuple[int, int]]] = None,
) -> LinkKey:
    """Core link traversed by the most routed silo pairs (ties broken by
    link length, longest first — the transcontinental hop, not the short
    local one)."""
    sp = underlay.shortest_paths()
    load: Dict[LinkKey, int] = {_link_key(e): 0 for e in underlay.core_edges}
    if overlay_edges is None:
        n = underlay.num_silos
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    else:
        pairs = [tuple(e) for e in overlay_edges if e[0] != e[1]]
    for (i, j) in pairs:
        _, pred = sp[i]
        path = underlay.path_nodes(pred, i, j)
        for hop in zip(path[:-1], path[1:]):
            load[_link_key(hop)] += 1
    def length(key: LinkKey) -> float:
        return haversine_km(underlay.coords[key[0]], underlay.coords[key[1]])
    return max(load, key=lambda k: (load[k], length(k)))


def silo_degrade_scenario(
    underlay: Underlay,
    comp_time_ms: float,
    *,
    silo: int,
    t_ms: float,
    factor: float = 0.02,
    horizon_ms: float = 60_000.0,
) -> Scenario:
    """Severely degrade every core link incident to one silo.

    Every path to ``silo`` ends on one of its (all degraded) incident
    links, so no re-routing escapes the ``M / (factor · C)`` transfer —
    the drift that stresses *schedules* hardest: a fixed overlay absorbs
    the slow silo into its critical circuit (amortized over the circuit
    length by max-plus pipelining), while a randomized plan stalls both
    endpoints of every sampled matching that touches it.  The online
    controller must react either way: re-design the overlay around the
    slow region, or — with ``ControllerConfig.schedule_family="matcha"``
    — re-fit the plan distribution (budget re-swept on the degraded
    estimate) and hot-swap it through the :class:`ScheduleSlot`.
    """
    if not (0 <= silo < underlay.num_silos):
        raise ValueError(f"silo {silo} outside universe of {underlay.name}")
    events = tuple(
        LinkDegraded(t_ms=t_ms, link=_link_key(e), factor=factor)
        for e in underlay.core_edges
        if silo in e
    )
    if not events:
        raise ValueError(f"silo {silo} has no core links in {underlay.name}")
    return Scenario(
        name=f"{underlay.name}-silodegrade",
        underlay=underlay,
        comp_time_ms=comp_time_ms,
        events=events,
        horizon_ms=horizon_ms,
    )


def churn_scenario(
    underlay: Underlay,
    comp_time_ms: float,
    *,
    silo: int,
    t_leave_ms: float,
    t_rejoin_ms: float,
    horizon_ms: float = 60_000.0,
) -> Scenario:
    """One silo leaves training and later rejoins — the minimal elastic-
    membership scenario: the training loop must rebuild its mesh/state on
    the :class:`SiloLeave` and again on the paired :class:`SiloJoin`."""
    if not (0 <= silo < underlay.num_silos):
        raise ValueError(f"silo {silo} outside universe of {underlay.name}")
    if not (0.0 < t_leave_ms < t_rejoin_ms):
        raise ValueError(
            f"need 0 < t_leave_ms < t_rejoin_ms, got {t_leave_ms}, {t_rejoin_ms}"
        )
    return Scenario(
        name=f"{underlay.name}-churn",
        underlay=underlay,
        comp_time_ms=comp_time_ms,
        events=(
            SiloLeave(t_ms=t_leave_ms, silo=silo),
            SiloJoin(t_ms=t_rejoin_ms, silo=silo),
        ),
        horizon_ms=horizon_ms,
    )


def random_scenario(
    underlay: Underlay,
    comp_time_ms: float,
    *,
    seed: int,
    horizon_ms: float = 60_000.0,
    n_events: int = 6,
    p_degrade: float = 0.35,
    p_fail: float = 0.25,
    p_straggler: float = 0.25,
    p_churn: float = 0.15,
    min_degrade: float = 0.02,
    min_active: int = 3,
) -> Scenario:
    """Seeded random event stream over ``(0, horizon_ms)``.

    Event mix: capacity degradations, link failures (each later restored
    with probability 1/2), compute stragglers, and silo leave/rejoin
    churn.  The same (underlay, seed) always yields the same scenario.

    Churn keeps at least ``max(1, min_active)`` silos active at every
    instant: each :class:`SiloLeave` schedules its paired
    :class:`SiloJoin` inside the horizon, the candidate pool tracks those
    rejoin times (a silo whose rejoin has fired may be picked to leave
    again — the pool does not shrink monotonically), and a leave that
    would cross the floor is converted into a straggler instead."""
    rng = np.random.default_rng(seed)
    probs = np.array([p_degrade, p_fail, p_straggler, p_churn])
    probs = probs / probs.sum()
    links = [_link_key(e) for e in underlay.core_edges]
    events: List[NetworkEvent] = []
    away: Dict[int, float] = {}  # silo -> scheduled rejoin time
    floor = max(1, min(min_active, underlay.num_silos))
    times = np.sort(rng.uniform(0.05 * horizon_ms, 0.95 * horizon_ms, n_events))
    for t in times:
        for v in [v for v, t_back in away.items() if t_back <= t]:
            del away[v]  # rejoin fired: back in the candidate pool
        kind = int(rng.choice(4, p=probs))
        if kind == 3 and underlay.num_silos - len(away) <= floor:
            kind = 2  # at the active floor: churn becomes a straggler
        if kind == 0:
            link = links[int(rng.integers(len(links)))]
            factor = float(rng.uniform(min_degrade, 0.5))
            events.append(LinkDegraded(t_ms=float(t), link=link, factor=factor))
        elif kind == 1:
            link = links[int(rng.integers(len(links)))]
            events.append(LinkFailed(t_ms=float(t), link=link))
            if rng.random() < 0.5:
                t_back = float(rng.uniform(t, horizon_ms))
                events.append(LinkRestored(t_ms=t_back, link=link))
        elif kind == 2:
            silo = int(rng.integers(underlay.num_silos))
            factor = float(rng.uniform(2.0, 10.0))
            events.append(ComputeStraggler(t_ms=float(t), silo=silo, factor=factor))
        else:
            candidates = [v for v in range(underlay.num_silos) if v not in away]
            silo = candidates[int(rng.integers(len(candidates)))]
            t_back = float(rng.uniform(t, horizon_ms))
            away[silo] = t_back
            events.append(SiloLeave(t_ms=float(t), silo=silo))
            events.append(SiloJoin(t_ms=t_back, silo=silo))
    return Scenario(
        name=f"{underlay.name}-random-{seed}",
        underlay=underlay,
        comp_time_ms=comp_time_ms,
        events=tuple(sorted(events, key=lambda ev: ev.t_ms)),
        horizon_ms=horizon_ms,
    )
