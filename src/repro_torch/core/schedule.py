"""Schedules: deterministic overlays and randomized plan distributions
behind one pricing API (Sect. 4 / Appendix G.3) -- a copy of the
reference's ``repro/core/schedule.py`` whose pricing runs the round-varying
Eq. 4 recursion on a torch device.

The paper prices a *fixed* overlay by its max cycle mean and MATCHA — a
*distribution* over per-round topologies — by simulation (footnote 6).
This module makes both first-class :class:`Schedule` objects:

* :class:`FixedSchedule`     — a designed :class:`~repro_torch.core.topologies.Overlay`;
  every round uses the same edges, pricing is the exact Karp cycle time.
* :class:`MatchaSchedule`    — MATCHA(+)'s budget-parameterized matching
  activation [104]: each round independently activates every matching
  w.p. ``budget`` (resampling empty rounds, Appendix G.3).  Pricing is
  Monte-Carlo τ̄ with a confidence interval, fully batched: activation
  masks ``[R, M]`` over the matchings, Eq. 3 arc pricing of the distinct
  activation rows on the host via
  :func:`~repro_torch.core.maxplus_sparse.batched_overlay_delay_edges`
  (degrees — and access-link sharing — recomputed per row), and the
  round-varying edge-list timing recursion
  :func:`~repro_torch.core.maxplus_sparse.timing_recursion_unique_rounds_sparse_torch`
  on ``device`` in float64 — on the card ONE launch of the hand-written
  K1 recursion for a whole budgets × seeds sweep.  Seeded chains
  reproduce the legacy scalar oracle
  :meth:`repro_torch.core.matcha.Matcha.average_cycle_time` (the masks
  consume the same ``random.Random`` stream and the weights/recursion are
  the same f64 operations), and card and CPU give the same bits.

The shared API:

* :meth:`Schedule.price`           — :class:`ScheduleEstimate` (τ̄, CI) on a
  connectivity graph, the number every designer compares;
* :meth:`Schedule.round_edges`     — the directed overlay of round ``k``,
  a pure function of (schedule, k): every silo sampling from a shared
  round counter materializes the same topology with no coordination
  (the contract :class:`repro_torch.fed.gossip.ScheduleSlot` builds on);
* :meth:`Schedule.simulate_rounds` — realized round durations.

Every pricing entry takes ``device`` (default ``"cuda"``; like every
entry point of the port it raises without a GPU unless the caller passes
``"cpu"``).

A cycle-time caveat: the unified pricing API compares *round rate* only.
On that metric RING tends to dominate MATCHA — the paper's headline
result, which the max-plus steady state explains: a fixed overlay
pipelines, so even a slow link is amortized over the whole critical
circuit, while random per-round re-coupling propagates every stall.
Randomized schedules are chosen for what τ̄ cannot see — mixing per unit
of traffic under a communication budget — so callers pin the family (and
the budget menu) deliberately.
"""

from __future__ import annotations

import abc
import math
import random
from dataclasses import dataclass, replace
from typing import Hashable, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..analysis.contracts import contract
from ..obs.spans import span_fn
from .delays import ConnectivityGraph, TrainingParams
from .matcha import Matcha, greedy_edge_coloring
from .maxplus_sparse import (
    batched_overlay_delay_edges,
    timing_recursion_unique_rounds_sparse_torch,
)
from .topologies import Overlay, evaluate_overlay

Node = Hashable
Edge = Tuple[Node, Node]

DEFAULT_MATCHA_BUDGETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0)


class ScheduleInfeasibleError(ValueError):
    """No randomized schedule exists on this connectivity estimate —
    the graph routes no symmetric pairs (or every matching pair has
    vanished), so there is nothing to sample.  Callers that treat a
    schedule as one *candidate* (the online controller's re-design pool)
    catch exactly this and fall back to fixed overlays; any other error
    from the pricing engine propagates."""


@dataclass(frozen=True)
class ScheduleEstimate:
    """Priced (cycle time, mixing rate) of a schedule on one estimate.

    ``tau_ms`` is the mean over Monte-Carlo replicates, ``ci95_ms`` the
    95% normal-approximation half-width over seeds (0.0 when the
    schedule is deterministic or a single seed was used), ``per_seed_ms``
    the raw per-replicate averages.  ``rho`` is the per-round consensus
    contraction factor (second-largest singular value of the deployed
    matrix for fixed schedules, ``sqrt(λ_max(E[WᵀW] − J/n))`` for
    randomized ones — see :mod:`repro_torch.core.mixing`); NaN means mixing
    was not priced (τ-only callers never pay the spectral cost).
    """

    tau_ms: float
    ci95_ms: float
    per_seed_ms: Tuple[float, ...]
    rho: float = float("nan")

    @property
    def time_to_eps_score(self) -> float:
        """``τ / −log(ρ)`` — ms per e-fold of consensus-error decay
        (:func:`repro_torch.core.mixing.wall_clock_to_eps`); NaN when ρ is
        unpriced, +inf when ρ ≥ 1 (no contraction)."""
        from .mixing import wall_clock_to_eps

        return wall_clock_to_eps(self.tau_ms, self.rho)


class Schedule(abc.ABC):
    """A (possibly randomized) per-round communication topology."""

    name: str

    @property
    @abc.abstractmethod
    def is_randomized(self) -> bool:
        """Does :meth:`round_edges` vary with the round counter?"""

    @abc.abstractmethod
    def round_edges(self, round_idx: int) -> Tuple[Edge, ...]:
        """Directed overlay edges of round ``round_idx``.

        Must be a pure function of the schedule's frozen state and the
        round counter — silos sharing the counter sample identical
        topologies without any cross-silo coordination.
        """

    @abc.abstractmethod
    def price(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        *,
        rounds: int = 300,
        seeds: Sequence[int] = (0,),
        device: DeviceLike = "cuda",
    ) -> ScheduleEstimate:
        """Average cycle time (Eq. 3 / Eq. 4) on the given measurements;
        the Eq. 4 recursion runs on ``device``."""

    @abc.abstractmethod
    def simulate_rounds(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        num_rounds: int,
        *,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> np.ndarray:
        """``[num_rounds]`` simulated round durations (the controller's
        expected-profile input)."""

    def simulate_rounds_batch(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        num_rounds: int,
        seeds: Sequence[int] = (0,),
        device: DeviceLike = "cuda",
    ) -> np.ndarray:
        """``[len(seeds), num_rounds]`` duration profiles.  Randomized
        schedules override this to price every seed chain in one engine
        call; the base implementation loops."""
        return np.stack(
            [
                self.simulate_rounds(gc, tp, num_rounds, seed=s, device=device)
                for s in seeds
            ]
        )


# ---------------------------------------------------------------------------
# Fixed schedules


@dataclass(frozen=True)
class FixedSchedule(Schedule):
    """A deterministic overlay as a degenerate schedule: every round uses
    the same edges and pricing is the exact (f64 Karp) cycle time."""

    overlay: Overlay

    @property
    def name(self) -> str:  # type: ignore[override]
        return self.overlay.name

    @property
    def is_randomized(self) -> bool:
        return False

    def round_edges(self, round_idx: int) -> Tuple[Edge, ...]:
        return self.overlay.edges

    def price(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        *,
        rounds: int = 300,
        seeds: Sequence[int] = (0,),
        device: DeviceLike = "cuda",
    ) -> ScheduleEstimate:
        resolve_device(device)  # the exact f64 Karp price runs on the host
        tau = evaluate_overlay(gc, tp, self.overlay.edges, self.overlay.name).cycle_time_ms
        return ScheduleEstimate(tau_ms=tau, ci95_ms=0.0, per_seed_ms=(tau,))

    def simulate_rounds(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        num_rounds: int,
        *,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> np.ndarray:
        arcs = [e for e in self.overlay.edges if e[0] != e[1]]
        if not arcs:
            # Degenerate overlay (e.g. a one-silo estimate after churn):
            # only the computation self-loops tick, every round costs the
            # slowest silo's local steps — the comp-only profile the old
            # dense calibration produced, not an error.
            comp = max(
                tp.local_steps * gc.silo_params[v].comp_time_ms
                for v in gc.silos
            )
            return np.full(num_rounds, comp, dtype=np.float64)
        masks = np.ones((1, num_rounds, len(arcs)), dtype=bool)
        times = _priced_recursion(gc, tp, arcs, masks, resolve_device(device))
        return np.diff(times[0].max(axis=1))


# ---------------------------------------------------------------------------
# MATCHA as a schedule


@dataclass(frozen=True)
class MatchaSchedule(Schedule):
    """MATCHA(+)'s randomized plan distribution as a first-class schedule.

    ``matchings`` is the edge-coloring decomposition of the base graph
    (unordered silo pairs; communication is bidirectional), ``budget``
    the per-round activation probability C_b, validated to (0, 1] —
    ``budget <= 0`` would make the Appendix G.3 resample-until-nonempty
    loop spin forever.  ``sample_seed`` fixes the *deployment* sampling
    stream consumed by :meth:`round_edges` (counter-based, so round k is
    addressable without generating rounds 0..k-1); pricing uses its own
    per-seed ``random.Random`` streams to stay bit-compatible with the
    legacy scalar oracle.
    """

    matchings: Tuple[Tuple[Edge, ...], ...]
    budget: float
    name: str = "matcha"
    sample_seed: int = 0

    def __post_init__(self):
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(
                f"MATCHA budget C_b must be in (0, 1], got {self.budget!r} "
                "(budget <= 0 never activates a matching and the "
                "resample-until-nonempty rule of Appendix G.3 would loop "
                "forever)"
            )
        if not self.matchings or all(len(m) == 0 for m in self.matchings):
            raise ValueError("MatchaSchedule needs at least one nonempty matching")

    @property
    def num_matchings(self) -> int:
        return len(self.matchings)

    @property
    def is_randomized(self) -> bool:
        return True

    @property
    def pairs(self) -> Tuple[Edge, ...]:
        """All unordered base-graph pairs, concatenated across matchings."""
        return tuple(p for m in self.matchings for p in m)

    # -- sampling -----------------------------------------------------------

    def round_active(self, round_idx: int) -> Tuple[int, ...]:
        """Indices of the matchings active in round ``round_idx``.

        Counter-based: a fresh ``Philox``-backed generator is derived from
        ``(sample_seed, round_idx)``, so the draw is a pure, platform-
        stable function of the pair — the cross-silo determinism contract.
        Resamples until at least one matching is active (Appendix G.3).
        """
        rng = np.random.default_rng(
            np.random.SeedSequence((int(self.sample_seed), int(round_idx)))
        )
        while True:
            active = np.flatnonzero(rng.random(self.num_matchings) < self.budget)
            if active.size:
                return tuple(int(a) for a in active)

    def round_edges(self, round_idx: int) -> Tuple[Edge, ...]:
        out: List[Edge] = []
        for m in self.round_active(round_idx):
            for (i, j) in self.matchings[m]:
                out.append((i, j))
                out.append((j, i))
        return tuple(out)

    def activation_masks(self, rounds: int, seed: int) -> np.ndarray:
        """``[R, M]`` boolean activation masks for one pricing chain.

        Consumes the exact ``random.Random(seed)`` stream of the legacy
        :meth:`repro_torch.core.matcha.Matcha.sample_round` loop (one uniform
        per matching per attempt, rounds resampled until nonempty), which
        is what makes the vectorized τ̄ reproduce the scalar oracle
        bit-for-bit on equal seeds.  Because every attempt consumes
        exactly M draws and a round accepts its *first* nonempty attempt,
        the accepted rows are simply the nonempty attempt rows in stream
        order — so attempts are drawn in bulk and filtered vectorized
        (draws past the last accepted round are discarded, which legacy
        never sees: the generator is private to this call).
        """
        rng = random.Random(seed)
        M = self.num_matchings
        out = np.empty((rounds, M), dtype=bool)
        got = 0
        p_accept = 1.0 - (1.0 - self.budget) ** M
        rnd = rng.random
        while got < rounds:
            need = rounds - got
            n_att = min(int(need / p_accept * 1.2) + 4, 65536)
            draws = np.array(
                [rnd() for _ in range(n_att * M)], dtype=np.float64
            ).reshape(n_att, M)
            rows = draws < self.budget
            acc = rows[rows.any(axis=1)]
            take = min(len(acc), need)
            out[got : got + take] = acc[:take]
            got += take
        return out

    # -- pricing ------------------------------------------------------------

    def _arc_pool(self, gc: ConnectivityGraph) -> Tuple[List[Edge], np.ndarray]:
        """(directed arc pool, [E] matching index per arc), filtered to
        pairs the graph still routes (dynamics: silos leave, links
        partition — a vanished pair simply drops out of the pool)."""
        arcs: List[Edge] = []
        mids: List[int] = []
        present = set(gc.silos)
        for m, matching in enumerate(self.matchings):
            for (i, j) in matching:
                if (
                    i in present
                    and j in present
                    and gc.has_edge(i, j)
                    and gc.has_edge(j, i)
                ):
                    arcs.extend([(i, j), (j, i)])
                    mids.extend([m, m])
        return arcs, np.asarray(mids, dtype=np.int64)

    def price(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        *,
        rounds: int = 300,
        seeds: Sequence[int] = (0,),
        device: DeviceLike = "cuda",
    ) -> ScheduleEstimate:
        taus = average_cycle_times_batched(
            (self,), gc, tp, rounds=rounds, seeds=seeds, device=device
        )[0]
        return _estimate_from_chains(taus)

    def simulate_rounds(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        num_rounds: int,
        *,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> np.ndarray:
        return self.simulate_rounds_batch(gc, tp, num_rounds, (seed,), device=device)[0]

    def simulate_rounds_batch(
        self,
        gc: ConnectivityGraph,
        tp: TrainingParams,
        num_rounds: int,
        seeds: Sequence[int] = (0,),
        device: DeviceLike = "cuda",
    ) -> np.ndarray:
        arcs, mids = self._arc_pool(gc)
        masks = np.stack(
            [self.activation_masks(num_rounds, s)[:, mids] for s in seeds]
        )
        times = _priced_recursion(gc, tp, arcs, masks, resolve_device(device))
        return np.diff(times.max(axis=2), axis=1)


def _estimate_from_chains(taus: np.ndarray) -> ScheduleEstimate:
    taus = np.asarray(taus, dtype=np.float64)
    mean = float(taus.mean())
    if taus.size < 2:
        return ScheduleEstimate(mean, 0.0, tuple(float(t) for t in taus))
    half = 1.96 * float(taus.std(ddof=1)) / math.sqrt(taus.size)
    return ScheduleEstimate(mean, half, tuple(float(t) for t in taus))


def _priced_recursion(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    arcs: Sequence[Edge],
    masks: np.ndarray,
    device: torch.device,
) -> np.ndarray:
    """``[C, R+1, N]`` start times of ``[C, R, E]`` per-round arc masks:
    Eq. 3 pricing (per-round degrees, host) + round-varying Eq. 4
    recursion (on ``device``).

    Identical mask rows get identical Eq. 3 weights (degrees are a pure
    function of the row), so only the *distinct* rows are priced and the
    per-round weight stack is a gather — at small budgets most rounds
    repeat a handful of activation subsets.
    """
    C, R, E = masks.shape
    if E == 0:
        raise ScheduleInfeasibleError("schedule has no usable arcs on this graph")
    flat = masks.reshape(C * R, E)
    first, inv = _unique_rows(flat)
    return _recursion_from_unique(gc, tp, arcs, flat[first], inv, C, R, device)


def _unique_rows(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(first-occurrence indices, inverse) of the rows of a boolean
    ``[B, K]`` matrix.  Rows are identified by their packed bits — for
    K <= 64 that is one ``uint64`` key per row, an order of magnitude
    cheaper than ``np.unique(..., axis=0)`` row sorting."""
    packed = np.ascontiguousarray(np.packbits(flat, axis=1))
    nb = packed.shape[1]
    if nb <= 8:
        keyb = np.zeros((flat.shape[0], 8), dtype=np.uint8)
        keyb[:, :nb] = packed
        key = keyb.view(np.uint64).ravel()
    else:
        key = packed.view([("", packed.dtype)] * nb).ravel()
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    return first, inv


def _recursion_inputs(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    arcs: Sequence[Edge],
    uniq_masks: np.ndarray,
    inv: np.ndarray,
    C: int,
    R: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Eq. 3 prices of the [U, E] distinct rows (host): the unique-rounds
    recursion's ``(src, dst, w_unique, round_ids)``, arcs sorted by dst as
    the reference sorts them for its host reduceats (the full [C, R, E]
    weight stack is never materialized)."""
    eb = batched_overlay_delay_edges(gc, tp, list(arcs), uniq_masks)
    order = np.argsort(eb.dst[0], kind="stable")
    return (
        np.ascontiguousarray(eb.src[0][order], dtype=np.int32),
        np.ascontiguousarray(eb.dst[0][order], dtype=np.int32),
        np.ascontiguousarray(eb.w[:, order], dtype=np.float64),
        inv.reshape(C, R).astype(np.int32),
    )


def _recursion_from_unique(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    arcs: Sequence[Edge],
    uniq_masks: np.ndarray,
    inv: np.ndarray,
    C: int,
    R: int,
    device: torch.device,
) -> np.ndarray:
    """Price the [U, E] distinct rows on the host and run the unique-rounds
    recursion on ``device`` in float64 (on the card, one launch)."""
    src, dst, w, ids = _recursion_inputs(gc, tp, arcs, uniq_masks, inv, C, R)
    times = timing_recursion_unique_rounds_sparse_torch(
        *(torch.from_numpy(a).to(device) for a in (src, dst, w, ids)), gc.num_silos)
    return times.cpu().numpy()


def _sweep_inputs(
    schedules: Sequence[MatchaSchedule],
    gc: ConnectivityGraph,
    tp: TrainingParams,
    rounds: int,
    seeds: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """What :func:`average_cycle_times_batched` hands the recursion for a
    budgets × seeds sweep: ``(src, dst, w_unique, round_ids)``, chain
    ``c = schedule * len(seeds) + seed``."""
    base = schedules[0].matchings
    if any(s.matchings != base for s in schedules):
        raise ValueError("batched pricing requires a shared matching pool")
    arcs, mids = schedules[0]._arc_pool(gc)
    if not arcs:
        raise ScheduleInfeasibleError("schedule has no usable arcs on this graph")
    C = len(schedules) * len(seeds)
    act = np.empty((C, rounds, schedules[0].num_matchings), dtype=bool)
    c = 0
    for s in schedules:
        for seed in seeds:
            act[c] = s.activation_masks(rounds, seed)
            c += 1
    # Dedup at the matching level (M bits per round, one uint64 key) and
    # only expand the distinct activation subsets to arc masks — at small
    # budgets most rounds repeat a handful of subsets.
    flat = act.reshape(C * rounds, -1)
    first, inv = _unique_rows(flat)
    return _recursion_inputs(gc, tp, arcs, flat[first][:, mids], inv, C, rounds)


@span_fn("engine.schedule_cycle_times")
@contract("#S", ret="[S,K]", seeds="#K")
def average_cycle_times_batched(
    schedules: Sequence[MatchaSchedule],
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    rounds: int = 300,
    seeds: Sequence[int] = (0,),
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """``[len(schedules), len(seeds)]`` seeded τ̄ chains in one engine call.

    All schedules must share the same matchings (they typically differ
    only in budget — the budget-sweep case); each (schedule, seed) chain
    reproduces ``Matcha(matchings, budget).average_cycle_time(gc, tp,
    rounds=rounds, seed=seed)``.  The masks and the Eq. 3 pricing of the
    distinct rows are host work; the recursion over every chain runs on
    ``device`` in float64 (one launch on the card).
    """
    dev = resolve_device(device)
    if not schedules:
        return np.zeros((0, len(seeds)), dtype=np.float64)
    src, dst, w, ids = _sweep_inputs(schedules, gc, tp, rounds, seeds)
    times = timing_recursion_unique_rounds_sparse_torch(
        *(torch.from_numpy(a).to(dev) for a in (src, dst, w, ids)), gc.num_silos)
    # the last start times only: [C, N] comes back to the host
    taus = times[:, rounds].max(dim=1).values.cpu().numpy() / rounds
    return taus.reshape(len(schedules), len(seeds))


# ---------------------------------------------------------------------------
# Constructors / designer


@contract()
def matcha_schedule_from_connectivity(
    gc: ConnectivityGraph, budget: float = 0.5, *, sample_seed: int = 0
) -> MatchaSchedule:
    """MATCHA over the symmetric pairs of a connectivity graph (the
    schedule twin of :func:`repro_torch.core.matcha.matcha_from_connectivity`)."""
    pairs: List[Edge] = []
    seen = set()
    for (i, j) in gc.latency_ms:
        k = frozenset((i, j))
        if i != j and k not in seen and gc.has_edge(j, i):
            seen.add(k)
            pairs.append((i, j))
    return MatchaSchedule(
        matchings=tuple(tuple(m) for m in greedy_edge_coloring(pairs)),
        budget=budget,
        sample_seed=sample_seed,
    )


@contract()
def matcha_schedule_from_underlay(
    underlay, budget: float = 0.5, *, sample_seed: int = 0
) -> MatchaSchedule:
    """MATCHA+: matchings computed on the underlay core graph."""
    return MatchaSchedule(
        matchings=tuple(
            tuple(m) for m in greedy_edge_coloring(list(underlay.core_edges))
        ),
        budget=budget,
        name="matcha+",
        sample_seed=sample_seed,
    )


@contract()
def schedule_from_matcha(m: Matcha, *, sample_seed: int = 0) -> MatchaSchedule:
    """Lift a legacy :class:`~repro_torch.core.matcha.Matcha` sampler."""
    return MatchaSchedule(
        matchings=tuple(tuple(mm) for mm in m.matchings),
        budget=m.budget,
        sample_seed=sample_seed,
    )


@contract()
def design_matcha_schedule(
    gc: ConnectivityGraph,
    tp: TrainingParams,
    *,
    budgets: Sequence[float] = DEFAULT_MATCHA_BUDGETS,
    rounds: int = 150,
    seeds: Sequence[int] = (0, 1, 2),
    sample_seed: int = 0,
    objective: str = "tau",
    mixing_rounds: int = 128,
    device: DeviceLike = "cuda",
) -> Tuple[MatchaSchedule, ScheduleEstimate]:
    """Budget sweep: one batched engine call across budgets × seeds.

    Prices a :class:`MatchaSchedule` at every budget (``len(budgets) *
    len(seeds)`` Monte-Carlo chains in a single
    :func:`average_cycle_times_batched` evaluation) and returns the
    budget minimizing ``objective`` plus its estimate.  Under the
    default ``"tau"`` that is the smallest mean τ̄ — typically the
    smallest budget, since fewer active matchings per round means
    faster rounds *and less mixing*.  ``objective="time_to_eps"``
    additionally prices every budget's expected contraction ρ over
    ``mixing_rounds`` sampled activation rows
    (:func:`repro_torch.core.mixing.schedule_rho`, host numpy) and
    minimizes the composite ``τ̄ / −log(ρ)``, resolving the
    throughput/mixing tension the τ-only sweep punts to the caller; the
    returned estimate then carries the winning ρ.  The chains' recursion
    runs on ``device``: on the card, one launch for the whole sweep.
    """
    dev = resolve_device(device)
    try:
        matchings = matcha_schedule_from_connectivity(gc).matchings
    except ValueError as e:  # no symmetric pairs to color
        raise ScheduleInfeasibleError(str(e)) from e
    cands = [
        MatchaSchedule(matchings=matchings, budget=b, sample_seed=sample_seed)
        for b in budgets
    ]
    taus = average_cycle_times_batched(cands, gc, tp, rounds=rounds, seeds=seeds,
                                       device=dev)
    mean_taus = taus.mean(axis=1)
    if objective == "tau":
        best = int(np.argmin(mean_taus))
        return cands[best], _estimate_from_chains(taus[best])
    # time_to_eps (score_estimate validates the name): lazy import —
    # mixing imports this module at top level, so the cycle breaks here.
    from .mixing import schedule_rho, score_estimate

    rhos = [
        schedule_rho(c, gc, rounds=mixing_rounds, seed=sample_seed)
        for c in cands
    ]
    ests = [
        replace(_estimate_from_chains(taus[k]), rho=rhos[k])
        for k in range(len(cands))
    ]
    best = int(np.argmin([score_estimate(e, objective) for e in ests]))
    return cands[best], ests[best]
