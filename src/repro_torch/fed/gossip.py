"""Gossip (consensus) step of DPASGD on one card.

The silos are the leading dimension of the training state, so the
consensus matrix A (doubly stochastic, support = overlay edges) acts on
that dimension.  Four lowerings, with the reference's names:

* ``einsum``   — ``w <- einsum('ij,j...->i...', A, w)``: the dense mix,
                 reference semantics.
* ``ppermute`` — Birkhoff decomposition of A into permutations; each
                 permutation is one ``index_select`` along the silo
                 dimension (``perm[i]`` is the source of destination i),
                 the counterpart of one ``jax.lax.ppermute``; the terms
                 are summed in float32.
* ``pallas``   — the same transfers, with the K-way weighted combine in
                 the hand-written ``gossip_mix`` kernel.  Every silo
                 shares each term's coefficient, so a round is ONE kernel
                 launch over ``[K, n_silos * P]``.  The name is kept from
                 the reference (whose kernel is Pallas) so the CLI flags
                 match; here it selects the CUDA kernel.
* ``none``     — no mixing.

Randomized schedules (MATCHA) sample a fresh topology every round: a
:class:`ScheduleSlot` turns the shared round counter into that round's
plan, and the train step takes its matrix as an input and mixes it with
the ``einsum`` lowering, as the reference does (no ``gossip_mix`` launch).

Elastic membership (silo churn under ``--dynamic``): a
:class:`MembershipSlot` publishes the active silo set, and on a move the
training loop re-stacks the ``[n, P]`` state over the new set
(:func:`repro_torch.fed.dpasgd.migrate_silo_state`) and rebuilds its step.

One silo per process (:mod:`repro_torch.launch.mesh`): each rank holds
one silo's ``[P]`` row, and the same four lowerings run over
``torch.distributed`` (:func:`mix_rank`), the counterparts of the
reference's ``gossip_shard_map`` and ``_pallas_mix_tree``:

* ``ppermute`` — the rank receives its in-neighbours' rows with one
  ``batch_isend_irecv`` (one transfer per distinct source, however many
  terms name it) and sums ``coeff * row`` over the plan's terms in
  float32, in term order: row r of :func:`gossip_permute`, bit for bit;
* ``pallas``   — the received rows fill a ``[K, P]`` stack and ONE
  ``gossip_mix`` launch combines them: row r of :func:`gossip_fused`, bit
  for bit (the kernel is elementwise);
* ``einsum``   — an all-gather of the rows, then row r of A times them
  (XLA's lowering of the reference's sharded einsum);
* ``none``     — no mixing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.birkhoff import birkhoff_decomposition
from repro_torch.core.consensus import local_degree_matrix
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as obs_metrics

GOSSIP_IMPLS = ("einsum", "ppermute", "pallas", "none")


@dataclass(frozen=True)
class GossipPlan:
    """Compiled consensus schedule: one overlay's mixing as transfers.

    Attributes
    ----------
    matrix:
        ``[n, n]`` doubly-stochastic consensus matrix A (support = the
        overlay's arcs + self loops).
    terms:
        The Birkhoff decomposition of A as ``(coeff, perm)`` pairs, where
        ``perm[i]`` is the silo that destination i *receives from*; each
        non-identity term is one transfer.
    n_silos:
        n, the silo count.
    """

    matrix: np.ndarray                                # [n, n] doubly stochastic
    terms: Tuple[Tuple[float, Tuple[int, ...]], ...]  # (coeff, recv-from perm)
    n_silos: int

    @staticmethod
    def from_matrix(A: np.ndarray) -> "GossipPlan":
        """Decompose a doubly-stochastic ``[n, n]`` matrix into a plan."""
        terms = birkhoff_decomposition(np.asarray(A, np.float64))
        packed = tuple((float(c), tuple(int(x) for x in p)) for c, p in terms)
        return GossipPlan(matrix=np.asarray(A), terms=packed, n_silos=A.shape[0])

    @property
    def num_transfers(self) -> int:
        """Non-identity permutations = point-to-point transfers per round."""
        ident = tuple(range(self.n_silos))
        return sum(1 for (_, p) in self.terms if p != ident)


class PlanSlot:
    """Hot-swap hook for the active gossip plan.

    The training loop builds its step from ``slot.plan`` and rebuilds it
    whenever ``slot.version`` moves; a controller calls :meth:`swap`
    between rounds.  ``on_swap`` callbacks fire synchronously inside
    :meth:`swap`; ``history`` keeps the (version, label) audit trail.
    Every swap moves the ``slot.{kind}_swaps`` counter and the
    ``slot.{kind}_version`` gauge of :mod:`repro_torch.obs.metrics`.
    """

    _slot_kind = "plan"  # metric namespace; subclasses override

    def __init__(self, plan: GossipPlan):
        self._plan = plan
        self.version = 0
        self.history: List[Tuple[int, str]] = [(0, "init")]
        self._callbacks: List[Any] = []

    @property
    def plan(self) -> GossipPlan:
        return self._plan

    def on_swap(self, callback) -> Any:
        """Register ``callback(plan, version)``; returns it (decorator use)."""
        self._callbacks.append(callback)
        return callback

    def swap(self, plan: GossipPlan, label: str = "", *,
             allow_resize: bool = False) -> int:
        """Install ``plan`` and bump ``version``.  A plan over a different
        silo count is rejected unless ``allow_resize=True``."""
        if not allow_resize and plan.n_silos != self._plan.n_silos:
            raise ValueError(
                f"plan spans {plan.n_silos} silos, slot holds {self._plan.n_silos}"
            )
        self._plan = plan
        self.version += 1
        self.history.append((self.version, label))
        obs_metrics.counter(f"slot.{self._slot_kind}_swaps").inc()
        obs_metrics.gauge(f"slot.{self._slot_kind}_version").set(self.version)
        for cb in self._callbacks:
            cb(plan, self.version)
        return self.version


class ScheduleSlot(PlanSlot):
    """Hot-swap slot for *schedule*-valued state (randomized plans).

    Extends :class:`PlanSlot` from one fixed :class:`GossipPlan` to a
    :class:`repro_torch.core.schedule.Schedule`: every communication round
    the active schedule samples that round's overlay
    (``schedule.round_edges(k)``) and the slot materializes it as a
    consensus matrix / :class:`GossipPlan`.  Because ``round_edges`` is a
    pure function of (schedule state, round counter), **every silo
    holding an equal slot derives the identical plan for round k from the
    shared round counter alone** — no cross-silo coordination, the
    property MATCHA deployments rely on (Appendix G.3).

    Plans are cached per sampled edge set, bounded FIFO at
    ``max_cached_plans`` (a MATCHA schedule over few matchings revisits a
    small subset family; over many matchings almost every round is fresh
    and an unbounded cache would grow for the process lifetime), and
    ``version`` moves only on :meth:`swap_schedule` — per-round sampling
    is expected churn, not a topology change.  For a deterministic
    :class:`~repro_torch.core.schedule.FixedSchedule` the slot degenerates
    to a :class:`PlanSlot` whose plan never varies.
    """

    _slot_kind = "schedule"

    def __init__(self, schedule, n_silos: int, silos: Optional[Sequence] = None,
                 max_cached_plans: int = 512):
        self._n = int(n_silos)
        self._silos = tuple(silos) if silos is not None else None
        self._schedule = schedule
        self._plan_cache: dict = {}
        self._max_cached = int(max_cached_plans)
        super().__init__(self.plan_for_round(0))

    @property
    def schedule(self):
        return self._schedule

    @property
    def silos(self) -> Optional[Tuple]:
        """The label -> position order (None: labels are positions)."""
        return self._silos

    def swap_schedule(self, schedule, label: str = "",
                      silos: Optional[Sequence] = None) -> int:
        """Install a new schedule (fixed or randomized); bumps ``version``
        and fires the ``on_swap`` callbacks with the round-0 plan.

        ``silos`` re-pins the label -> silo-position order — pass it when
        the active universe changed (the new schedule spans different
        silos than the old one); the round-0 plan is then allowed to
        change silo count, and the caller must rebuild the state to match.
        A swap that raises (a callback included) leaves the slot as it
        was."""
        resized = silos is not None
        rollback = (self._schedule, self._silos, self._n, self._plan_cache,
                    self._plan, self.version, list(self.history))
        if resized:
            self._silos = tuple(silos)
            self._n = len(self._silos)
        self._schedule = schedule
        self._plan_cache = {}
        try:
            return self.swap(self.plan_for_round(0), label=label,
                             allow_resize=resized)
        except Exception:
            # failed swaps leave the slot untouched (PlanSlot invariant) —
            # including the base-class plan/version/history, which a
            # raising on_swap callback would otherwise leave half-moved
            (self._schedule, self._silos, self._n, self._plan_cache,
             self._plan, self.version, history) = rollback
            self.history[:] = history
            raise

    def _index(self, label) -> int:
        if self._silos is not None:
            return self._silos.index(label)
        return int(label)

    def plan_for_round(self, round_idx: int) -> GossipPlan:
        """The (deterministic) gossip plan of communication round
        ``round_idx`` under the active schedule."""
        edges = self._schedule.round_edges(round_idx)
        idx_edges = tuple(
            sorted(
                (self._index(i), self._index(j)) for (i, j) in edges if i != j
            )
        )
        plan = self._plan_cache.get(idx_edges)
        if plan is None:
            A = local_degree_matrix(self._n, list(idx_edges))
            plan = GossipPlan.from_matrix(A)
            if len(self._plan_cache) >= self._max_cached:  # FIFO bound
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[idx_edges] = plan
        return plan

    def matrix_for_round(self, round_idx: int) -> np.ndarray:
        """Consensus matrix of round ``round_idx`` — the array fed to a
        ``consensus_arg`` train step (no rebuild between rounds)."""
        return self.plan_for_round(round_idx).matrix


class MembershipSlot:
    """Versioned active-silo set — the elastic-membership sibling of
    :class:`PlanSlot` / :class:`ScheduleSlot`.

    The silo *universe* (labels ``0..n_universe-1``, the underlay's full
    silo set) is fixed at launch; the *active* subset changes on
    ``SiloJoin`` / ``SiloLeave`` churn.  The silo-stacked train state is
    sized to ``active``, so unlike a plan swap a membership swap cannot be
    absorbed by rebuilding the step alone: the training loop watches
    ``version`` and on a move migrates the state (survivors keep their
    rows bit-identical, joiners enter at the survivors' consensus average
    — :func:`repro_torch.fed.dpasgd.migrate_silo_state`) and rebuilds the
    train step over the new silo count.  The online controller calls
    :meth:`swap` when its membership signal drifts, *before* resizing the
    plan/schedule slots, so consumers always observe membership first.

    ``swap`` with an unchanged active set is a no-op (version does not
    move); ``history`` keeps the (version, label) audit trail and
    ``on_swap`` callbacks fire synchronously with ``(active, version)``.
    A swap moves the ``slot.membership_swaps`` counter and the
    ``slot.membership_version`` / ``slot.membership_active`` gauges.
    """

    def __init__(self, active: Sequence[int], n_universe: int):
        self._universe = int(n_universe)
        self._active = self._validate(active)
        self.version = 0
        self.history: List[Tuple[int, str]] = [(0, "init")]
        self._callbacks: List[Any] = []

    def _validate(self, active: Sequence[int]) -> Tuple[int, ...]:
        act = tuple(sorted(int(v) for v in active))
        if not act:
            raise ValueError("membership cannot be empty: >= 1 active silo")
        if len(set(act)) != len(act):
            raise ValueError(f"duplicate silos in membership {act}")
        if act[0] < 0 or act[-1] >= self._universe:
            raise ValueError(
                f"membership {act} outside universe 0..{self._universe - 1}"
            )
        return act

    @property
    def active(self) -> Tuple[int, ...]:
        """Sorted active silo labels; index k is row k of the state."""
        return self._active

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_universe(self) -> int:
        return self._universe

    def on_swap(self, callback) -> Any:
        """Register ``callback(active, version)``; returns it."""
        self._callbacks.append(callback)
        return callback

    def swap(self, active: Sequence[int], label: str = "") -> int:
        """Install a new active set; returns the (possibly unmoved)
        version.  No-op when the set is unchanged."""
        act = self._validate(active)
        if act == self._active:
            return self.version
        self._active = act
        self.version += 1
        self.history.append((self.version, label))
        obs_metrics.counter("slot.membership_swaps").inc()
        obs_metrics.gauge("slot.membership_version").set(self.version)
        obs_metrics.gauge("slot.membership_active").set(len(act))
        for cb in self._callbacks:
            cb(act, self.version)
        return self.version


def gossip_einsum(w: torch.Tensor, A) -> torch.Tensor:
    """Reference gossip: ``einsum('ij,j...->i...', A, w)`` over the leading
    silo dimension of ``w`` (size n); ``A`` is the ``[n, n]`` consensus
    matrix."""
    a = torch.as_tensor(np.asarray(A)).to(dtype=w.dtype, device=w.device)
    return torch.einsum("ij,j...->i...", a, w)


def _perm_index(perm: Sequence[int], device) -> torch.Tensor:
    return torch.tensor(perm, dtype=torch.long, device=device)


def gossip_permute(w: torch.Tensor, plan: GossipPlan) -> torch.Tensor:
    """The Birkhoff schedule, one ``index_select`` along the silo
    dimension per non-identity term, terms summed in float32 and cast
    back (counterpart of the reference's ``ppermute`` mix)."""
    ident = tuple(range(plan.n_silos))
    acc = None
    for coeff, perm in plan.terms:
        recv = w if perm == ident else w.index_select(0, _perm_index(perm, w.device))
        contrib = coeff * recv.to(torch.float32)
        acc = contrib if acc is None else acc + contrib
    return acc.to(w.dtype)


def gossip_fused(w: torch.Tensor, plan: GossipPlan, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Birkhoff transfers gathered into one ``[K, n * M]`` stack and
    combined by ONE ``gossip_mix`` call.

    ``w`` is silo-stacked and contiguous (the training state's flat
    ``[n, P]`` buffer: no concatenation, unlike the reference's per-leaf
    flatten).  ``out`` may be ``w`` itself: the stack holds copies, so the
    mix can be written back in place."""
    ident = tuple(range(plan.n_silos))
    flat = w.view(plan.n_silos, -1)
    K = len(plan.terms)
    stack = torch.empty((K,) + tuple(flat.shape), dtype=w.dtype, device=w.device)
    for k, (_, perm) in enumerate(plan.terms):
        if perm == ident:
            stack[k].copy_(flat)
        else:
            torch.index_select(flat, 0, _perm_index(perm, w.device), out=stack[k])
    weights = torch.tensor([c for c, _ in plan.terms], dtype=torch.float32)
    dst = None if out is None else out.view(-1)
    return kops.gossip_mix(stack.view(K, -1), weights, out=dst).view(w.shape)


def mix(w: torch.Tensor, plan: Optional[GossipPlan], impl: str, *,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one gossip round with lowering ``impl`` (see module doc);
    ``out`` is used by the ``pallas`` lowering only."""
    if impl == "none":
        return w
    if impl == "einsum":
        return gossip_einsum(w, plan.matrix)
    if impl == "ppermute":
        return gossip_permute(w, plan)
    if impl == "pallas":
        return gossip_fused(w, plan, out=out)
    raise KeyError(impl)


def in_neighbours(plan: GossipPlan, pos: int) -> Tuple[int, ...]:
    """The distinct positions whose rows position ``pos`` receives (itself
    left out): one transfer each under ``ppermute`` and ``pallas``."""
    return tuple(sorted({perm[pos] for _, perm in plan.terms} - {pos}))


def out_neighbours(plan: GossipPlan, pos: int) -> Tuple[int, ...]:
    """The distinct positions that receive position ``pos``'s row."""
    return tuple(sorted({d for _, perm in plan.terms for d, s in enumerate(perm)
                         if s == pos and d != pos}))


def _transfer_rows(row: torch.Tensor, plan: GossipPlan, mesh, into) -> dict:
    """Send this rank's flat row to its out-neighbours and receive each
    in-neighbour's row once, into ``into(source position)``; returns
    ``{source position: received row}``."""
    pos = mesh.position
    recv = {s: into(s) for s in in_neighbours(plan, pos)}
    mesh.exchange([(mesh.active[d], row) for d in out_neighbours(plan, pos)],
                  [(mesh.active[s], t) for s, t in recv.items()])
    return recv


def gossip_permute_rank(row: torch.Tensor, plan: GossipPlan, mesh) -> torch.Tensor:
    """This rank's row of :func:`gossip_permute`: the in-neighbours' rows
    received over ``mesh``, ``coeff * row`` summed in float32 in term
    order and cast back."""
    flat = row.reshape(-1)
    pos = mesh.position
    recv = _transfer_rows(flat, plan, mesh, lambda s: torch.empty_like(flat))
    acc = None
    for coeff, perm in plan.terms:
        src = flat if perm[pos] == pos else recv[perm[pos]]
        contrib = coeff * src.to(torch.float32)
        acc = contrib if acc is None else acc + contrib
    return acc.to(row.dtype).view(row.shape)


def gossip_fused_rank(row: torch.Tensor, plan: GossipPlan, mesh, *,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's row of :func:`gossip_fused`: a ``[K, P]`` stack whose row
    k is term k's source (received over ``mesh`` straight into the first
    row that names it), combined by ONE ``gossip_mix`` call.  ``out`` may
    be ``row`` itself: the transfers finish before the mix."""
    flat = row.reshape(-1)
    pos = mesh.position
    srcs = [perm[pos] for _, perm in plan.terms]
    stack = torch.empty((len(srcs), flat.numel()), dtype=row.dtype, device=row.device)
    first = {s: k for k, s in reversed(list(enumerate(srcs)))}
    recv = _transfer_rows(flat, plan, mesh, lambda s: stack[first[s]])
    for k, s in enumerate(srcs):
        if s == pos:
            stack[k].copy_(flat)
        elif first[s] != k:
            stack[k].copy_(recv[s])
    weights = torch.tensor([c for c, _ in plan.terms], dtype=torch.float32)
    dst = None if out is None else out.view(-1)
    return kops.gossip_mix(stack, weights, out=dst).view(row.shape)


def gossip_einsum_rank(row: torch.Tensor, A, mesh) -> torch.Tensor:
    """This rank's row of :func:`gossip_einsum`: the active rows gathered
    over ``mesh``, then row r of A times them."""
    a = torch.as_tensor(np.asarray(A))[mesh.position].to(dtype=row.dtype, device=row.device)
    rows = mesh.all_gather_rows(row)
    return torch.einsum("j,jp->p", a, rows).view(row.shape)


def mix_rank(row: torch.Tensor, plan: Optional[GossipPlan], impl: str, mesh, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One gossip round of this rank's row over ``mesh`` with lowering
    ``impl`` (see module doc); ``out`` is used by ``pallas`` only.  Entered
    by every active rank."""
    if impl == "none":
        return row
    if plan.n_silos != len(mesh.active):
        raise ValueError(f"plan spans {plan.n_silos} silos, {len(mesh.active)} are active")
    if impl == "einsum":
        return gossip_einsum_rank(row, plan.matrix, mesh)
    if impl == "ppermute":
        return gossip_permute_rank(row, plan, mesh)
    if impl == "pallas":
        return gossip_fused_rank(row, plan, mesh, out=out)
    raise KeyError(impl)


def recv_bytes_per_round(plan: Optional[GossipPlan], impl: str, pos: int,
                         param_bytes: int) -> int:
    """Bytes position ``pos`` receives in one round of :func:`mix_rank`."""
    if impl == "none" or plan is None:
        return 0
    if impl == "einsum":
        return (plan.n_silos - 1) * param_bytes
    return len(in_neighbours(plan, pos)) * param_bytes


def collective_bytes_per_round(plan: GossipPlan, param_bytes: int) -> int:
    """Predicted gossip traffic per communication round per silo."""
    return plan.num_transfers * param_bytes
