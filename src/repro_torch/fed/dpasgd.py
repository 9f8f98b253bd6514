"""DPASGD (Eq. 2) — decentralized periodic averaging SGD, on one card.

Each silo performs ``s`` local mini-batch steps, then mixes its model
with its overlay in-neighbours through the consensus matrix A:

    w_i(k+1) = sum_{j in N_i^+ u {i}} A_ij w_j(k)        (mix rounds)
    w_i(k+1) = w_i(k) - alpha * grad f_i(w_i(k))          (local rounds)

Counterpart of ``repro.fed.dpasgd`` on its static path, and on the
per-round consensus matrix of a randomized schedule (``consensus_arg``).  The state keeps
every silo's parameters and optimizer slot as rows of flat
``[n_silos, P]`` buffers (``[P]`` for one silo); a slot is None
(SGD), one buffer (momentum) or a dict of buffers (Adam's ``{"mu",
"nu"}``).  The reference's
``vmap`` over silos is a loop over the rows: each silo's gradient lands
in one flat ``[P]`` buffer through per-leaf gradient views, and the
update rewrites the silo's rows in place.  The step updates the state's
buffers in place and returns the state; clone them first to keep the
old values.

Under elastic membership (``--dynamic`` churn) :func:`migrate_silo_state`
re-stacks the rows from one active silo set to another on the state's
device, and :func:`slice_silo_row` takes one silo's row out in the tree
shape a checkpoint holds.

With one silo per process (``mesh=``, a
:class:`repro_torch.launch.mesh.SiloMesh`) the state is the rank's own
``[P]`` row and slot: :func:`init_state` draws the silo's row as the
stacked state would, :func:`make_train_step` trains the row and mixes it
over the process group (:func:`repro_torch.fed.gossip.mix_rank`), and
:func:`migrate_rank_state` is :func:`migrate_silo_state` across ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamLayout, init_params_, state_to_tree
from repro_torch.optim import Optimizer
from .gossip import GOSSIP_IMPLS, GossipPlan, gossip_einsum, gossip_einsum_rank, mix, mix_rank


@dataclass(frozen=True)
class DPASGDConfig:
    """Federation knobs of the DPASGD train step: ``local_steps`` is the
    paper's s, ``gossip_impl`` the consensus lowering (see
    :mod:`repro_torch.fed.gossip`), ``accum_steps`` the gradient
    accumulation chunks per local step."""

    local_steps: int = 1            # s
    gossip_impl: str = "ppermute"   # "einsum" | "ppermute" | "pallas" | "none"
    accum_steps: int = 1


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss(params, batch):
        return T.loss_fn(params, cfg, batch)

    return loss


def masked_consensus(A, active_mask) -> torch.Tensor:
    """Renormalize a consensus matrix over the active silos.

    ``A`` is ``[n, n]`` row-stochastic, ``active_mask`` is ``[n]``
    (bool/0-1).  Arcs touching an inactive silo are dropped and each
    surviving row is renormalized to sum to 1, so the weight a silo gave
    its departed in-neighbours is returned to the survivors
    proportionally.  Inactive rows (and active rows whose in-neighbours
    all left) become identity: a departed silo's stale parameters are
    frozen, not pulled toward the survivors.  Torch ops on ``A``'s device
    and dtype."""
    A = torch.as_tensor(A)
    m = (torch.as_tensor(active_mask, device=A.device) > 0).to(A.dtype)
    Am = A * m[None, :] * m[:, None]
    rows = Am.sum(dim=1, keepdim=True)
    keep = rows > 0
    out = Am / torch.where(keep, rows, torch.ones_like(rows))
    return torch.where(keep, out, torch.eye(A.shape[0], dtype=A.dtype, device=A.device))


def _is_silo_stacked(x, n_silos: int) -> bool:
    """One rule for "does this buffer of the state carry the leading silo
    dimension": a ``[n_silos, P]`` buffer (``[P]`` when one silo).  Shared
    by the migration and the leaver-row slicer so they cannot drift apart;
    ``None`` (a stateless optimizer) and the int step counter are shared,
    not stacked."""
    if not isinstance(x, torch.Tensor):
        return False
    return x.ndim == 2 and x.shape[0] == n_silos or (n_silos == 1 and x.ndim == 1)


def map_slots(fn: Callable, entry):
    """``fn`` applied to each buffer of a state entry: the entry itself, or
    each value of a dict of slots (Adam's ``{"mu", "nu"}``)."""
    if isinstance(entry, dict):
        return {k: fn(v) for k, v in entry.items()}
    return fn(entry)


def state_buffers(state: Dict[str, Any]) -> Dict[str, Any]:
    """The state's entries with dict slots flattened: ``{"params": ...,
    "opt_state/mu": ..., "opt_state/nu": ..., "step": ...}``."""
    out = {}
    for key, entry in state.items():
        if isinstance(entry, dict):
            out.update({f"{key}/{k}": v for k, v in entry.items()})
        else:
            out[key] = entry
    return out


def slice_silo_row(state: Dict[str, Any], active: Sequence[int], silo: int,
                   layout: ParamLayout) -> Dict[str, Any]:
    """One silo's row of a silo-stacked train state, in the tree shape a
    checkpoint holds (:func:`repro_torch.checkpoint.save_silo_checkpoint`):
    ``{"params": tree, "opt_state": tree or (), "step": int32}`` of host
    numpy arrays without the silo dimension, ``layout`` giving the leaves
    of a row.  ``active`` is the label tuple the state's rows are stacked
    by."""
    row = tuple(active).index(silo)
    n = len(active)

    def pick(x):
        if not _is_silo_stacked(x, n):
            return x
        return x.view(n, -1)[row]

    return state_to_tree({k: map_slots(pick, v) for k, v in state.items()}, layout)


# Columns per float64 scratch chunk of the joiners' consensus row.
_CONSENSUS_CHUNK = 1 << 24


def consensus_row(x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Uniform mean of rows ``rows`` of a ``[n, P]`` buffer, accumulated in
    float64 in the order of ``rows`` and cast back to the buffer's dtype:
    the same bits as the reference's ``x[rows].mean(axis=0,
    dtype=np.float64).astype(x.dtype)`` (numpy reduces the leading axis
    row by row, starting from the first, then divides by the count).  Runs
    on ``x``'s device with a float64 scratch of at most
    ``_CONSENSUS_CHUNK`` columns."""
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[1], _CONSENSUS_CHUNK):
        hi = min(lo + _CONSENSUS_CHUNK, x.shape[1])
        acc = x[rows[0], lo:hi].double()
        for r in rows[1:]:
            acc += x[r, lo:hi].double()
        out[lo:hi] = acc.div_(len(rows))
    return out


def migrate_silo_state(state: Dict[str, Any], old_active: Sequence[int],
                       new_active: Sequence[int]
                       ) -> Tuple[Dict[str, Any], Tuple[int, ...], Tuple[int, ...]]:
    """Re-stack the silo-stacked train state from one active set to another.

    ``old_active`` / ``new_active`` are the sorted silo-label tuples the
    state's rows are (was / will be) stacked by — row k holds silo
    ``active[k]``.  On the state's device, for ``params`` and every
    buffer of ``opt_state``:

    * **survivors** (labels in both sets) keep their rows *bit-identical*
      — one ``index_select`` gathers them;
    * **leavers'** rows are dropped (checkpoint them first if wanted —
      ``train(..., churn_checkpoint=...)``);
    * **joiners** are initialized at the survivors' consensus average
      (:func:`consensus_row`: float64, cast back to the buffer's dtype).

    The step counter passes through.  Returns ``(new_state, joined,
    left)``; the new buffers are fresh tensors (a one-silo set gives
    ``[P]`` rows, as :func:`init_state` does), and the caller drops the
    old ones."""
    old_active = tuple(old_active)
    new_active = tuple(new_active)
    old_index = {v: k for k, v in enumerate(old_active)}
    survivors = [v for v in new_active if v in old_index]
    if not survivors:
        raise ValueError(
            f"no surviving silos between {old_active} and {new_active}: "
            "cannot migrate state"
        )
    joined = tuple(v for v in new_active if v not in old_index)
    left = tuple(v for v in old_active if v not in set(new_active))
    surv_rows = [old_index[v] for v in survivors]

    def move(x):
        if not _is_silo_stacked(x, len(old_active)):
            return x  # shared entry: the step counter, a stateless optimizer's None
        x2 = x.view(len(old_active), -1)
        # joiners' rows are gathered from the first survivor, then overwritten
        src = [old_index.get(v, surv_rows[0]) for v in new_active]
        out = x2.index_select(0, torch.tensor(src, dtype=torch.long, device=x.device))
        if joined:
            avg = consensus_row(x2, surv_rows)
            for k, v in enumerate(new_active):
                if v not in old_index:
                    out[k] = avg
        return out[0] if len(new_active) == 1 else out

    return {k: map_slots(move, v) for k, v in state.items()}, joined, left


def migrate_rank_state(state: Optional[Dict[str, Any]], mesh, old_active: Sequence[int],
                       new_active: Sequence[int], *, size: int, optimizer: Optimizer,
                       step: int) -> Tuple[Optional[Dict[str, Any]], Tuple[int, ...],
                                           Tuple[int, ...]]:
    """:func:`migrate_silo_state` with one silo per rank of ``mesh``.

    Every rank of the world calls it with the same sets (``state`` is None
    on an idle rank).  A survivor keeps its buffers untouched; a leaver's
    rank returns None (checkpoint its row first) and goes idle; each
    survivor sends its params and every optimizer slot, in chunks of
    ``_CONSENSUS_CHUNK`` columns, to each joiner, which accumulates them in
    float64 in survivor order and then divides (the bits of
    :func:`consensus_row`) into fresh ``[size]`` buffers shaped by
    ``optimizer.init``, at step counter ``step``.  Sets ``mesh.active`` to
    ``new_active``.  Returns ``(state, joined, left)``."""
    old_active, new_active = tuple(old_active), tuple(new_active)
    survivors = [v for v in new_active if v in old_active]
    if not survivors:
        raise ValueError(f"no surviving silos between {old_active} and {new_active}: "
                         "cannot migrate state")
    joined = tuple(v for v in new_active if v not in old_active)
    left = tuple(v for v in old_active if v not in new_active)
    me = mesh.rank
    if me in joined:
        params = torch.empty(size, device=mesh.device)
        state = {"params": params, "opt_state": optimizer.init(params), "step": step}
    if joined and (me in joined or me in survivors):
        scratch = None
        for key, buf in state_buffers(state).items():
            if not isinstance(buf, torch.Tensor):
                continue  # the step counter, a stateless optimizer's None
            for lo in range(0, size, _CONSENSUS_CHUNK):
                hi = min(lo + _CONSENSUS_CHUNK, size)
                if me in survivors:
                    mesh.exchange([(j, buf[lo:hi]) for j in joined], [])
                    continue
                if scratch is None:
                    scratch = torch.empty((len(survivors), min(_CONSENSUS_CHUNK, size)),
                                          dtype=buf.dtype, device=buf.device)
                rows = scratch[:, :hi - lo]
                mesh.exchange([], [(v, rows[k]) for k, v in enumerate(survivors)])
                acc = rows[0].double()
                for k in range(1, len(survivors)):
                    acc += rows[k].double()
                buf[lo:hi] = acc.div_(len(survivors))
    mesh.set_active(new_active)
    return (state if me in new_active else None), joined, left


def local_sgd_steps(
    loss_fn: Callable,
    optimizer: Optimizer,
    params: torch.Tensor,               # flat [P] row, updated in place
    opt_state: Any,                     # None, a flat [P] row or a dict of them, in place
    microbatches: Dict[str, torch.Tensor],  # leading dim s (+ accum dim)
    step: Optional[int] = None,         # optimizer step counter of the first local step
    *,
    layout: ParamLayout,
    accum_steps: int = 1,
    grad: Optional[torch.Tensor] = None,  # flat [P] scratch for the gradient
):
    """Run s local optimizer steps on one silo's rows.

    With ``accum_steps > 1`` each local step's batch carries an extra
    leading accumulation dim ``[s, A, B_micro, ...]``: gradients are
    summed over the A chunks and divided by A before the single update,
    as the reference does.  Local step m updates at optimizer step ``step
    + m`` (the reference's per-step counter); an optimizer that reads the
    step (a schedule, Adam) raises when ``step`` is None.  Returns the
    mean loss over the s steps, on the device."""
    if grad is None:
        grad = torch.empty_like(params)
    grad_views = layout.leaf_views(grad)
    s = microbatches["tokens"].shape[0]
    losses = []
    for m in range(s):
        grad.zero_()
        leaves = [v.detach().requires_grad_() for v in layout.leaf_views(params)]
        for leaf, g in zip(leaves, grad_views):
            leaf.grad = g  # backward accumulates in place into the flat buffer
        tree = layout.unflatten(leaves)
        micro = {k: v[m] for k, v in microbatches.items()}
        if accum_steps > 1:
            loss = 0.0
            for a in range(accum_steps):
                la = loss_fn(tree, {k: v[a] for k, v in micro.items()})
                la.backward()
                loss = loss + la.detach()
            grad.div_(accum_steps)
            loss = loss / accum_steps
        else:
            loss = loss_fn(tree, micro)
            loss.backward()
            loss = loss.detach()
        optimizer.update(grad, opt_state, params, None if step is None else step + m)
        losses.append(loss)
    return torch.stack(losses).mean()


def make_train_step(cfg: ModelConfig, fed: DPASGDConfig, optimizer: Optimizer,
                    plan: Optional[GossipPlan], *, consensus_arg: bool = False,
                    mesh=None) -> Callable:
    """Build the DPASGD train step ``step_fn(state, batch) -> (state,
    {"loss"})``.

    state = ``{"params", "opt_state", "step"}`` from :func:`init_state`
    (or ``models.params.from_jax_params`` of a reference state);
    batch = ``{"tokens", "labels"}`` of shape ``[n_silos?, s, B, S]``.
    The round's mix is one call of the chosen lowering; under ``pallas``
    it writes the mixed parameters back into the state's buffer.

    With ``consensus_arg=True`` the step takes the round's ``[n, n]``
    consensus matrix as an input -- ``step_fn(state, batch, consensus,
    active_mask=None)`` -- and mixes with :func:`gossip_einsum`: the
    lowering for randomized schedules
    (:class:`~repro_torch.fed.gossip.ScheduleSlot`), whose topology
    changes every round.  ``plan`` is ignored then.  ``active_mask``
    (``[n]`` 0/1) renormalizes the matrix over the active silos
    (:func:`masked_consensus`).

    With ``mesh`` (one silo per process; ``cfg.n_silos`` is the count of
    active silos, ``mesh.active``) the state is this rank's ``[P]`` row and
    slot and the batch its ``[s, B, S]`` microbatches: the step trains the
    row with :func:`local_sgd_steps`, gathers the silos' losses in silo
    order and takes their ``torch.stack(...).mean()`` as the stacked step
    does, and mixes the row with :func:`~repro_torch.fed.gossip.mix_rank`
    (a ``consensus_arg`` matrix's row with
    :func:`~repro_torch.fed.gossip.gossip_einsum_rank`).  Every active rank
    calls it each round."""
    if fed.gossip_impl not in GOSSIP_IMPLS:
        raise KeyError(fed.gossip_impl)
    n_silos = cfg.n_silos
    if consensus_arg and fed.gossip_impl not in ("einsum", "none"):
        raise ValueError(
            "consensus_arg=True lowers gossip as an einsum of the given matrix; "
            f"gossip_impl={fed.gossip_impl!r} builds its mix from a fixed plan "
            "and cannot follow a per-round matrix")
    if consensus_arg:
        plan = None
    elif n_silos > 1 and fed.gossip_impl != "none" and plan is None:
        raise ValueError(f"gossip_impl={fed.gossip_impl!r} needs a plan")
    if plan is not None and plan.n_silos != n_silos:
        raise ValueError(f"plan spans {plan.n_silos} silos, config has {n_silos}")
    loss_fn = make_loss_fn(cfg)
    layout = ParamLayout(T.model_specs(cfg))
    if mesh is not None:
        if n_silos != len(mesh.active) or mesh.position is None:
            raise ValueError(f"rank {mesh.rank} trains one of the {len(mesh.active)} active "
                             f"silos {mesh.active}; the config has {n_silos}")

        def rank_step_fn(state, batch, consensus=None, active_mask=None):
            params, opt_state = state["params"], state["opt_state"]
            if params.shape != (layout.size,):
                raise ValueError(f"rank state holds {tuple(params.shape)} params, the "
                                 f"config needs [{layout.size}]")
            loss = local_sgd_steps(loss_fn, optimizer, params, opt_state, batch, state["step"],
                                   layout=layout, accum_steps=fed.accum_steps)
            if n_silos > 1:
                loss = mesh.gather_scalars(loss).to(loss.device).mean()
                with torch.no_grad():
                    if consensus_arg and fed.gossip_impl != "none":
                        if consensus is None:
                            raise ValueError("consensus_arg=True: pass the round's consensus "
                                             "matrix")
                        A = torch.as_tensor(consensus)
                        if active_mask is not None:
                            A = masked_consensus(A, active_mask)
                        params = gossip_einsum_rank(params, A, mesh)
                    else:
                        params = mix_rank(params, plan, fed.gossip_impl, mesh, out=params)
            step = state["step"] + fed.local_steps
            return {"params": params, "opt_state": opt_state, "step": step}, {"loss": loss}

        return rank_step_fn

    def step_fn(state, batch, consensus=None, active_mask=None):
        params, opt_state = state["params"], state["opt_state"]
        if params.shape[-1] != layout.size:
            raise ValueError(f"state holds {params.shape[-1]} params per silo, "
                             f"the config needs {layout.size}")
        if n_silos == 1:
            loss = local_sgd_steps(loss_fn, optimizer, params, opt_state, batch,
                                   state["step"], layout=layout,
                                   accum_steps=fed.accum_steps)
        else:
            grad = torch.empty(layout.size, dtype=params.dtype, device=params.device)
            losses = []
            for i in range(n_silos):
                losses.append(local_sgd_steps(
                    loss_fn, optimizer, params[i],
                    None if opt_state is None else map_slots(lambda x: x[i], opt_state),
                    {k: v[i] for k, v in batch.items()}, state["step"],
                    layout=layout, accum_steps=fed.accum_steps, grad=grad))
            del grad  # one silo's gradient: freed before the mix allocates its stack
            loss = torch.stack(losses).mean()
            # consensus mix (the paper's technique)
            with torch.no_grad():
                if consensus_arg and fed.gossip_impl != "none":
                    if consensus is None:
                        raise ValueError("consensus_arg=True: pass the round's consensus matrix")
                    A = torch.as_tensor(consensus)
                    if active_mask is not None:
                        A = masked_consensus(A, active_mask)
                    params = gossip_einsum(params, A)
                else:
                    params = mix(params, plan, fed.gossip_impl, out=params)
        step = state["step"] + fed.local_steps
        return {"params": params, "opt_state": opt_state, "step": step}, {"loss": loss}

    return step_fn


def init_state(cfg: ModelConfig, optimizer: Optimizer, *, seed: int = 0,
               device: DeviceLike = "cuda", mesh=None) -> Dict[str, Any]:
    """Training state for :func:`make_train_step`: with ``cfg.n_silos > 1``
    the float32 params and each optimizer slot are ``[n_silos, P]`` buffers
    (``optimizer.init`` of the stacked params), one
    independently drawn model per silo (successive draws of one
    ``torch.Generator`` seeded with ``seed``).

    With ``mesh`` the state is the rank's silo's ``[P]`` row, equal to that
    row of the stacked state: rows 0 .. silo are drawn in order into one
    scratch row and the last is kept."""
    dev = resolve_device(device)
    specs = T.model_specs(cfg)
    layout = ParamLayout(specs)
    n = cfg.n_silos
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is not None:
        params = torch.empty(layout.size, device=dev)
        for _ in range(mesh.rank + 1):
            init_params_(params, layout, specs, gen)
        return {"params": params, "opt_state": optimizer.init(params), "step": 0}
    params = torch.empty((n, layout.size) if n > 1 else (layout.size,), device=dev)
    for row in (params if n > 1 else params[None]):
        init_params_(row, layout, specs, gen)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}
