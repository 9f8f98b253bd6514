"""Federated runtime: DPASGD training over gossip plans, on one card or
with one silo per process.

* :class:`~repro_torch.fed.gossip.GossipPlan` / :class:`~repro_torch.fed.gossip.PlanSlot`
  — a consensus matrix decomposed into Birkhoff transfers, and its
  versioned hot-swap hook;
* :class:`~repro_torch.fed.gossip.ScheduleSlot` — the schedule-valued
  slot for randomized plans: one plan per round from a shared round
  counter;
* :class:`~repro_torch.fed.gossip.MembershipSlot` — the versioned active
  silo set under churn;
* :func:`~repro_torch.fed.gossip.gossip_einsum`,
  :func:`~repro_torch.fed.gossip.gossip_permute`,
  :func:`~repro_torch.fed.gossip.gossip_fused`,
  :func:`~repro_torch.fed.gossip.collective_bytes_per_round` — the
  lowerings and their traffic model;
* :class:`~repro_torch.fed.dpasgd.DPASGDConfig`,
  :func:`~repro_torch.fed.dpasgd.make_train_step`,
  :func:`~repro_torch.fed.dpasgd.init_state`,
  :func:`~repro_torch.fed.dpasgd.local_sgd_steps`,
  :func:`~repro_torch.fed.dpasgd.masked_consensus` — the Eq. 2 train step;
* :func:`~repro_torch.fed.dpasgd.migrate_silo_state`,
  :func:`~repro_torch.fed.dpasgd.slice_silo_row` — re-stacking the state
  over a new active set, and one silo's row as a checkpoint tree;
* :func:`~repro_torch.fed.gossip.mix_rank`,
  :func:`~repro_torch.fed.dpasgd.migrate_rank_state` — one silo per
  process (:mod:`repro_torch.launch.mesh`): a rank's row mixed over
  ``torch.distributed``, and the migration across ranks;
* :func:`~repro_torch.fed.topology_runtime.plan_from_overlay` (a designed
  overlay) and :func:`~repro_torch.fed.topology_runtime.plan_for_n_silos`.
"""

from .dpasgd import (
    DPASGDConfig,
    init_state,
    local_sgd_steps,
    make_train_step,
    masked_consensus,
    migrate_rank_state,
    migrate_silo_state,
    slice_silo_row,
)
from .gossip import (
    GossipPlan,
    MembershipSlot,
    PlanSlot,
    ScheduleSlot,
    collective_bytes_per_round,
    gossip_einsum,
    gossip_fused,
    gossip_permute,
    mix_rank,
)
from .topology_runtime import plan_for_n_silos, plan_from_overlay

__all__ = [
    "DPASGDConfig",
    "init_state",
    "local_sgd_steps",
    "make_train_step",
    "masked_consensus",
    "migrate_rank_state",
    "migrate_silo_state",
    "slice_silo_row",
    "GossipPlan",
    "MembershipSlot",
    "PlanSlot",
    "ScheduleSlot",
    "collective_bytes_per_round",
    "gossip_einsum",
    "gossip_fused",
    "gossip_permute",
    "mix_rank",
    "plan_for_n_silos",
    "plan_from_overlay",
]
