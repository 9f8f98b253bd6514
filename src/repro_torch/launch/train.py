"""Training launcher: DPASGD over a designed topology, on one card or
with one silo per process.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --topology ring --gossip-impl pallas --steps 30

Counterpart of ``repro.launch.train``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` with ``--reduced`` runs
the small variant on the CPU).  ``--arch`` takes any config of
:mod:`repro_torch.configs` but the vision-prefix and the encoder-decoder
ones: the dense transformers, the MoE models (qwen3-moe-30b-a3b;
deepseek-v2-lite-16b with MLA; their loss carries the router's
load-balance term, as the reference's does), xlstm-350m and hymba-1.5b.
internvl2-76b and whisper-large-v3 are refused up front: the token stream
supplies no patch embeddings and no frames, and the reference's
``forward`` asserts on them.
``main`` parses the flags and calls :func:`train`, which scripts can
call at a depth the CLI has no flag for.

``--designer matcha`` trains on a randomized schedule: homogeneous MATCHA
over the complete silo graph (``--matcha-budget`` is its activation
probability C_b, ``--scenario-seed`` its sampling seed); a
:class:`~repro_torch.fed.gossip.ScheduleSlot` samples each round's plan
from the round counter and the step mixes that round's consensus matrix
with the ``einsum`` lowering:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --designer matcha --steps 30

``--dynamic`` attaches the online topology controller: the WAN between
the silos is simulated from a real underlay (``--underlay``; the silo
count follows it) through a seeded event scenario (``--scenario``), each
round advances the simulated network clock by one communication round,
and when the controller detects a throughput regression it re-designs
the overlay and hot-swaps the gossip plan; the loop rebuilds its train
step on the new plan.  Membership is elastic: on ``SiloLeave`` /
``SiloJoin`` churn (``--scenario churn``, or ``--scenario random`` with
``--p-churn > 0``) the controller swaps a ``MembershipSlot`` and the loop
re-stacks the ``[n, P]`` state over the new active set on the card —
survivors keep their rows bit-identical, leavers' rows are dropped
(``--churn-checkpoint`` saves them first), joiners enter at the
survivors' float64 consensus average — and rebuilds the step:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --dynamic --underlay gaia --scenario churn --gossip-impl pallas --steps 25

``--trace-out t.jsonl`` writes a flight-recorder trace
(:mod:`repro_torch.obs`) in the reference's schema: the run's metadata,
the timeline's ``epoch`` records, the controller's ``regression``,
``membership``, ``swap`` and ``redesign`` records, a ``round`` record
every ``--metrics-interval`` rounds and a ``run_end`` summary with the
metrics and span totals; ``scripts/obs_report.py`` renders, checks and
diffs it:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --dynamic --scenario linkfail --trace-out t.jsonl --metrics-interval 5
    python scripts/obs_report.py --check t.jsonl

One silo per process: under ``torchrun`` (``WORLD_SIZE`` set; ``--silos``,
or the underlay's silo count under ``--dynamic``, equal to the world
size) each rank trains its silo's row on ``cuda:LOCAL_RANK`` and gossips
over ``torch.distributed`` (:mod:`repro_torch.launch.mesh`;
``--dist-backend`` ``nccl``, the default on CUDA, or ``gloo``, the default
on the CPU, which stages a card's buffers through pinned host memory).
Rank 0 prints the run's lines, keeps the simulated timeline, the
controller and the trace, and broadcasts the round's active mask, each
plan or schedule swap and each membership move:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --topology ring --gossip-impl pallas --steps 30

The step is eager, so a plan swap costs one :func:`make_train_step` call
and nothing is re-traced.  The trace's ``recompiles`` (and the
``train.recompiles`` gauge) count the train-step builds instead: the
first :func:`make_train_step` and one for each rebuild on a plan or
membership swap — the eager counterpart of the reference's
``TraceCounter`` count.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import FederatedBatcher, SyntheticLMStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.core import MatchaSchedule, greedy_edge_coloring
from repro_torch.fed import (DPASGDConfig, ScheduleSlot, init_state, make_train_step,
                             plan_for_n_silos)
from repro_torch.fed.gossip import GOSSIP_IMPLS, GossipPlan, recv_bytes_per_round
from repro_torch.models import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import spans as obs_spans
from repro_torch.obs.events import FlightRecorder, run_metadata
from repro_torch.optim import Optimizer, momentum

TOPOLOGIES = ("ring", "star", "chain", "none", "mst", "ring_2opt", "delta_mbst")
DESIGNERS = ("auto", "sparse-rewire", "delta-rewire", "hierarchical", "matcha")
SCENARIOS = ("linkfail", "silodegrade", "random", "static", "churn")
MEASURED_DESIGNERS = ("sparse-rewire", "delta-rewire", "hierarchical")


@dataclass
class TrainResult:
    cfg: ModelConfig                # with n_silos set (the last active count under --dynamic)
    fed: DPASGDConfig
    optimizer: Optimizer
    plan: Optional[GossipPlan]
    batcher: FederatedBatcher
    state: Dict[str, Any]           # final state (flat [n_silos, P] buffers)
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    schedule_slot: Optional[ScheduleSlot] = None  # --designer matcha
    consensus: List[np.ndarray] = field(default_factory=list)  # each round's matrix, matcha
    # --dynamic: the controller, the membership slot, the final active
    # silos, and per round {"K": the plan's transfers, "n": silos trained,
    # "peak_bytes": on the card}
    controller: Any = None
    membership_slot: Any = None
    active: tuple = ()
    rounds: List[Dict[str, Any]] = field(default_factory=list)
    # one silo per process: this rank (its state is its own [P] row and
    # slot, {} while idle); each round's record adds "active", the rows its
    # plan sends it ("rows_in"), the bytes it received ("recv_bytes") and
    # staged through host memory ("staged_bytes"), the seconds of those
    # copies ("staging_s") and the round's wall ("wall_s")
    rank: Optional[int] = None


def batch_to_device(raw: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long) for k, v in raw.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _verify_migration(old_state, new_state, old_active, new_active, joined):
    """(survivors bit-identical, joiners at the float64 consensus) of a
    migration, checked on the state's device for the params and every
    optimizer slot."""
    from repro_torch.fed.dpasgd import _is_silo_stacked, consensus_row, state_buffers

    oi = {v: k for k, v in enumerate(old_active)}
    ni = {v: k for k, v in enumerate(new_active)}
    survivors = [v for v in new_active if v in oi]
    srows = [oi[v] for v in survivors]
    ok_surv = ok_join = True
    new_bufs = state_buffers(new_state)
    for key, old in state_buffers(old_state).items():
        if not _is_silo_stacked(old, len(old_active)):
            continue
        o = old.view(len(old_active), -1)
        w = new_bufs[key].view(len(new_active), -1)
        ok_surv &= all(torch.equal(o[oi[v]], w[ni[v]]) for v in survivors)
        if joined:
            avg = consensus_row(o, srows)
            ok_join &= all(torch.equal(avg, w[ni[v]]) for v in joined)
    return ok_surv, ok_join


def _process_mesh(mesh, device: DeviceLike, backend: Optional[str], log):
    """The :class:`~repro_torch.launch.mesh.SiloMesh` to train over: the
    given one, the initialised default group's when it spans more than one
    rank, a new one under ``torchrun`` (``WORLD_SIZE`` > 1), else None."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_silo_mesh, silo_mesh

    if mesh is not None:
        if backend is not None and backend != mesh.backend:
            raise ValueError(f"backend {backend!r} asked, the mesh runs {mesh.backend!r}")
        return mesh
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return silo_mesh(device, backend, log=log)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_silo_mesh(backend=backend, device=device, log=log)
    return None


def _scenario(kind: str, underlay, Tc: float, tau0: float, steps: int, overlay_edges,
              scenario_seed: int, p_churn: float):
    """The reference launcher's scenarios, timed against the horizon of
    ``steps`` rounds at the predicted cycle time."""
    from repro_torch.dynamics import (churn_scenario, link_failure_scenario,
                                      random_scenario, silo_degrade_scenario,
                                      static_scenario)

    horizon = tau0 * max(steps, 1)
    if kind == "linkfail":
        return link_failure_scenario(underlay, Tc, t_fail_ms=horizon / 3,
                                     overlay_edges=overlay_edges, horizon_ms=horizon)
    if kind == "silodegrade":
        return silo_degrade_scenario(underlay, Tc, silo=underlay.load_centrality_center(),
                                     t_ms=horizon / 3, horizon_ms=horizon)
    if kind == "random":
        return random_scenario(underlay, Tc, seed=scenario_seed, horizon_ms=horizon,
                               p_churn=p_churn)
    if kind == "churn":
        return churn_scenario(underlay, Tc, silo=underlay.num_silos // 2,
                              t_leave_ms=horizon / 4, t_rejoin_ms=horizon / 2,
                              horizon_ms=horizon)
    return static_scenario(underlay, Tc, horizon_ms=horizon)


def train(cfg: ModelConfig, *, silos: int = 4, topology: str = "ring",
          gossip_impl: str = "ppermute", local_steps: int = 2,
          batch_per_silo: int = 4, seq_len: int = 64, steps: int = 30,
          lr: float = 0.05, seed: int = 0, device: DeviceLike = "cuda",
          designer: str = "auto", matcha_budget: float = 0.5, scenario_seed: int = 0,
          dynamic: bool = False, underlay: str = "gaia", workload: str = "inaturalist",
          scenario: str = "linkfail", p_churn: float = 0.15, objective: str = "tau",
          checkpoint: str = "", churn_checkpoint: str = "", verify_migration: bool = False,
          on_migration: Optional[Callable[[Dict[str, Any]], None]] = None,
          trace_out: Optional[str] = "", metrics_interval: int = 10,
          backend: Optional[str] = None, mesh=None,
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` with DPASGD for ``steps`` rounds and print the
    reference's ``step k loss ...`` lines.  Each round's time is taken
    on the host clock around the round, ending when its loss reaches the
    host (which waits for every kernel the round queued, the mix
    included).

    ``designer="matcha"`` trains on a randomized schedule whose round
    matrices come from a :class:`ScheduleSlot` and are mixed with the
    ``einsum`` lowering, whatever ``gossip_impl`` asks for (apart from
    ``"none"``): without ``dynamic``, homogeneous MATCHA over the complete
    silo graph (activation probability ``matcha_budget``, sampling seed
    ``scenario_seed``).  The measurement-based designers need ``dynamic``
    and are ignored without it, as in the reference.

    ``dynamic=True`` runs the reference's ``--dynamic`` loop on
    ``underlay`` (``silos`` is then its silo count) under ``scenario``:
    each round first steps the simulated WAN, then trains on the active
    silos' batches, then feeds the round's simulated duration to the
    online controller (on ``device``), which may hot-swap the plan (the
    step is rebuilt) or the membership (the state is re-stacked with
    :func:`~repro_torch.fed.dpasgd.migrate_silo_state` and the step
    rebuilt over the new silo count).  ``churn_checkpoint`` is a directory
    for the leavers' rows; ``verify_migration`` checks each migration on
    the card and prints the result; ``on_migration`` is called with the
    old and new states, active sets, joiners, leavers and checkpoint paths
    of each migration before the old buffers are dropped.  Every round's
    K (transfers of its plan), n and, on the card, peak memory are printed
    and kept in ``TrainResult.rounds``.

    ``checkpoint`` writes the final parameters (every silo's) there in
    the reference's format.

    ``trace_out`` writes a flight-recorder trace there, as the
    reference's ``--trace-out`` does: spans are enabled for the run (and
    the span table and metrics registry cleared first, so the trace
    describes this run alone); the recorder takes
    :func:`~repro_torch.obs.events.run_metadata` with the underlay,
    scenario, designer, objective and steps, and Gaia's or AWS-NA's site
    names; the timeline and the controller write their records into it.
    Each round's step call runs inside a ``train.step`` span (the loss
    read after it stays outside, so on the card the span ends when the
    round's kernels are queued), ``train.h2d_bytes`` counts the host
    batches moved to ``device``, and every ``metrics_interval`` rounds
    (0: never) a ``round`` record is written and ``train.round_ms``
    observes the round's simulated duration.  ``run_end`` carries
    ``steps``, ``recompiles`` (the train-step builds: the first
    :func:`make_train_step` and one per rebuild on a plan or membership
    swap) and ``wall_s``.  Tracing reads host values only and changes no
    result: the losses, re-designs, launches and state are those of the
    untraced run.

    One silo per process: with ``mesh`` (a
    :class:`~repro_torch.launch.mesh.SiloMesh`), an initialised default
    process group of more than one rank, or ``WORLD_SIZE`` > 1 in the
    environment (``torchrun``; the group is then initialised with
    ``backend``, ``nccl`` on CUDA and ``gloo`` on the CPU when None), each
    rank trains silo ``rank``'s row (``silos`` must equal the world size)
    with the process-group forms of :func:`init_state` and
    :func:`make_train_step`.  Rank 0 prints the run's lines and owns the
    simulated timeline, the controller (its K1 launches), the trace and the
    checkpoint, which it writes from the rows it gathers, the same file as
    a single process writes; it broadcasts on the control group each
    round's active mask (``designer="matcha"``), each plan or schedule swap
    and each membership move.  An idle rank (its silo left) skips the
    round's local steps and mix; a leaver's rank writes its own
    ``churn_checkpoint``; joiners receive their float64 consensus rows
    from the survivors (:func:`~repro_torch.fed.dpasgd.migrate_rank_state`).
    ``on_migration`` is called on every rank with the migration's record
    (no states); ``verify_migration`` needs the stacked state and
    raises."""
    dev = resolve_device(device)
    mesh = _process_mesh(mesh, device, backend, log)
    rank_log = log  # this rank's own lines: staging, a leaver's checkpoint
    if mesh is not None:
        dev = mesh.device
        if mesh.rank != 0:
            log = _quiet
        if verify_migration:
            raise ValueError("verify_migration checks the stacked [n, P] state; with one "
                             "silo per process no rank holds it")
    rank0 = mesh is None or mesh.rank == 0
    if cfg.vision_prefix_len:
        raise ValueError(f"{cfg.arch_id} needs vision_embeds for its {cfg.vision_prefix_len}-"
                         "patch prefix, which the token stream does not supply; train a "
                         "config without a vision prefix")
    if cfg.is_encdec:
        raise ValueError(f"{cfg.arch_id} is an encoder-decoder and needs enc_frames, which "
                         "the token stream does not supply; train a decoder-only config")
    if gossip_impl not in GOSSIP_IMPLS:
        raise KeyError(gossip_impl)
    if topology not in TOPOLOGIES:
        raise KeyError(topology)
    if designer not in DESIGNERS:
        raise KeyError(designer)
    if scenario not in SCENARIOS:
        raise KeyError(scenario)
    net = silo_names = None
    if dynamic:
        from repro_torch.core import make_underlay
        from repro_torch.core.networks_data import AWS_NA_SITES, GAIA_SITES

        net = make_underlay(underlay)
        silos = net.num_silos
        # site names for bottleneck attribution in a trace: the paper's
        # measured networks carry city labels, synthetic ones do not
        sites = {"gaia": GAIA_SITES, "aws_na": AWS_NA_SITES}.get(net.name)
        if sites is not None:
            silo_names = [name for name, _ in sites]
    if mesh is not None and silos != mesh.world_size:
        raise ValueError(f"{silos} silos over {mesh.world_size} ranks: one silo per rank "
                         f"needs --silos (or the underlay's silo count) == the world size")
    recorder = None
    spans_were_on = obs_spans.enabled()
    if trace_out and rank0:
        obs_spans.reset()
        obs_metrics.reset()
        obs_spans.enable()
        recorder = FlightRecorder(
            trace_out,
            meta=run_metadata({
                "underlay": underlay if dynamic else None,
                "scenario": scenario if dynamic else None,
                "designer": designer,
                "objective": objective,
                "steps": steps,
            }),
            silo_names=silo_names,
        )
        log(f"[train] trace path={trace_out}")
    n = silos
    cfg = dataclasses.replace(cfg, n_silos=n)
    opt = momentum(lr, 0.9)
    # Randomized schedules sample a fresh topology per round, so their
    # consensus matrix is a step input (einsum lowering), as in the
    # reference.
    sched_mode = designer == "matcha" and n > 1 and gossip_impl != "none"
    if sched_mode and gossip_impl != "einsum":
        log(f"[train] gossip-impl-override matcha lowers gossip as an einsum of the "
            f"round's matrix requested={gossip_impl} used=einsum")
    fed = DPASGDConfig(local_steps=local_steps,
                       gossip_impl=("einsum" if sched_mode else gossip_impl) if n > 1 else "none")
    plan = slot = sched_slot = mem_slot = timeline = controller = None
    if dynamic and not rank0:
        # rank 0 designs the plan or schedule; the others mirror its slots
        plan, schedule = mesh.broadcast(None)
        if schedule is not None:
            sched_slot = ScheduleSlot(schedule[0], n, silos=schedule[1])
    elif dynamic:
        from repro_torch.core import (DEFAULT_MATCHA_BUDGETS, OVERLAY_KINDS, WORKLOADS,
                                      TrainingParams, design_overlay, design_schedule)
        from repro_torch.dynamics import (ControllerConfig, DynamicTimeline,
                                          OnlineTopologyController, active_subgraph)
        from repro_torch.fed import MembershipSlot, PlanSlot, plan_from_overlay

        M, Tc = WORKLOADS[workload]
        tp = TrainingParams(model_size_mbits=M, local_steps=local_steps)
        gc0 = net.connectivity_graph(comp_time_ms=Tc)
        if designer in MEASURED_DESIGNERS:
            kind = designer.replace("-", "_")
        else:
            kind = topology if topology in OVERLAY_KINDS else "ring"
        overlay = design_overlay(kind, gc0, tp, device=dev)
        schedule = None
        if designer == "matcha":
            schedule = design_schedule("matcha", gc0, tp, sample_seed=scenario_seed,
                                       objective=objective, device=dev)
            tau0 = schedule.price(gc0, tp, rounds=150, seeds=(0,), device=dev).tau_ms
            log(f"dynamic: {underlay} N={n}, matcha schedule (budget sweep -> "
                f"C_b={schedule.budget:g}, {schedule.num_matchings} matchings), "
                f"predicted tau={tau0:.1f} ms")
        else:
            tau0 = overlay.cycle_time_ms
            log(f"dynamic: {underlay} N={n}, {kind} overlay, predicted tau={tau0:.1f} ms")
        timeline = DynamicTimeline(_scenario(scenario, net, Tc, tau0, steps, overlay.edges,
                                             scenario_seed, p_churn), tp)
        if recorder is not None:
            timeline.attach_recorder(recorder)

        def provider():
            epoch = timeline.current_epoch()
            return active_subgraph(epoch.gc, epoch.active)

        mem_slot = MembershipSlot(range(n), n)
        if schedule is not None:
            timeline.set_schedule(schedule)
            sched_slot = ScheduleSlot(schedule, n)
            cfg_ctl = ControllerConfig(seed=scenario_seed, schedule_family="matcha",
                                       matcha_budgets=DEFAULT_MATCHA_BUDGETS,
                                       objective=objective)
            slot_kw = dict(schedule_slot=sched_slot)
        else:
            timeline.set_overlay(overlay.edges)
            slot = PlanSlot(plan_from_overlay(overlay, n))
            cfg_ctl = ControllerConfig(seed=scenario_seed, objective=objective)
            slot_kw = dict(plan_slot=slot)
            plan = slot.plan
        controller = OnlineTopologyController(
            gc0, tp, overlay, schedule=schedule, config=cfg_ctl,
            connectivity_provider=provider, membership_slot=mem_slot,
            membership_provider=timeline.current_active, recorder=recorder,
            silo_names=silo_names, device=dev, **slot_kw)
        if mesh is not None:
            mesh.broadcast((plan, None if sched_slot is None
                            else (sched_slot.schedule, sched_slot.silos)))
    else:
        if designer in MEASURED_DESIGNERS:
            log(f"[train] designer-ignored --designer {designer} needs --dynamic "
                "(network measurements)")
        if designer == "matcha" and n > 1:
            # Homogeneous MATCHA: matchings of the complete silo graph.
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
            schedule = MatchaSchedule(
                matchings=tuple(tuple(m) for m in greedy_edge_coloring(pairs)),
                budget=matcha_budget, sample_seed=scenario_seed)
            sched_slot = ScheduleSlot(schedule, n)
            log(f"matcha: homogeneous K_{n} base graph, {schedule.num_matchings} matchings, "
                f"C_b={schedule.budget:g} (per-round sampled plans)")
        else:
            # Without network measurements the measurement-based kinds fall
            # back to their homogeneous equivalents, as in the reference.
            kind = {"delta_mbst": "mst", "ring_2opt": "ring"}.get(topology, topology)
            if kind != topology:
                log(f"topology {topology} needs network measurements; using {kind}")
            plan = plan_for_n_silos(kind, n) if n > 1 else None
    step_fn = make_train_step(cfg, fed, opt, plan, consensus_arg=sched_mode, mesh=mesh)
    builds = 1  # train-step builds: the eager counterpart of re-traces
    state = init_state(cfg, opt, seed=seed, device=dev, mesh=mesh)
    # The data stream spans the full silo universe: under elastic
    # membership each silo label keeps its own (non-iid) distribution
    # across leaves/rejoins; the batcher stacks only the active labels.
    stream = SyntheticLMStream(cfg.vocab_size, seq_len, n_silos=max(n, 1))
    batcher = FederatedBatcher(stream, local_steps, batch_per_silo)
    # the result takes the state at the end: holding the first round's
    # dict would keep a buffer alive that a mix replaces
    result = TrainResult(cfg=cfg, fed=fed, optimizer=opt, plan=plan, batcher=batcher,
                         state={}, schedule_slot=sched_slot, controller=controller,
                         membership_slot=mem_slot, rank=None if mesh is None else mesh.rank)
    built_version = slot.version if slot is not None else 0
    built_mem_version = mem_slot.version if mem_slot is not None else 0
    sent_sched_version = sched_slot.version if sched_slot is not None else 0
    active = tuple(range(n))
    step_count = 0  # the shared optimizer step counter, kept on idle ranks too
    t0 = time.time()
    for i in range(steps):
        if (dynamic or mesh is not None) and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)  # each round's own peak
        t_step = time.perf_counter()
        if mesh is not None:
            counts = (mesh.recv_bytes, mesh.staged_bytes, mesh.staging_s)
        if dynamic and rank0:
            # one round == one communication round of simulated WAN,
            # simulated *first*, so the consensus mask below (and the
            # controller after the step) see the epoch the round spans
            duration = timeline.step()
        training = mesh is None or mesh.position is not None
        step_args = ()
        if sched_mode:
            round_plan = sched_slot.plan_for_round(i)  # this round's sampled topology
            A = round_plan.matrix
            result.consensus.append(A)
            if dynamic:
                # renormalize over the silos still active at the end of
                # this round: a leaver's stale params must not be mixed in
                # during the one-round lag before the membership rebuild
                flags = None
                if rank0:
                    ep_active = set(timeline.current_active())
                    flags = [1.0 if v in ep_active else 0.0 for v in active]
                    n_act = int(sum(flags))
                    if n_act < len(active):
                        log(f"step {i:4d} consensus masked to {n_act}/{len(active)} silos "
                            f"(mid-round churn)")
                if mesh is not None:
                    flags = mesh.broadcast(flags)
                step_args = (A, torch.tensor(flags))
            else:
                step_args = (A,)
        else:
            round_plan = plan
        loss = None
        if training:
            silos_now = active if mesh is None and dynamic else None
            if mesh is not None:
                silos_now = (mesh.rank,)
            raw = batcher.batch(i, silos=silos_now)
            if mesh is not None:
                raw = {k: v[0] for k, v in raw.items()}  # this rank's [s, B, S]
            if recorder is not None:
                obs_metrics.counter("train.h2d_bytes").inc(sum(v.nbytes for v in raw.values()))
            batch = batch_to_device(raw, dev)
            # the span ends when the step returns (on the card: when its
            # kernels are queued); the loss read below waits for them
            with obs_spans.span("train.step"):
                state, metrics = step_fn(state, batch, *step_args)
            del batch
            loss = float(metrics["loss"])
        step_count += local_steps
        result.step_seconds.append(time.perf_counter() - t_step)
        rec = None
        if dynamic or mesh is not None:
            rec = {"K": len(round_plan.terms) if round_plan is not None else 0,
                   "n": len(active)}
        if mesh is not None:
            rows_in = 0 if not training else recv_bytes_per_round(
                round_plan, fed.gossip_impl, mesh.position, 1)
            rec.update(active=training, wall_s=result.step_seconds[-1], rows_in=rows_in,
                       recv_bytes=mesh.recv_bytes - counts[0],
                       staged_bytes=mesh.staged_bytes - counts[1],
                       staging_s=mesh.staging_s - counts[2])
        control = None
        if dynamic and rank0:
            redesign = controller.observe_round(duration)
            if redesign is not None:
                timeline.set_schedule(redesign.schedule)
                name = (redesign.overlay.name if redesign.overlay
                        else redesign.schedule.name)
                rand = ("randomized schedule" if redesign.schedule.is_randomized
                        else "overlay")
                log(f"step {i:4d} [t={timeline.now_ms/1e3:7.1f}s sim] controller re-design "
                    f"-> {rand} {name} tau {redesign.measured_ms:.1f} -> "
                    f"{redesign.predicted_tau_ms:.1f} ms ({redesign.n_candidates} candidates "
                    f"in {redesign.elapsed_s*1e3:.0f} ms), bottleneck {redesign.bottleneck}")
            control = {
                "active": (mem_slot.active, mem_slot.version)
                if mem_slot.version != built_mem_version else None,
                "plan": slot.plan if slot is not None and slot.version != built_version
                else None,
                "schedule": (sched_slot.schedule, sched_slot.silos, sched_slot.history[-1][1])
                if sched_slot is not None and sched_slot.version != sent_sched_version
                else None}
            built_mem_version = mem_slot.version
            built_version = slot.version if slot is not None else 0
            sent_sched_version = sched_slot.version if sched_slot is not None else 0
        if dynamic and mesh is not None:
            # every rank: the round's loss (from an active silo) and rank 0's
            # swaps, in one exchange on the control group
            reports = mesh.all_gather_objects({"loss": loss, "control": control})
            loss = next(r["loss"] for r in reports if r["loss"] is not None)
            control = reports[0]["control"]
            if control["schedule"] is not None and not rank0:
                schedule, silos_order, label = control["schedule"]
                sched_slot.swap_schedule(schedule, label=label, silos=silos_order)
        result.losses.append(loss)
        if dynamic:
            rebuild = False
            if control["active"] is not None:
                new_active, version = control["active"]
                if mesh is None:
                    # rebinding ``state`` drops the old buffers before the
                    # step is rebuilt over the new silo count
                    state = _migrate_membership(
                        state, cfg, dev, active, new_active, version, i,
                        churn_checkpoint, verify_migration, on_migration, log)
                else:
                    state = _migrate_ranks(
                        state, cfg, opt, mesh, active, new_active, version, i, step_count,
                        churn_checkpoint, on_migration, log, rank_log)
                active = new_active
                n = len(active)
                cfg = dataclasses.replace(cfg, n_silos=n)
                rebuild = True
            if control["plan"] is not None:
                # hot-swap: rebuild the train step on the new plan
                plan = control["plan"]
                rebuild = True
            if rebuild:
                step_fn = None
                if mesh is None or mesh.position is not None:
                    step_fn = make_train_step(cfg, fed, opt, plan, consensus_arg=sched_mode,
                                              mesh=mesh)
                builds += 1
            # sched_slot swaps need no rebuild: the consensus matrix is a
            # step input and matrix_for_round follows the new schedule
        peak = ""
        if rec is not None and dev.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            peak = f" peak {rec['peak_bytes'] / 2**30:.2f} GiB"
        if rec is not None:
            result.rounds.append(rec)
        if dynamic:
            log(f"round {i} wall {result.step_seconds[-1]:.4f} s K {rec['K']} n {rec['n']}"
                + peak)
        if recorder is not None and metrics_interval and i % metrics_interval == 0:
            recorder.emit(
                "round",
                step=i,
                duration_ms=duration if dynamic else None,
                predicted_window_ms=(controller.expected_window_ms
                                     if controller is not None else None),
                measured_window_ms=(controller.last_measured_ms
                                    if controller is not None else None),
                drift=controller.last_drift if controller is not None else None,
            )
            if dynamic:
                obs_metrics.histogram("train.round_ms").observe(duration)
            obs_metrics.gauge("train.recompiles").set(builds)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            log(f"step {i:4d} loss {loss:.4f} ({time.time() - t0:.1f}s)")
    if dynamic and rank0:
        final = controller.schedule
        desc = (f"randomized schedule {final.name} (C_b={getattr(final, 'budget', 0):g})"
                if final.is_randomized else f"overlay {controller.overlay.name}")
        log(f"dynamic summary: {timeline.rounds_done} rounds in {timeline.now_ms/1e3:.1f}s "
            f"simulated, {len(controller.redesigns)} re-design(s), {mem_slot.version} "
            f"membership swap(s) ({len(active)}/{net.num_silos} silos active), final {desc} "
            f"(tau {controller.predicted_tau_ms:.1f} ms)")
    if dynamic:
        result.plan = slot.plan if slot is not None else plan
    if mesh is not None and mesh.staged:
        rank_log(f"[mesh] rank {mesh.rank} staged {mesh.staged_bytes} bytes through pinned "
                 f"host memory in {mesh.staging_s:.3f} s")
    if checkpoint:
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.models import ParamLayout, model_specs, state_to_tree

        t_ck = time.perf_counter()
        layout = ParamLayout(model_specs(cfg))
        ckpt_state = state
        if mesh is not None:
            # rank 0 gathers the rows in silo order: the single-process state
            rows = mesh.gather_rows(state["params"] if state else None, layout.size)
            ckpt_state = None if rows is None else {
                "params": rows if n > 1 else rows[0], "opt_state": None, "step": step_count}
        if ckpt_state is not None:
            tree = state_to_tree(ckpt_state, layout)
            save_checkpoint(checkpoint, tree["params"], step=steps)
            del tree
        log(f"checkpoint -> {checkpoint} ({time.perf_counter() - t_ck:.1f} s)")
    if recorder is not None:
        obs_metrics.gauge("train.recompiles").set(builds)
        recorder.close(steps=steps, recompiles=builds, wall_s=time.time() - t0)
        log(f"[train] trace-written path={trace_out} spans={len(obs_spans.summary())}")
        if not spans_were_on:
            obs_spans.disable()
    result.cfg, result.state, result.active = cfg, state or {}, active
    return result


def _migrate_membership(state, cfg, dev, active, new_active, version, i,
                        churn_checkpoint, verify_migration, on_migration, log):
    """Elastic membership: re-stack the state over ``new_active`` on its
    device, checkpoint the leavers' rows, verify on request, and print the
    reference's ``membership`` line.  Returns the new state."""
    from repro_torch.fed import migrate_silo_state, slice_silo_row
    from repro_torch.models import ParamLayout, model_specs

    _sync(dev)
    t_mig = time.perf_counter()
    new_state, joined, left = migrate_silo_state(state, active, new_active)
    _sync(dev)
    wall = time.perf_counter() - t_mig
    paths = []
    if churn_checkpoint and left:
        from repro_torch.checkpoint import save_silo_checkpoint

        layout = ParamLayout(model_specs(cfg))
        for v in left:
            # full row: params AND optimizer slot (plus the shared step
            # counter), so a later rejoin can recover what the silo trained
            row = slice_silo_row(state, active, v, layout)
            paths.append(save_silo_checkpoint(churn_checkpoint, v, row, step=i))
            log(f"step {i:4d} leaver silo {v} checkpoint -> {paths[-1]}")
    msg = (f"step {i:4d} membership v{version}: {len(active)} -> {len(new_active)} silos "
           f"(left {list(left)}, joined {list(joined)}); mesh+state rebuilt")
    record = {"old_active": active, "new_active": new_active, "joined": joined, "left": left,
              "wall_s": wall, "checkpoints": paths}
    if verify_migration:
        ok_surv, ok_join = _verify_migration(state, new_state, active, new_active, joined)
        record.update(survivors_ok=ok_surv, joiners_ok=ok_join)
        msg += f", survivors-bit-identical={ok_surv}, joiners-at-consensus={ok_join}"
    if on_migration is not None:
        on_migration(dict(record, old_state=state, new_state=new_state))
    log(msg + f" (migration {wall:.4f} s)")
    return new_state


def _migrate_ranks(state, cfg, opt, mesh, active, new_active, version, i, step,
                   churn_checkpoint, on_migration, log, rank_log):
    """Elastic membership with one silo per rank: a leaver's rank
    checkpoints its own row and goes idle, the joiners receive their
    float64 consensus rows from the survivors
    (:func:`~repro_torch.fed.dpasgd.migrate_rank_state`), and rank 0 prints
    the ``membership`` line.  Returns this rank's state (None when idle)."""
    from repro_torch.fed.dpasgd import migrate_rank_state
    from repro_torch.models import ParamLayout, model_specs

    layout = ParamLayout(model_specs(cfg))
    paths = []
    if churn_checkpoint and mesh.rank in active and mesh.rank not in new_active:
        from repro_torch.checkpoint import save_silo_checkpoint
        from repro_torch.fed import slice_silo_row

        row = slice_silo_row(state, (mesh.rank,), mesh.rank, layout)
        paths.append(save_silo_checkpoint(churn_checkpoint, mesh.rank, row, step=i))
        rank_log(f"step {i:4d} leaver silo {mesh.rank} checkpoint -> {paths[-1]}")
    _sync(mesh.device)
    t_mig = time.perf_counter()
    state, joined, left = migrate_rank_state(state, mesh, active, new_active, size=layout.size,
                                             optimizer=opt, step=step)
    _sync(mesh.device)
    wall = time.perf_counter() - t_mig
    if on_migration is not None:
        on_migration({"old_active": active, "new_active": new_active, "joined": joined,
                      "left": left, "wall_s": wall, "checkpoints": paths})
    log(f"step {i:4d} membership v{version}: {len(active)} -> {len(new_active)} silos "
        f"(left {list(left)}, joined {list(joined)}); mesh+state rebuilt (migration "
        f"{wall:.4f} s)")
    return state


def _quiet(line: str) -> None:
    """The log of a rank other than 0: the run's lines are rank 0's."""


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--topology", default="ring", choices=list(TOPOLOGIES))
    ap.add_argument("--gossip-impl", default="ppermute", choices=list(GOSSIP_IMPLS))
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch-per-silo", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--checkpoint", default="",
                    help="write the final parameters here (msgpack, the reference's format)")
    ap.add_argument("--dynamic", action="store_true",
                    help="simulate a time-varying WAN and run the online topology controller "
                         "(silo count follows the underlay; membership is elastic: on "
                         "SiloJoin/SiloLeave the state is re-stacked over the active silos)")
    ap.add_argument("--designer", default="auto", choices=list(DESIGNERS),
                    help="'matcha' trains on a randomized schedule (per-round sampled plans "
                         "mixed by einsum; with --dynamic the budget is swept on the measured "
                         "underlay and re-fit on drift, without it homogeneous MATCHA); "
                         "'sparse-rewire' (the rewire search), 'delta-rewire' (its host "
                         "delta-priced climb) and 'hierarchical' design the initial overlay "
                         "from the measurements and need --dynamic; default: --topology")
    ap.add_argument("--matcha-budget", type=float, default=0.5,
                    help="static-mode MATCHA activation probability C_b")
    ap.add_argument("--objective", default="tau", choices=["tau", "time_to_eps"],
                    help="what design/re-design optimizes (needs --dynamic): 'tau' cycle time "
                         "alone, 'time_to_eps' the composite tau / -log(rho)")
    ap.add_argument("--underlay", default="gaia")
    ap.add_argument("--workload", default="inaturalist")
    ap.add_argument("--scenario", default="linkfail", choices=list(SCENARIOS))
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed of the scenario, the controller and MATCHA's sampling")
    ap.add_argument("--p-churn", type=float, default=0.15,
                    help="--scenario random: probability mass of silo leave/rejoin churn")
    ap.add_argument("--churn-checkpoint", default="",
                    help="directory: a departing silo's state row is checkpointed there "
                         "before its row is dropped")
    ap.add_argument("--verify-migration", action="store_true",
                    help="after each membership rebuild, check on the card that survivors "
                         "are bit-identical and joiners sit at the consensus average")
    ap.add_argument("--trace-out", default="",
                    help="write a JSONL flight-recorder trace here (turns "
                         "on spans + metrics; render/validate it with "
                         "scripts/obs_report.py)")
    ap.add_argument("--metrics-interval", type=int, default=10,
                    help="steps between 'round' trace records (0 disables "
                         "per-round records; decision records are always "
                         "written when --trace-out is set)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun (one silo per rank): nccl (the default on CUDA, one "
                         "card per rank) or gloo (the default on the CPU; with ranks on a "
                         "card, every transfer is staged through pinned host memory)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, silos=args.silos, topology=args.topology,
          gossip_impl=args.gossip_impl, local_steps=args.local_steps,
          batch_per_silo=args.batch_per_silo, seq_len=args.seq_len,
          steps=args.steps, lr=args.lr, device=args.device, designer=args.designer,
          matcha_budget=args.matcha_budget, scenario_seed=args.scenario_seed,
          dynamic=args.dynamic, underlay=args.underlay, workload=args.workload,
          scenario=args.scenario, p_churn=args.p_churn, objective=args.objective,
          checkpoint=args.checkpoint, churn_checkpoint=args.churn_checkpoint,
          verify_migration=args.verify_migration, trace_out=args.trace_out,
          metrics_interval=args.metrics_interval, backend=args.dist_backend,
          log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
