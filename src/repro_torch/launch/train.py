"""Training launcher: DPASGD over a static topology, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --topology ring --gossip-impl pallas --steps 30

Counterpart of ``repro.launch.train`` on its static path, with the same
flags plus ``--device`` (default ``cuda``; ``--device cpu`` with
``--reduced`` runs the small variant on the CPU).  ``main`` parses the
flags and calls :func:`train`, which scripts can call at a depth the CLI
has no flag for.

``--designer matcha`` trains on a randomized schedule: homogeneous MATCHA
over the complete silo graph (``--matcha-budget`` is its activation
probability C_b, ``--scenario-seed`` its sampling seed); a
:class:`~repro_torch.fed.gossip.ScheduleSlot` samples each round's plan
from the round counter and the step mixes that round's consensus matrix
with the ``einsum`` lowering:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --designer matcha --steps 30
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.fed.gossip import GOSSIP_IMPLS, GossipPlan
from repro_torch.models import ModelConfig
from repro_torch.optim import Optimizer, momentum

TOPOLOGIES = ("ring", "star", "chain", "none", "mst", "ring_2opt", "delta_mbst")
DESIGNERS = ("auto", "sparse-rewire", "delta-rewire", "hierarchical", "matcha")


@dataclass
class TrainResult:
    cfg: ModelConfig                # with n_silos set
    fed: DPASGDConfig
    optimizer: Optimizer
    plan: Optional[GossipPlan]
    batcher: FederatedBatcher
    state: Dict[str, Any]           # final state (flat [n_silos, P] buffers)
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    schedule_slot: Optional[ScheduleSlot] = None  # --designer matcha
    consensus: List[np.ndarray] = field(default_factory=list)  # each round's matrix, matcha


def batch_to_device(raw: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long) for k, v in raw.items()}


def train(cfg: ModelConfig, *, silos: int = 4, topology: str = "ring",
          gossip_impl: str = "ppermute", local_steps: int = 2,
          batch_per_silo: int = 4, seq_len: int = 64, steps: int = 30,
          lr: float = 0.05, seed: int = 0, device: DeviceLike = "cuda",
          designer: str = "auto", matcha_budget: float = 0.5, scenario_seed: int = 0,
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` with DPASGD for ``steps`` rounds and print the
    reference's ``step k loss ...`` lines.  Each round's time is taken
    on the host clock around the round, ending when its loss reaches the
    host (which waits for every kernel the round queued, the mix
    included).

    ``designer="matcha"`` trains on homogeneous MATCHA over the complete
    silo graph (activation probability ``matcha_budget``, sampling seed
    ``scenario_seed``): each round's consensus matrix comes from a
    :class:`ScheduleSlot` and is mixed with the ``einsum`` lowering,
    whatever ``gossip_impl`` asks for (apart from ``"none"``).  The
    measurement-based designers need network measurements and are
    ignored here, as in the reference without ``--dynamic``."""
    dev = resolve_device(device)
    if gossip_impl not in GOSSIP_IMPLS:
        raise KeyError(gossip_impl)
    if topology not in TOPOLOGIES:
        raise KeyError(topology)
    if designer not in DESIGNERS:
        raise KeyError(designer)
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
    if designer in ("sparse-rewire", "delta-rewire", "hierarchical"):
        log(f"[train] designer-ignored --designer {designer} needs --dynamic "
            "(network measurements)")
    plan = slot = None
    if designer == "matcha" and n > 1:
        # Homogeneous MATCHA: matchings of the complete silo graph.
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        schedule = MatchaSchedule(
            matchings=tuple(tuple(m) for m in greedy_edge_coloring(pairs)),
            budget=matcha_budget, sample_seed=scenario_seed)
        slot = ScheduleSlot(schedule, n)
        log(f"matcha: homogeneous K_{n} base graph, {schedule.num_matchings} matchings, "
            f"C_b={schedule.budget:g} (per-round sampled plans)")
    else:
        # Without network measurements the measurement-based kinds fall
        # back to their homogeneous equivalents, as in the reference.
        kind = {"delta_mbst": "mst", "ring_2opt": "ring"}.get(topology, topology)
        if kind != topology:
            log(f"topology {topology} needs network measurements; using {kind}")
        plan = plan_for_n_silos(kind, n) if n > 1 else None
    step_fn = make_train_step(cfg, fed, opt, plan, consensus_arg=sched_mode)
    state = init_state(cfg, opt, seed=seed, device=dev)
    stream = SyntheticLMStream(cfg.vocab_size, seq_len, n_silos=max(n, 1))
    batcher = FederatedBatcher(stream, local_steps, batch_per_silo)
    result = TrainResult(cfg=cfg, fed=fed, optimizer=opt, plan=plan,
                         batcher=batcher, state=state, schedule_slot=slot)
    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        batch = batch_to_device(batcher.batch(i), dev)
        if sched_mode:
            A = slot.matrix_for_round(i)  # this round's sampled topology
            result.consensus.append(A)
            state, metrics = step_fn(state, batch, A)
        else:
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        result.step_seconds.append(time.perf_counter() - t_step)
        result.losses.append(loss)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            log(f"step {i:4d} loss {loss:.4f} ({time.time() - t0:.1f}s)")
    result.state = state
    return result


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
    ap.add_argument("--designer", default="auto", choices=list(DESIGNERS),
                    help="'matcha' trains on a randomized schedule (homogeneous MATCHA, "
                         "per-round sampled plans mixed by einsum); the measurement-based "
                         "designers need --dynamic, which the port does not have yet, and "
                         "are ignored")
    ap.add_argument("--matcha-budget", type=float, default=0.5,
                    help="MATCHA activation probability C_b")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="MATCHA's sampling seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, silos=args.silos, topology=args.topology,
          gossip_impl=args.gossip_impl, local_steps=args.local_steps,
          batch_per_silo=args.batch_per_silo, seq_len=args.seq_len,
          steps=args.steps, lr=args.lr, device=args.device, designer=args.designer,
          matcha_budget=args.matcha_budget, scenario_seed=args.scenario_seed,
          log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
