"""Training launcher: DPASGD over a static topology, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --silos 4 --topology ring --gossip-impl pallas --steps 30

Counterpart of ``repro.launch.train`` on its static path, with the same
flags plus ``--device`` (default ``cuda``; ``--device cpu`` with
``--reduced`` runs the small variant on the CPU).  ``main`` parses the
flags and calls :func:`train`, which scripts can call at a depth the CLI
has no flag for.
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
from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_for_n_silos
from repro_torch.fed.gossip import GOSSIP_IMPLS, GossipPlan
from repro_torch.models import ModelConfig
from repro_torch.optim import Optimizer, momentum

TOPOLOGIES = ("ring", "star", "chain", "none", "mst", "ring_2opt", "delta_mbst")


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


def batch_to_device(raw: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long) for k, v in raw.items()}


def train(cfg: ModelConfig, *, silos: int = 4, topology: str = "ring",
          gossip_impl: str = "ppermute", local_steps: int = 2,
          batch_per_silo: int = 4, seq_len: int = 64, steps: int = 30,
          lr: float = 0.05, seed: int = 0, device: DeviceLike = "cuda",
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` with DPASGD for ``steps`` rounds and print the
    reference's ``step k loss ...`` lines.  Each round's time is taken
    on the host clock around the round, ending when its loss reaches the
    host (which waits for every kernel the round queued, the mix
    included)."""
    dev = resolve_device(device)
    if gossip_impl not in GOSSIP_IMPLS:
        raise KeyError(gossip_impl)
    if topology not in TOPOLOGIES:
        raise KeyError(topology)
    n = silos
    cfg = dataclasses.replace(cfg, n_silos=n)
    opt = momentum(lr, 0.9)
    # Without network measurements the measurement-based kinds fall back
    # to their homogeneous equivalents, as in the reference.
    kind = {"delta_mbst": "mst", "ring_2opt": "ring"}.get(topology, topology)
    if kind != topology:
        log(f"topology {topology} needs network measurements; using {kind}")
    plan = plan_for_n_silos(kind, n) if n > 1 else None
    fed = DPASGDConfig(local_steps=local_steps,
                       gossip_impl=gossip_impl if n > 1 else "none")
    step_fn = make_train_step(cfg, fed, opt, plan)
    state = init_state(cfg, opt, seed=seed, device=dev)
    stream = SyntheticLMStream(cfg.vocab_size, seq_len, n_silos=max(n, 1))
    batcher = FederatedBatcher(stream, local_steps, batch_per_silo)
    result = TrainResult(cfg=cfg, fed=fed, optimizer=opt, plan=plan,
                         batcher=batcher, state=state)
    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch_to_device(batcher.batch(i), dev))
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, silos=args.silos, topology=args.topology,
          gossip_impl=args.gossip_impl, local_steps=args.local_steps,
          batch_per_silo=args.batch_per_silo, seq_len=args.seq_len,
          steps=args.steps, lr=args.lr, device=args.device,
          log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
