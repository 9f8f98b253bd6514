"""The reference's DPASGD rounds: every silo's local steps with the plain
model and optimizer of :mod:`portbench.reference.model`, then the mix of
the parameter rows under the round's consensus matrix.  Imports nothing
of the program."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple

import torch

from . import model as M


def follow(d: M.Dims, n: int, seed: int, batch: Callable[[int], Dict[str, torch.Tensor]],
           matrix: Callable[[int], object], optimizer: Dict[str, object], rounds: int,
           device) -> Dict[str, List]:
    """Run ``rounds`` rounds from the rows ``seed`` draws.  ``batch(r)``
    gives round r's ``{"tokens", "labels"}`` ``[n, s, B, S]``,
    ``matrix(r)`` its ``[n, n]`` consensus matrix; ``optimizer`` is
    ``{"kind": "adamw" | "momentum", "lr": ..., "beta": ...}``.  Returns
    the round losses (mean over silos and local steps), the per-leaf
    norms of the optimizer's first slot after round 0 (``grad``) and of
    the rows' change after the last round (``delta``)."""
    with _no_tf32():
        return _follow(d, n, seed, batch, matrix, optimizer, rounds, device)


@contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def one_round_row(d: M.Dims, rows: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
                  batch: Dict[str, torch.Tensor], weights: Dict[int, float],
                  optimizer: Dict[str, object]) -> Tuple[torch.Tensor, Dict[int, List[float]]]:
    """One momentum round of one silo's row, from given rows: each silo c
    of ``rows`` (its parameters and momentum; row k of ``batch``
    ``[len(rows), s, B, S]`` is the k-th silo in sorted order) takes its
    local steps, then the row is ``sum_c weights[c] x_c`` in float64,
    rounded once.  Returns the row and, per silo, the per-leaf norms of
    its first gradient."""
    with _no_tf32():
        lr, beta = float(optimizer["lr"]), float(optimizer.get("beta", 0.9))
        table = M.leaf_table(d)
        acc, grads = None, {}
        for k, (c, (p, m)) in enumerate(sorted(rows.items())):
            p, m = p.clone(), m.clone()
            for st in range(batch["tokens"].shape[1]):
                _, g = M.loss_and_grad(p, d, batch["tokens"][k, st], batch["labels"][k, st])
                if st == 0:
                    grads[c] = [float(torch.linalg.vector_norm(g[lf.offset:lf.offset + lf.size],
                                                               dtype=torch.float64))
                                for lf in table]
                M.momentum_step(p, g, m, lr, beta)
                del g
            if weights.get(c, 0.0):
                term = p.double().mul_(weights[c])
                acc = term if acc is None else acc.add_(term)
            del p, m
        return acc.float(), grads


def _follow(d, n, seed, batch, matrix, optimizer, rounds, device):
    from portbench.core import delta_norms, leaf_norms

    table = M.leaf_table(d)
    rows = M.init_rows(d, n, seed, device)
    kind, lr = optimizer["kind"], float(optimizer["lr"])
    slot = torch.zeros_like(rows)
    second = torch.zeros_like(rows) if kind == "adamw" else None
    losses, grad = [], None
    t = 0
    for r in range(rounds):
        b = batch(r)
        s = b["tokens"].shape[1]
        vals = []
        for i in range(n):
            for m in range(s):
                val, g = M.loss_and_grad(rows[i], d, b["tokens"][i, m], b["labels"][i, m])
                vals.append(val)
                if kind == "adamw":
                    M.adamw_step(rows[i], g, slot[i], second[i], t + m + 1, lr)
                else:
                    M.momentum_step(rows[i], g, slot[i], lr, float(optimizer.get("beta", 0.9)))
                del g
        t += s
        losses.append(sum(vals) / len(vals))
        if r == 0:
            grad = leaf_norms(slot, table)
        M.mix_rows(rows, matrix(r))
    del slot, second
    delta = delta_norms(rows, d, seed)
    return {"losses": losses, "grad": grad, "delta": delta}
