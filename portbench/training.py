"""What the training entries share: the first rounds that the reference
follows, the numbers compared, the calibration's switches, and the
CUDA-event wrapper around the optimizer of a traced run."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from portbench import core, yardstick
from portbench.reference import dpasgd

CHECK_ROUNDS = 3  # rounds from the seed that the reference follows


def slot_rows(opt_state):
    """The optimizer's first slot as ``[n, P]`` (AdamW's ``mu``)."""
    return opt_state["mu"] if isinstance(opt_state, dict) else opt_state


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def faulty(step: Callable, fault: str) -> Callable:
    """The step with a planted fault: ``frozen`` returns the state it was
    given, ``half_batch`` trains on the first half of every sequence."""
    if fault == "frozen":
        def frozen(state, batch, *args):
            copy = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                        else v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in state.items()}
            _, metrics = step(copy, batch, *args)
            return state, metrics
        return frozen
    if fault == "half_batch":
        def half(state, batch, *args):
            S = batch["tokens"].shape[-1]
            return step(state, {k: v[..., :S // 2] for k, v in batch.items()}, *args)
        return half
    return step


def training_checks(prog: Dict[str, List], ref: Dict[str, List],
                    limits: Dict[str, float]) -> List[Dict[str, Any]]:
    """The three numbers of a training cell, each beside its limit: the
    worst relative gap of a round's loss, and the worst leaf's gap of the
    optimizer's first slot after round 0 and of the rows' change after
    the last round (leaves that the reference's gradient leaves at
    round-off left out of the change)."""
    rule = yardstick.moving_leaves(ref["grad"])
    return [
        core.check("loss_gap", yardstick.loss_gap(prog["losses"], ref["losses"]),
                   limits["loss_gap"]),
        core.check("grad_gap", yardstick.worst_leaf_gap(prog["grad"], ref["grad"]),
                   limits["grad_gap"]),
        core.check("delta_gap", yardstick.worst_leaf_gap(prog["delta"], ref["delta"], rule),
                   limits["delta_gap"]),
    ]


def reference(ctx, n: int, batch, matrix, optimizer: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's check rounds, with their wall time (``seconds``)."""
    t0 = time.perf_counter()
    ref = dpasgd.follow(ctx.dims, n, ctx.seed, batch, matrix, optimizer, CHECK_ROUNDS,
                        ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def update_bytes(param, streams: int) -> int:
    """Bytes an elementwise update moves: ``streams`` passes over the row."""
    return streams * param.numel() * param.element_size()


class TimedOptimizer:
    """An optimizer whose every ``update`` is bracketed by CUDA events, for
    the traced run: ``seconds()`` and ``bytes()`` of the updates since
    ``arm()`` (7 float32 streams of the row for AdamW: the gradient, the
    two slots and the parameters read, the slots and the parameters
    written)."""

    def __init__(self, opt, streams: int):
        self._opt, self._streams = opt, streams
        self._events: List = []
        self._bytes = 0
        self.armed = False
        self.init = opt.init

    def update(self, grad, state, param, step=None):
        if not self.armed:
            return self._opt.update(grad, state, param, step)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        self._opt.update(grad, state, param, step)
        b.record()
        self._events.append((a, b))
        self._bytes += update_bytes(param, self._streams)

    def arm(self) -> None:
        self.armed = True

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events) / 1e3

    def bytes(self) -> int:
        return self._bytes
