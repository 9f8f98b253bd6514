"""SGD, heavy-ball momentum, Adam and AdamW (the paper trains with SGD and
Adam -- Appendix G.3), global-norm clipping and the inverse-square-root
schedule.

Counterparts of ``repro.optim``, acting on tensors in place: the training
state holds each silo's parameters and optimizer slot as flat rows, and
an update rewrites them where they lie instead of allocating a new copy
of the model.  ``update(grad, state, param, step=None)`` follows the
reference's argument order; ``step`` is the optimizer step counter (an
int), which a schedule and Adam's bias correction read.  ``lr`` is a
float or a callable of the step (:func:`inverse_sqrt_decay`).  SGD and
momentum with a float ``lr`` need no step; a schedule, Adam and AdamW
raise without one, so the bias correction never silently sits at its
first step.  Scalars of the step (the schedule, ``b ** t``) are computed
on the host in float32, as the reference computes them on the device, so
no update waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

LR = Union[float, Callable[[int], float]]

# Columns per chunk of an Adam update: its float32 temporaries stay at a
# few chunk-sized buffers instead of whole [P] rows.
_ADAM_CHUNK = 1 << 24


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., None]
    # update(grad, opt_state, param, step=None): rewrites param and
    # opt_state (None, a buffer, or a dict of buffers) in place


def _lr_fn(lr: LR, name: str) -> Callable[[Optional[int]], float]:
    if not callable(lr):
        return lambda step: lr

    def eta(step):
        if step is None:
            raise ValueError(f"{name} with a learning-rate schedule needs the step counter")
        return lr(step)

    return eta


def sgd(lr: LR) -> Optimizer:
    lr_fn = _lr_fn(lr, "sgd")

    def init(param):
        return None

    @torch.no_grad()
    def update(grad, state, param, step=None):
        param.sub_(lr_fn(step) * grad.to(param.dtype))

    return Optimizer(init, update)


def momentum(lr: LR, beta: float = 0.9) -> Optimizer:
    """``m <- beta*m + g``; ``p <- p - lr*m``, as the reference."""
    lr_fn = _lr_fn(lr, "momentum")

    def init(param):
        return torch.zeros_like(param)

    @torch.no_grad()
    def update(grad, state, param, step=None):
        state.mul_(beta).add_(grad)
        param.sub_(lr_fn(step) * state.to(param.dtype))

    return Optimizer(init, update)


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; the slot is ``{"mu": buf, "nu":
    buf}``, float32 buffers shaped like the param rows.  At step ``step``
    (t = step + 1) it computes, in float32 and in the reference's order,
    ``mu <- b1*mu + (1-b1)*g``, ``nu <- b2*nu + (1-b2)*g^2`` and ``p <- p -
    lr * ((mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps) + wd*p)``."""
    lr_fn = _lr_fn(lr, "adamw")

    def init(param):
        return {"mu": torch.zeros_like(param, dtype=torch.float32),
                "nu": torch.zeros_like(param, dtype=torch.float32)}

    @torch.no_grad()
    def update(grad, state, param, step=None):
        if step is None:
            raise ValueError("adamw needs the step counter for its bias correction")
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        eta = lr_fn(step)
        g_all, m_all, v_all = grad.reshape(-1), state["mu"].reshape(-1), state["nu"].reshape(-1)
        p_all = param.reshape(-1)
        for lo in range(0, p_all.numel(), _ADAM_CHUNK):
            hi = lo + _ADAM_CHUNK
            g = g_all[lo:hi].to(torch.float32)
            # each product rounded on its own, then the sum: no fused multiply-add
            m = m_all[lo:hi].mul_(b1).add_(g.mul(1 - b1))
            v = v_all[lo:hi].mul_(b2).add_(g.square().mul_(1 - b2))
            upd = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(eps))
            p = p_all[lo:hi]
            if weight_decay:
                upd.add_(p.float() * weight_decay)
            p.sub_(upd.mul_(eta))

    return Optimizer(init, update)


def clip_by_global_norm(grad: torch.Tensor, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(grad * min(1, max_norm / max(|grad|, 1e-9)), |grad|)`` of a flat
    gradient row, the norm taken in float32."""
    norm = torch.linalg.vector_norm(grad.to(torch.float32))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return grad * scale.to(grad.dtype), norm


def inverse_sqrt_decay(base_lr: float, warmup: int = 0) -> Callable[[int], float]:
    """The paper decays lr with the inverse square root of the round count:
    ``base_lr / sqrt(max(step, 1))``, or ``base_lr * (step + 1) / warmup``
    while ``step < warmup``; in float32, as the reference."""

    def lr(step: int) -> float:
        val = np.float32(base_lr) / np.sqrt(np.float32(max(step, 1)))
        if warmup and step < warmup:
            val = np.float32(base_lr) * np.float32(step + 1) / np.float32(warmup)
        return float(val)

    return lr
