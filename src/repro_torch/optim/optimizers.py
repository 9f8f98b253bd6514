"""SGD and heavy-ball momentum (the paper trains with SGD — Appendix G.3).

Counterparts of ``repro.optim.sgd`` / ``momentum``, acting on tensors in
place: the training state holds each silo's parameters and optimizer
slot as flat rows, and an update rewrites them where they lie instead of
allocating a new copy of the model.  ``update(grad, state, param)``
follows the reference's argument order; the learning rate is a constant
(the reference also takes a schedule of the step, which nothing here
uses yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Optional[torch.Tensor]]
    update: Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], None]
    # update(grad, opt_state, param): rewrites param and opt_state in place


def sgd(lr: float) -> Optimizer:
    def init(param):
        return None

    @torch.no_grad()
    def update(grad, state, param):
        param.sub_(lr * grad.to(param.dtype))

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """``m <- beta*m + g``; ``p <- p - lr*m``, as the reference."""
    def init(param):
        return torch.zeros_like(param)

    @torch.no_grad()
    def update(grad, state, param):
        state.mul_(beta).add_(grad)
        param.sub_(lr * state.to(param.dtype))

    return Optimizer(init, update)
