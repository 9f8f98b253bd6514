"""Recompile guards: turn "builds once" from a claim into an assert
(the reference's ``repro/analysis/recompile.py``; framework-neutral).

The reference counts ``jax.jit`` traces.  In eager PyTorch the same
promise has two halves, and both are counted with this helper:

* the DPASGD train step is built once per plan or membership version
  (``repro_torch.launch.train`` rebuilds it only when a slot's version
  moves, and exports the count as the ``train.recompiles`` gauge):
  wrap the step factory, ``make_train_step``, in a
  :class:`TraceCounter` and run many rounds;
* each CUDA library is built or loaded once per process
  (``repro_torch.kernels._build.load_library`` is cached).

    counter = TraceCounter(make_train_step)
    step = counter(cfg, plan, consensus_arg=True)
    ... run many rounds ...
    assert_max_traces(counter, 1)

``tests/test_torch_analysis.py`` asserts both for 12 sampled MATCHA
rounds: per-round sampled topologies feed a consensus *argument*, so
K rounds cost one build.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

__all__ = ["TraceCounter", "assert_max_traces"]


class TraceCounter:
    """Wrap a function so each call (a trace under ``jax.jit``, a build
    when the wrapped function is a step factory) increments ``count``."""

    def __init__(self, fn: Callable[..., Any], name: str = ""):
        self.fn = fn
        self.count = 0
        self.name = name or getattr(fn, "__name__", "fn")
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        self.count += 1
        return self.fn(*args, **kwargs)

    def reset(self) -> None:
        self.count = 0


def assert_max_traces(counter: TraceCounter, limit: int = 1) -> None:
    if counter.count > limit:
        raise AssertionError(
            f"'{counter.name}' traced {counter.count} times "
            f"(limit {limit}): a static signature is varying across "
            f"calls — check dtypes, weak types, shapes and static args")
