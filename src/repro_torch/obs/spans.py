"""Nested wall-clock spans with a near-zero-cost disabled path (a copy of
the reference's ``repro/obs/spans.py``).

Every engine entry point, designer call, controller actuation and train
step can open a :func:`span`, and the resulting tree of timed intervals
answers "where did this round's wall clock go?" without a profiler
attached.

Design constraints (held by ``tests/test_torch_obs.py``):

* **Default off, near-zero cost.**  ``span()`` with tracing disabled
  returns a shared no-op context manager — one module-global flag read
  and no allocation.  :func:`span_fn` wrappers fall through to the
  wrapped function on the same flag.
* **Host clock only.**  A span reads ``time.perf_counter()`` and nothing
  else: it never calls ``torch.cuda.synchronize``, never reads a tensor
  and never records a CUDA event.  Kernel launches are asynchronous, so
  a span around a call that only queues kernels on the card measures
  the queueing, not the kernels — the counterpart of a span around an
  asynchronous JAX dispatch in the reference.  A span measures device
  time only when the callee itself waits for the card (a host read of a
  result, as the train loop's loss read does *after* its span).
* **Host entry points only.**  Spans go on the Python entry points (the
  numpy engines, the designers, the controller, the call of the train
  step), never inside a body that is or may become a captured CUDA
  graph (the DPASGD step, the climb step, decode): a graph replays its
  kernels without running the Python that opened the span.
* **Thread-local nesting.**  The active span stack is per-thread, so
  concurrent controllers cannot corrupt each other's parentage.

Aggregation is always on while enabled: finished spans fold into a
process-local ``{name: (count, total_s, max_s)}`` table read by
:func:`summary` (what the flight recorder embeds in its ``run_end``
record).  The full span stream (with parent/depth) is kept in a bounded
ring for tests and ad-hoc inspection via :func:`pop_finished`.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

__all__ = [
    "Span",
    "SpanRecord",
    "disable",
    "enable",
    "enabled",
    "pop_finished",
    "reset",
    "span",
    "span_fn",
    "summary",
]


class _State:
    __slots__ = ("enabled", "capture")

    def __init__(self) -> None:
        self.enabled = False
        self.capture = True


_STATE = _State()
_TLS = threading.local()
_LOCK = threading.Lock()
# name -> [count, total_s, max_s]; folded under _LOCK on span exit.
_AGG: Dict[str, List[float]] = {}
_CAPTURE_MAX = 4096
_FINISHED: Deque["SpanRecord"] = deque(maxlen=_CAPTURE_MAX)


@dataclass(frozen=True)
class SpanRecord:
    """One finished span, as folded into the capture ring."""

    name: str
    parent: Optional[str]
    depth: int
    t_start_s: float  # perf_counter timestamp at entry
    duration_s: float
    attrs: Dict[str, Any] = field(default_factory=dict)


def _stack() -> List["Span"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class _NoopSpan:
    """Shared disabled-path span: no allocation, no clock read."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NOOP = _NoopSpan()


class Span:
    """A live (enabled-path) span.  Use via :func:`span`, not directly."""

    __slots__ = ("name", "attrs", "parent", "depth", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[str] = None
        self.depth = 0
        self._t0 = 0.0

    def set(self, **attrs: Any) -> None:
        """Attach attributes to the span (recorded at exit)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].name
            self.depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # misnested exit: drop down to this span
            while stack and stack.pop() is not self:
                pass
        with _LOCK:
            agg = _AGG.get(self.name)
            if agg is None:
                _AGG[self.name] = [1.0, dur, dur]
            else:
                agg[0] += 1.0
                agg[1] += dur
                if dur > agg[2]:
                    agg[2] = dur
            if _STATE.capture:
                _FINISHED.append(
                    SpanRecord(
                        name=self.name,
                        parent=self.parent,
                        depth=self.depth,
                        t_start_s=self._t0,
                        duration_s=dur,
                        attrs=dict(self.attrs),
                    )
                )
        return False


def span(name: str, **attrs: Any):
    """Open a named span: ``with span("engine.karp", batch=B): ...``.

    Disabled (the default) this returns a shared no-op context manager;
    the whole call costs one flag read."""
    if not _STATE.enabled:
        return _NOOP
    return Span(name, attrs)


def span_fn(name: str) -> Callable[[Callable], Callable]:
    """Decorator form: time every call of the wrapped function under
    ``name``.  The disabled path is a single flag check before a plain
    call — safe to leave on engine entry points permanently."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not _STATE.enabled:
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def enable(capture: bool = True) -> None:
    """Turn span recording on.  ``capture=False`` keeps only the
    aggregate table (skips the per-span ring — for long runs)."""
    _STATE.capture = capture
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Clear the aggregate table and the capture ring (not the flag)."""
    with _LOCK:
        _AGG.clear()
        _FINISHED.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """``{name: {count, total_s, max_s, mean_s}}`` for all finished
    spans since the last :func:`reset`."""
    with _LOCK:
        return {
            name: {
                "count": int(c),
                "total_s": t,
                "max_s": m,
                "mean_s": t / c if c else 0.0,
            }
            for name, (c, t, m) in sorted(_AGG.items())
        }


def pop_finished() -> List[SpanRecord]:
    """Drain and return the captured span ring (oldest first)."""
    with _LOCK:
        out = list(_FINISHED)
        _FINISHED.clear()
    return out
