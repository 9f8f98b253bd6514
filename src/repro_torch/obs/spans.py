"""Nested wall-clock spans with a near-zero-cost disabled path (a copy of
the reference's ``repro/obs/spans.py``, with device spans and profiler
ranges added).

Every engine entry point, designer call, controller actuation, train
round and the layers of a train step can open a :func:`span`, and the
resulting tree of timed intervals answers "where did this round's wall
clock go?" without a profiler attached.

Design constraints (held by ``tests/test_torch_obs.py``):

* **Default off, near-zero cost.**  ``span()`` and ``device_span()``
  with tracing disabled return a shared no-op context manager — one
  module-global flag read and no allocation.  :func:`span_fn` wrappers
  fall through to the wrapped function on the same flag.
* **Host clock, and device time only where asked.**  A :func:`span`
  reads ``time.perf_counter()`` and nothing else: it never synchronises
  and never reads a tensor.  Kernel launches are asynchronous, so a span
  around a call that only queues kernels measures the queueing — unless
  the callee itself waits for the card (a ``.to(device)`` of pageable
  host memory, a host read of a result).  A :func:`device_span` on a
  CUDA device also records a timing ``torch.cuda.Event`` pair on the
  device's current stream around its range, and leaves the pair unread:
  its elapsed time is folded in when :func:`summary` or
  :func:`pop_finished` is read, which synchronises once, after the run
  (or, without a synchronise, for pairs the card has already passed,
  once more than ``_PENDING_MAX`` are waiting).  On the CPU it records
  host time only.  Nothing on the hot path synchronises.
* **One clock with the device trace.**  While spans are enabled and a
  ``torch.profiler`` is recording, every span also opens a
  ``torch.profiler.record_function`` range of its name, so its interval
  lies on the profiler's timeline beside the kernels.  With the
  profiler off nothing more is done; with spans off nothing at all.
* **Host entry points only.**  Spans go on Python code that launches
  work (the numpy engines, the designers, the controller, the train
  round and the step's silo loop, optimizer calls and mix), never inside
  an ``autograd.Function`` body or one that is or may become a captured
  CUDA graph: a graph replays its kernels without running the Python
  that opened the span.
* **Thread-local nesting.**  The active span stack is per-thread, so
  concurrent controllers cannot corrupt each other's parentage.
* **Stdlib only at import.**  ``torch`` is read from ``sys.modules`` when
  a span needs it and never imported here.

Aggregation is always on while enabled: finished spans fold into a
process-local ``{name: (count, total_s, max_s)}`` table, device spans
also into device columns, read by :func:`summary` (what the flight
recorder embeds in its ``run_end`` record).  The full span stream (with
parent/depth, and a device span's ``device_s``) is kept in a bounded
ring for tests and ad-hoc inspection via :func:`pop_finished`.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "Span",
    "SpanRecord",
    "device_span",
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
# name -> [count, total_s, max_s] (+ [device count, device total_s, device
# max_s] once a device span of the name is read); folded under _LOCK.
_AGG: Dict[str, List[float]] = {}
_CAPTURE_MAX = 4096
_FINISHED: Deque["SpanRecord"] = deque(maxlen=_CAPTURE_MAX)
# device spans whose event pair is not read yet: (name, record or None,
# start event, end event), oldest first
_PENDING: List[Tuple[str, Optional["SpanRecord"], Any, Any]] = []
_PENDING_MAX = 1024


@dataclass(frozen=True)
class SpanRecord:
    """One finished span, as folded into the capture ring."""

    name: str
    parent: Optional[str]
    depth: int
    t_start_s: float  # perf_counter timestamp at entry
    duration_s: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    device_s: Optional[float] = None  # a device span's CUDA-event time, once read


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


def _torch() -> Any:
    """The torch module if something already imported it."""
    return sys.modules.get("torch")


class Span:
    """A live (enabled-path) span.  Use via :func:`span`, not directly."""

    __slots__ = ("name", "attrs", "parent", "depth", "_t0", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[str] = None
        self.depth = 0
        self._t0 = 0.0
        self._range = None

    def set(self, **attrs: Any) -> None:
        """Attach attributes to the span (recorded at exit)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].name
            self.depth = len(stack)
        stack.append(self)
        torch = _torch()
        if torch is not None and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # misnested exit: drop down to this span
            while stack and stack.pop() is not self:
                pass
        with _LOCK:
            self._fold(dur)
        return False

    def _fold(self, dur: float) -> Optional[SpanRecord]:
        """Fold the finished span into the table and the ring (under
        ``_LOCK``); returns its ring record."""
        agg = _AGG.get(self.name)
        if agg is None:
            _AGG[self.name] = [1.0, dur, dur]
        else:
            agg[0] += 1.0
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
        if not _STATE.capture:
            return None
        rec = SpanRecord(name=self.name, parent=self.parent, depth=self.depth,
                         t_start_s=self._t0, duration_s=dur, attrs=dict(self.attrs))
        _FINISHED.append(rec)
        return rec


class DeviceSpan(Span):
    """A :class:`Span` that also brackets its range on a CUDA stream with a
    timing event pair, read later (:func:`device_span`)."""

    __slots__ = ("_stream", "_events")

    def __init__(self, name: str, attrs: Dict[str, Any], stream: Any):
        super().__init__(name, attrs)
        self._stream = stream
        self._events = None

    def __enter__(self) -> "DeviceSpan":
        super().__enter__()
        cuda = _torch().cuda
        self._events = (cuda.Event(enable_timing=True), cuda.Event(enable_timing=True))
        self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc: Any) -> bool:
        self._events[1].record(self._stream)
        return super().__exit__(*exc)

    def _fold(self, dur: float) -> Optional[SpanRecord]:
        rec = super()._fold(dur)
        _PENDING.append((self.name, rec, *self._events))
        if len(_PENDING) > _PENDING_MAX:
            _read_device(wait=False)
        return rec


def _read_device(wait: bool) -> None:
    """Fold the pending device spans' event times into the table and their
    ring records (under ``_LOCK``).  ``wait``: wait for the card first;
    else fold only the oldest pairs the card has already passed."""
    if not _PENDING:
        return
    done = len(_PENDING)
    if wait:
        for _, _, _, end in _PENDING:
            end.synchronize()
    else:
        done = next((k for k, p in enumerate(_PENDING) if not p[3].query()), done)
    device_s = {}
    for name, rec, start, end in _PENDING[:done]:
        sec = start.elapsed_time(end) / 1e3
        agg = _AGG[name]
        if len(agg) == 3:
            agg += [1.0, sec, sec]
        else:
            agg[3] += 1.0
            agg[4] += sec
            agg[5] = max(agg[5], sec)
        if rec is not None:
            device_s[id(rec)] = sec
    del _PENDING[:done]
    if device_s:
        ring = [dataclasses.replace(r, device_s=device_s[id(r)]) if id(r) in device_s else r
                for r in _FINISHED]
        _FINISHED.clear()
        _FINISHED.extend(ring)


def span(name: str, **attrs: Any):
    """Open a named span: ``with span("engine.karp", batch=B): ...``.

    Disabled (the default) this returns a shared no-op context manager;
    the whole call costs one flag read."""
    if not _STATE.enabled:
        return _NOOP
    return Span(name, attrs)


def device_span(name: str, device: Any = None, **attrs: Any):
    """Open a span that also times its range on ``device``'s current CUDA
    stream: ``with device_span("step.mix", params.device): ...``.

    Disabled it is the shared no-op of :func:`span`; ``device`` None or
    not a CUDA device records host time only.  The event pair is read
    when :func:`summary` or :func:`pop_finished` is, never at exit."""
    if not _STATE.enabled:
        return _NOOP
    if getattr(device, "type", None) != "cuda":
        return Span(name, attrs)
    return DeviceSpan(name, attrs, _torch().cuda.current_stream(device))


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
    """Clear the aggregate table, the capture ring and the unread device
    spans (not the flag)."""
    with _LOCK:
        _AGG.clear()
        _FINISHED.clear()
        _PENDING.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """``{name: {count, total_s, max_s, mean_s}}`` for all finished
    spans since the last :func:`reset`; a device span's name adds
    ``device_count``, ``device_total_s``, ``device_max_s`` and
    ``device_mean_s`` of its CUDA-event times (read here, after one wait
    for the card)."""
    with _LOCK:
        _read_device(wait=True)
        out = {}
        for name, agg in sorted(_AGG.items()):
            c, t, m = agg[:3]
            out[name] = {"count": int(c), "total_s": t, "max_s": m,
                         "mean_s": t / c if c else 0.0}
            if len(agg) > 3:
                dc, dt, dm = agg[3:]
                out[name].update(device_count=int(dc), device_total_s=dt, device_max_s=dm,
                                 device_mean_s=dt / dc)
        return out


def pop_finished() -> List[SpanRecord]:
    """Drain and return the captured span ring (oldest first), each device
    span's ``device_s`` read (after one wait for the card)."""
    with _LOCK:
        _read_device(wait=True)
        out = list(_FINISHED)
        _FINISHED.clear()
    return out
