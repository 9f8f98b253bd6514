"""Process-local metrics registry: counters, gauges, histograms (a copy
of the reference's ``repro/obs/metrics.py``).

One flat namespace of named metrics, read out as a JSON-able snapshot
(embedded in the flight recorder's ``metrics``/``run_end`` records and
asserted in tests).  This is deliberately *not* a Prometheus client:
the controller/training loop is single-process, the consumers are the
trace report and the test suite, and the whole point is zero external
dependencies.

Metric kinds:

* :class:`Counter`   — monotonically increasing (redesign count,
  recompile count, host→device bytes, rounds observed);
* :class:`Gauge`     — last-write-wins scalar (slot versions, current
  predicted τ, predicted-vs-measured drift);
* :class:`Histogram` — summary statistics over observed values
  (redesign latency, per-round duration, candidate throughput), with
  count/sum/min/max plus percentile estimates over a bounded ring of
  the most recent observations.

All update paths are O(1), allocation-free after the first observation,
and guarded by one registry lock only at metric *creation*; updates
rely on CPython attribute-assignment atomicity, which is sufficient for
the single-writer control loop (and harmless for concurrent readers —
a snapshot may be one observation stale, never torn across a metric).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
]


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> float:
        return self.value


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming summary + bounded reservoir of recent observations.

    Percentiles are computed over the last ``sample_max`` observations
    (a sliding window, not a uniform reservoir) — the control loop cares
    about *recent* round-time behaviour, and the exact stream is in the
    flight recorder anyway."""

    __slots__ = ("name", "count", "sum", "min", "max", "_sample",
                 "_sample_max", "_i")

    def __init__(self, name: str, sample_max: int = 512):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._sample: List[float] = []
        self._sample_max = sample_max
        self._i = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._sample) < self._sample_max:
            self._sample.append(v)
        else:  # overwrite oldest: ring over the most recent window
            self._sample[self._i] = v
            self._i = (self._i + 1) % self._sample_max

    def quantile(self, q: float) -> float:
        if not self._sample:
            return float("nan")
        s = sorted(self._sample)
        k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[k]

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
        }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metrics with get-or-create semantics.

    ``counter("a.b")`` returns the same object on every call; asking
    for an existing name with a different kind raises — a metric's
    meaning must not silently change across call sites."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"requested as {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"requested as {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)  # type: ignore[return-value]

    def snapshot(self) -> Dict[str, object]:
        """JSON-able ``{name: value-or-summary}`` of every metric."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Drop every registered metric (tests; run boundaries)."""
        with self._lock:
            self._metrics.clear()


#: The process-local default registry used by all instrumentation.
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
