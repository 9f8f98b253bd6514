"""Observability for the port's control loop: spans, metrics, events,
logs (the reference's ``repro.obs``, with the same names, schema and
record kinds).

* :mod:`~repro_torch.obs.spans`   — nested host wall-clock spans over
  *host-level* entry points (engine calls, designer searches, redesigns,
  train steps).  Default off; the disabled path is one flag read.  A span
  never synchronises with the card: around a call that only queues
  kernels it measures the queueing.
* :mod:`~repro_torch.obs.metrics` — process-local counters / gauges /
  histograms (redesign count & latency, candidate throughput, slot
  versions, train-step builds, predicted-vs-measured drift, h→d bytes).
* :mod:`~repro_torch.obs.events`  — the JSONL flight recorder: every
  controller decision, epoch transition, membership change and hot-swap
  as one schema-versioned record (``repro_torch.launch.train
  --trace-out``).
* :mod:`~repro_torch.obs.log`     — structured progress logging (stderr
  human format + optional JSONL).

:mod:`~repro_torch.obs.report` renders a trace into a timeline and a
bottleneck-attribution table and diffs two traces.  The package is
stdlib-only and imports nothing else of the port, nor the reference's
package — so any module can instrument itself without dependency
cycles.  Instrumentation stays on host entry points, outside any body
that is or may become a captured CUDA graph.
"""

from .spans import (
    Span,
    SpanRecord,
    disable,
    enable,
    enabled,
    pop_finished,
    span,
    span_fn,
    summary,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    gauge,
    histogram,
)
from .events import (
    FlightRecorder,
    SCHEMA,
    TRACE_SCHEMA_VERSION,
    read_trace,
    run_metadata,
    validate_record,
    validate_trace,
)
from .log import StructuredLogger, get_logger, set_global_jsonl

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "SCHEMA",
    "Span",
    "SpanRecord",
    "StructuredLogger",
    "TRACE_SCHEMA_VERSION",
    "counter",
    "disable",
    "enable",
    "enabled",
    "gauge",
    "get_logger",
    "histogram",
    "pop_finished",
    "read_trace",
    "run_metadata",
    "set_global_jsonl",
    "span",
    "span_fn",
    "summary",
    "validate_record",
    "validate_trace",
]
