"""The program's spans in a run of a training cell: turned on at the
window's first round, read after the window into the run's record, and
the device's idle time in the named round split by the program span open
on the host over it.

``start()`` resets and turns on ``repro_torch.obs.spans`` with its ring;
``stop()`` reads the ring after the window (one wait for the card, for
the device spans' events) and returns what the readers in
``portbench/metrics/`` take:

* ``round_spans``: per window round in order (one ``step`` span each),
  the host seconds of its ``step.local`` spans and the CUDA-event
  seconds of its ``step.optimizer`` and ``step.mix`` spans (None without
  device time);
* ``control_spans``: each ``train.control`` span's seconds, and whether a
  ``controller.redesign`` ran inside it;
* ``migrate_spans_s``: each ``train.migrate`` span's seconds.

``idle_split(*profile_intervals(named))`` reads a ``torch.profiler``
window that traced the host and the card while spans were on, from the
profiler's start to its stop. A program without these spans gives empty
lists, and the readers then return None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple

# names of the program's spans (the profiler ranges they open)
PROGRAM_PREFIXES = ("step.", "train.", "controller.", "designer.", "engine.")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def is_program_span(name: str) -> bool:
    return name == "step" or name.startswith(PROGRAM_PREFIXES)


def _tracer():
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans


def start() -> None:
    """Clear the program's spans and turn them on, ring and all."""
    sp = _tracer()
    if sp is not None:
        sp.reset()
        sp.enable(capture=True)


def stop() -> Dict[str, Any]:
    """Turn the program's spans off and return what the window recorded
    (:func:`window_record`); empty when they were never on."""
    sp = _tracer()
    if sp is None or not sp.enabled():
        return {}
    records, summary = sp.pop_finished(), sp.summary()
    sp.disable()
    sp.reset()
    return window_record(records, summary)


def _within(inner, outer) -> bool:
    return (outer.t_start_s <= inner.t_start_s and
            inner.t_start_s + inner.duration_s <= outer.t_start_s + outer.duration_s)


def _device_total(records) -> Optional[float]:
    times = [r.device_s for r in records]
    return None if any(t is None for t in times) else sum(times)


def window_record(records: Sequence[Any], summary: Dict[str, Dict[str, float]]
                  ) -> Dict[str, Any]:
    """The readers' lists from finished span records (``SpanRecord``s) and
    the span table; empty when the ring dropped records (its count of a
    name falls short of the table's)."""
    if any(sum(r.name == name for r in records) != s["count"] for name, s in summary.items()):
        return {}
    steps = sorted((r for r in records if r.name == "step"), key=lambda r: r.t_start_s)
    rounds = []
    for st in steps:
        inner = [r for r in records if r.name.startswith("step.") and _within(r, st)]
        rounds.append({
            "local_s": sum(r.duration_s for r in inner if r.name == "step.local"),
            "optimizer_s": _device_total([r for r in inner if r.name == "step.optimizer"]),
            "mix_s": _device_total([r for r in inner if r.name == "step.mix"]),
        })
    redesigns = [r for r in records if r.name == "controller.redesign"]
    control = [{"s": c.duration_s, "redesign": any(_within(r, c) for r in redesigns)}
               for c in records if c.name == "train.control"]
    return {"round_spans": rounds, "control_spans": control,
            "migrate_spans_s": [r.duration_s for r in records if r.name == "train.migrate"]}


def per_round_ms(rec: Dict[str, Any], key: str) -> Optional[float]:
    """Mean of ``key`` over the window's unprofiled rounds, in ms; None
    without spans or where a round has no such time."""
    rounds = rec.get("round_spans")
    if not rounds:
        return None
    skip = set(rec.get("profiled", ()))
    vals = [r[key] for k, r in enumerate(rounds) if k not in skip]
    if not vals or any(v is None for v in vals):
        return None
    return 1e3 * sum(vals) / len(vals)


def profile_intervals(prof) -> Tuple[List[Tuple[float, float]], List[Tuple[float, float, str]],
                                     Tuple[float, float]]:
    """A finished profiler window's device activity intervals (the ranges
    that spans open on the device's timeline left out), its host events
    ``(start, end[, name])``, and the window itself ``(0, end)``, all in
    microseconds on the profiler's timeline.  That timeline starts when
    the profiler's enable call begins; the window ends at the later of the
    last event and the profiler's own start and stop stamps (the enable
    call's length plus the time from its return to the stop call), so the
    card's idle time before its first and after its last activity in the
    window is seen too."""
    device, host = [], []
    end = 0.0
    for ev in prof.events():
        tr = ev.time_range
        end = max(end, tr.end)
        if str(ev.device_type).endswith("CUDA"):
            if not getattr(ev, "is_user_annotation", False):
                device.append((tr.start, tr.end))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, ev.name))
    stamps = getattr(prof, "profiler", None)
    try:
        end = max(end, stamps._stats.profiler_enable_call_duration_us
                  + (stamps.profiling_end_time_ns - stamps.profiling_start_time_ns) / 1e3)
    except (AttributeError, TypeError):
        pass
    return device, host, (0.0, end)


def profiler_stop_s(prof) -> Optional[float]:
    """Seconds the profiler's stop call took (collecting the card's
    activity records), where the profiler kept that stamp."""
    try:
        return prof.profiler._stats.profiler_disable_call_duration_us / 1e6
    except AttributeError:
        return None


def _innermost(spans: Sequence[Tuple[float, float, str]], at: float) -> Optional[str]:
    open_ = [(e - s, n) for s, e, n in spans if s <= at < e]
    return min(open_)[1] if open_ else None


def _is_runtime_call(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def idle_split(device: Sequence[Tuple[float, float]], host: Sequence[Tuple[float, float, str]],
               window: Optional[Tuple[float, float]] = None) -> Dict[str, Any]:
    """The device's idle time in ``window`` (without one, between its
    first and last activity), cut at the boundaries of the program's spans
    on the host, each piece named by the innermost program span open over
    it ("no span" where none was; a span that opened before the profiler
    started or closed after it stopped is not in its trace):

    * ``window_s``, ``idle_s``; ``edges_s``, the idle time before the
      card's first and after its last activity in the window;
    * ``outside_step_s``, the idle time while no ``step`` range was open,
      and ``step_s``, the host time inside ``step`` ranges (so
      ``window_s - step_s`` bounds ``outside_step_s``);
    * ``by_span``: idle seconds by span;
    * ``syncs``: the host's synchronising calls by the innermost program
      span around each, ``[count, seconds]``;
    * ``runtime``: every CUDA runtime or driver call (launches, copies,
      allocations, syncs) by the innermost program span around it,
      ``[count, seconds, seconds in calls of 100 us or more]``: where the
      host waits on the card (a full launch queue, an allocation) rather
      than queues work.

    Intervals in microseconds, results in seconds."""
    merged: List[List[float]] = []
    for s, e in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    if window is None:
        window = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    lo, hi = window
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    if merged:
        edges = max(0.0, min(merged[0][0], hi) - lo) + max(0.0, hi - max(merged[-1][1], lo))
    else:
        edges = hi - lo

    spans = [h for h in host if is_program_span(h[2])]
    steps = [(s, e) for s, e, n in spans if n == "step"]
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    idle = outside = 0.0
    by_span: Dict[str, float] = {}
    for a, b in gaps:
        idle += b - a
        points = [a] + cuts[bisect_right(cuts, a):bisect_left(cuts, b)] + [b]
        for p, q in zip(points, points[1:]):
            if not any(s <= p < e for s, e in steps):
                outside += q - p
            name = _innermost(spans, p) or "no span"
            by_span[name] = by_span.get(name, 0.0) + (q - p) / 1e6
    syncs: Dict[str, List[float]] = {}
    runtime: Dict[str, List[float]] = {}
    for s, e, n in host:
        if not _is_runtime_call(n):
            continue
        where = _innermost(spans, s) or "no span"
        row = runtime.setdefault(where, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e6
        if e - s >= 100:
            row[2] += (e - s) / 1e6
        if n in SYNC_CALLS:
            sync = syncs.setdefault(where, [0, 0.0])
            sync[0] += 1
            sync[1] += (e - s) / 1e6
    return {"window_s": (hi - lo) / 1e6, "idle_s": idle / 1e6, "edges_s": edges / 1e6,
            "outside_step_s": outside / 1e6,
            "step_s": sum(min(e, hi) - max(s, lo) for s, e in steps) / 1e6,
            "by_span": by_span, "syncs": syncs, "runtime": runtime}
