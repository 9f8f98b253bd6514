"""Render a flight-recorder trace: timeline, bottlenecks, diffs (a copy of
the reference's ``repro/obs/report.py``, whose output it matches line for
line on the same trace; either package's report reads either package's
traces).

Consumes the JSONL traces written by
:class:`repro_torch.obs.events.FlightRecorder` (``train --trace-out``):

* :func:`render_timeline`    — epochs × redesigns × round-time profile:
  when the network changed, when the controller noticed, what it chose,
  and how the realized round time moved between actuations;
* :func:`render_bottlenecks` — bottleneck attribution: the critical
  circuits the controller blamed, by silo name, with the τ they priced;
* :func:`diff_traces`        — two runs side by side (record counts,
  redesign behaviour, round-time deltas);
* :func:`check_trace`        — schema validation (what
  ``scripts/obs_report.py --check`` runs).

Everything returns plain strings.  The run header keeps the reference's
``jax=`` field, so the two packages print the same text: a trace of the
port carries ``torch_version`` / ``cuda_version`` instead and shows
``jax=?``, with the card's name under ``device=``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .events import read_trace, validate_trace

__all__ = [
    "Trace",
    "check_trace",
    "diff_traces",
    "load_trace",
    "render_bottlenecks",
    "render_report",
    "render_timeline",
]


class Trace:
    """A parsed trace with a by-kind index and the run metadata."""

    def __init__(self, records: List[Dict[str, Any]], path: str = ""):
        self.path = path
        self.records = records
        self.by_kind: Dict[str, List[Dict[str, Any]]] = {}
        for rec in records:
            self.by_kind.setdefault(rec.get("kind", "?"), []).append(rec)
        starts = self.by_kind.get("run_start", [])
        self.meta: Dict[str, Any] = starts[0].get("meta", {}) if starts else {}

    @property
    def silo_names(self) -> Optional[List[str]]:
        names = self.meta.get("silo_names")
        return list(names) if names else None

    def kind(self, kind: str) -> List[Dict[str, Any]]:
        return self.by_kind.get(kind, [])


def load_trace(path: str) -> Trace:
    return Trace(read_trace(path), path=path)


def check_trace(path: str) -> Tuple[bool, List[str]]:
    """(ok, human lines).  ok is False on any schema problem."""
    records, problems = validate_trace(path)
    lines = [f"{path}: {len(records)} record(s), "
             f"{len(problems)} problem(s)"]
    lines.extend(f"  {p}" for p in problems)
    if not problems:
        kinds = {}
        for rec in records:
            kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        lines.append("  " + ", ".join(f"{k}={n}"
                                      for k, n in sorted(kinds.items())))
    return not problems, lines


# ---------------------------------------------------------------------------
# Rendering helpers
# ---------------------------------------------------------------------------

def _name_of(trace: Trace, label: Any) -> str:
    names = trace.silo_names
    try:
        i = int(label)
    except (TypeError, ValueError):
        return str(label)
    if names and 0 <= i < len(names):
        return names[i]
    return str(label)


def _circuit_str(trace: Trace, rec: Dict[str, Any]) -> str:
    names = rec.get("bottleneck_names") or [
        _name_of(trace, s) for s in rec.get("bottleneck", ())]
    return "-".join(str(n) for n in names) if names else "(none)"


def _fmt_ms(v: Any) -> str:
    return f"{v:8.1f}" if isinstance(v, (int, float)) else f"{'—':>8s}"


def _table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    out.append("  ".join("-" * w for w in widths))
    for row in rows:
        out.append("  ".join(c.ljust(w)
                             for c, w in zip(row, widths)).rstrip())
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Timeline
# ---------------------------------------------------------------------------

def render_timeline(trace: Trace) -> str:
    """Epochs × redesigns × round-time profile, as three stacked tables."""
    meta = trace.meta
    lines: List[str] = []
    lines.append(
        f"run: rev={meta.get('git_rev', '?')} "
        f"jax={meta.get('jax_version', '?')} "
        f"device={meta.get('device_kind', '?')} "
        f"schema=v{meta.get('schema_version', '?')}")
    argv = meta.get("argv")
    if argv:
        lines.append("cmd: " + " ".join(str(a) for a in argv))

    epochs = trace.kind("epoch")
    if epochs:
        lines.append("")
        lines.append("network epochs:")
        rows = []
        for e in epochs:
            active = e.get("active", [])
            rows.append([
                str(e.get("index", "?")),
                f"{e.get('t_start_ms', 0) / 1e3:9.1f}",
                str(len(active)),
                ",".join(_name_of(trace, s) for s in active[:8])
                + ("…" if len(active) > 8 else ""),
            ])
        lines.append(_table(["epoch", "t_start_s", "n_act", "active"], rows))

    redesigns = trace.kind("redesign")
    if redesigns:
        lines.append("")
        lines.append("controller actuations:")
        rows = []
        for r in redesigns:
            drift = r.get("drift")
            rows.append([
                str(r.get("round_idx", "?")),
                str(r.get("winner", "?")),
                str(r.get("name", "?")),
                _fmt_ms(r.get("measured_ms")).strip(),
                _fmt_ms(r.get("predicted_tau_ms")).strip(),
                f"{drift:.3f}" if isinstance(drift, (int, float)) else "—",
                str(r.get("n_candidates", "?")),
                f"{1e3 * r.get('elapsed_s', 0):.0f}",
                "yes" if r.get("membership") else "",
            ])
        lines.append(_table(
            ["round", "winner", "plan", "meas_ms", "pred_ms", "drift",
             "cands", "design_ms", "churn"], rows))

    rounds = trace.kind("round")
    if rounds:
        lines.append("")
        lines.append("round-time profile (between actuations):")
        bounds = sorted(r.get("round_idx", 0) for r in redesigns)
        segments: Dict[int, List[Dict[str, Any]]] = {}
        for rec in rounds:
            step = rec.get("step", 0)
            seg = sum(1 for b in bounds if step >= b)
            segments.setdefault(seg, []).append(rec)
        rows = []
        for seg in sorted(segments):
            recs = segments[seg]
            durs = [r["duration_ms"] for r in recs
                    if isinstance(r.get("duration_ms"), (int, float))]
            drifts = [r["drift"] for r in recs
                      if isinstance(r.get("drift"), (int, float))]
            rows.append([
                f"{seg}",
                f"{recs[0].get('step', '?')}..{recs[-1].get('step', '?')}",
                str(len(recs)),
                f"{sum(durs) / len(durs):.1f}" if durs else "—",
                f"{max(durs):.1f}" if durs else "—",
                f"{max(drifts):.3f}" if drifts else "—",
            ])
        lines.append(_table(
            ["segment", "steps", "samples", "mean_ms", "max_ms",
             "max_drift"], rows))

    ends = trace.kind("run_end")
    if ends:
        spans = ends[-1].get("spans") or {}
        if spans:
            lines.append("")
            lines.append("span summary (host wall clock):")
            rows = [[name, str(s.get("count", 0)),
                     f"{1e3 * s.get('total_s', 0):.1f}",
                     f"{1e3 * s.get('mean_s', 0):.2f}",
                     f"{1e3 * s.get('max_s', 0):.2f}"]
                    for name, s in sorted(spans.items())]
            lines.append(_table(
                ["span", "count", "total_ms", "mean_ms", "max_ms"], rows))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Bottleneck attribution
# ---------------------------------------------------------------------------

def render_bottlenecks(trace: Trace) -> str:
    """Critical circuits the controller blamed, aggregated by circuit."""
    redesigns = trace.kind("redesign")
    if not redesigns:
        return "bottleneck attribution: no redesign records"
    agg: Dict[str, Dict[str, Any]] = {}
    for r in redesigns:
        circ = _circuit_str(trace, r)
        slot = agg.setdefault(circ, {"count": 0, "taus": [],
                                     "rounds": [], "plans": set()})
        slot["count"] += 1
        tau = r.get("predicted_tau_ms")
        if isinstance(tau, (int, float)):
            slot["taus"].append(tau)
        slot["rounds"].append(r.get("round_idx"))
        slot["plans"].add(str(r.get("name")))
    rows = []
    for circ, s in sorted(agg.items(), key=lambda kv: -kv[1]["count"]):
        taus = s["taus"]
        rows.append([
            circ,
            str(s["count"]),
            f"{min(taus):.1f}" if taus else "—",
            ",".join(str(r) for r in s["rounds"]),
            ",".join(sorted(s["plans"])),
        ])
    return ("bottleneck attribution (critical circuits of chosen "
            "plans):\n" + _table(
                ["circuit", "hits", "tau_ms", "rounds", "plans"], rows))


def render_report(trace: Trace) -> str:
    return render_timeline(trace) + "\n\n" + render_bottlenecks(trace)


# ---------------------------------------------------------------------------
# Diff
# ---------------------------------------------------------------------------

def _round_stats(trace: Trace) -> Tuple[int, float]:
    rounds = trace.kind("round")
    durs = [r["duration_ms"] for r in rounds
            if isinstance(r.get("duration_ms"), (int, float))]
    return len(durs), (sum(durs) / len(durs) if durs else float("nan"))


def diff_traces(a: Trace, b: Trace) -> str:
    """Two runs side by side: counts per record kind, redesign
    behaviour, mean round time, final predicted τ."""
    lines = [f"diff: A={a.path or '<a>'}  B={b.path or '<b>'}"]
    rows = []
    for kind in sorted(set(a.by_kind) | set(b.by_kind)):
        na, nb = len(a.kind(kind)), len(b.kind(kind))
        rows.append([kind, str(na), str(nb),
                     "" if na == nb else f"{nb - na:+d}"])
    lines.append(_table(["kind", "A", "B", "delta"], rows))

    def final_tau(t: Trace) -> Optional[float]:
        rd = t.kind("redesign")
        if rd and isinstance(rd[-1].get("predicted_tau_ms"), (int, float)):
            return rd[-1]["predicted_tau_ms"]
        return None

    na, ma = _round_stats(a)
    nb, mb = _round_stats(b)
    rows = []
    if na and nb:
        rows.append(["mean round ms", f"{ma:.1f}", f"{mb:.1f}",
                     f"{mb - ma:+.1f}"])
    ta, tb = final_tau(a), final_tau(b)
    if ta is not None and tb is not None:
        rows.append(["final predicted tau ms", f"{ta:.1f}", f"{tb:.1f}",
                     f"{tb - ta:+.1f}"])
    ca = [_circuit_str(a, r) for r in a.kind("redesign")]
    cb = [_circuit_str(b, r) for r in b.kind("redesign")]
    if ca or cb:
        rows.append(["bottleneck circuits", ";".join(ca) or "—",
                     ";".join(cb) or "—",
                     "same" if ca == cb else "DIFFER"])
    if rows:
        lines.append("")
        lines.append(_table(["metric", "A", "B", "delta"], rows))
    if a.by_kind == b.by_kind and ca == cb:
        lines.append("")
        lines.append("traces are structurally identical")
    return "\n".join(lines)
