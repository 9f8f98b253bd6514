"""Structured JSONL flight recorder for the control loop (a copy of the
reference's ``repro/obs/events.py``).

Every consequential decision of the closed loop — a regression
detected, candidates priced, a plan chosen and hot-swapped, a
membership change, a dynamics epoch transition — is appended to a
trace file as one JSON object per line.  The trace can be replayed,
diffed against another run, and rendered into a timeline /
bottleneck-attribution report (:mod:`repro_torch.obs.report`,
``scripts/obs_report.py``).

Record envelope (every line)::

    {"v": <schema version>, "seq": <0,1,2,...>, "t_s": <seconds since
     run start>, "kind": <record kind>, ...payload...}

Record kinds and their required payload fields are declared in
:data:`SCHEMA`; extra fields are allowed (forward compatibility), and
missing required fields fail both at emission time and in
:func:`validate_trace`.  :data:`SCHEMA`, the envelope and
:data:`TRACE_SCHEMA_VERSION` are the reference's, so each package's
validator and report read the other's traces.  The schema version moves
only on *breaking* changes — removing or renaming a required field,
changing a field's meaning; adding record kinds or optional fields keeps
the version.

Payloads are host values.  :func:`_jsonable` converts numpy scalars and
arrays and CPU tensors through ``.tolist()``, and refuses a CUDA tensor:
``.tolist()`` there would hide a device synchronise inside :meth:`emit`,
so every emit site converts its values on the host first.

This module is stdlib-only by design: it is importable from anywhere in
the port without dependency cycles, and :func:`run_metadata` never
initialises CUDA.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Dict, IO, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "FlightRecorder",
    "SCHEMA",
    "TRACE_SCHEMA_VERSION",
    "read_trace",
    "run_metadata",
    "validate_record",
    "validate_trace",
]

#: Bump only on breaking changes to required fields (see module doc).
TRACE_SCHEMA_VERSION = 1

#: kind -> required payload fields (the envelope is implicit).
SCHEMA: Dict[str, Tuple[str, ...]] = {
    # run lifecycle
    "run_start": ("meta",),
    "run_end": ("metrics", "spans", "summary"),
    # dynamics: the network the loop is reacting to
    "epoch": ("index", "t_start_ms", "active"),
    # training loop: periodic per-round sample (cadence: --metrics-interval)
    "round": ("step", "duration_ms", "predicted_window_ms",
              "measured_window_ms", "drift"),
    # controller decisions
    "regression": ("round_idx", "measured_ms", "expected_window_ms",
                   "drift", "strikes"),
    "redesign": ("round_idx", "winner", "name", "predicted_tau_ms",
                 "measured_ms", "expected_window_ms", "drift",
                 "n_candidates", "elapsed_s", "bottleneck",
                 "bottleneck_names", "membership"),
    "membership": ("step", "version", "n_before", "n_after", "left",
                   "joined"),
    # slot hot-swaps (plan / schedule / membership versions)
    "swap": ("slot", "version", "label"),
    # periodic metrics snapshot
    "metrics": ("snapshot",),
}

_ENVELOPE = ("v", "seq", "t_s", "kind")


def _jsonable(o: Any) -> Any:
    """JSON fallback for numpy scalars/arrays, CPU tensors, sets, paths.

    A CUDA tensor raises: converting it here would synchronise with the
    card on every record."""
    if getattr(o, "is_cuda", False):
        raise TypeError(
            "a CUDA tensor in a trace payload; convert it to a host value "
            "at the emit site (.tolist() inside emit would synchronise)")
    if hasattr(o, "tolist"):  # numpy scalar or array, CPU tensor
        return o.tolist()
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return str(o)


def _git_rev(root: Optional[str] = None) -> str:
    root = root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            rev = out.stdout.strip()
            dirty = subprocess.run(
                ["git", "-C", root, "status", "--porcelain"],
                capture_output=True, text=True, timeout=5)
            if dirty.returncode == 0 and dirty.stdout.strip():
                rev += "-dirty"
            return rev
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _torch() -> Any:
    """The torch module if something already imported it (metadata
    collection imports nothing heavy of its own)."""
    return sys.modules.get("torch")


def _torch_version() -> str:
    torch = _torch()
    if torch is not None:
        return getattr(torch, "__version__", "unknown")
    try:  # metadata lookup: no import side effects
        from importlib.metadata import version

        return version("torch")
    except Exception:
        return "unknown"


def _cuda_version() -> str:
    """CUDA version torch was built for (``"none"`` for a CPU build)."""
    torch = _torch()
    if torch is None:
        return "unknown"
    try:
        return str(torch.version.cuda) if torch.version.cuda else "none"
    except Exception:
        return "unknown"


def _device_kind() -> str:
    """Name of the current CUDA device — *only* if CUDA is already
    initialised (metadata collection must never create a CUDA context)."""
    torch = _torch()
    if torch is None:
        return "uninitialized"
    try:
        if not torch.cuda.is_initialized():
            return "uninitialized"
        return torch.cuda.get_device_name()
    except Exception:
        return "unknown"


def run_metadata(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Provenance stamp of a trace: schema version, git rev (``-dirty``
    suffixed), torch and CUDA versions, device kind, python/platform,
    argv, wall time."""
    meta: Dict[str, Any] = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "git_rev": _git_rev(),
        "torch_version": _torch_version(),
        "cuda_version": _cuda_version(),
        "device_kind": _device_kind(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "time_unix": time.time(),
    }
    if extra:
        meta.update(extra)
    return meta


class FlightRecorder:
    """Append-only JSONL trace writer.

    Opens ``path``, immediately writes the ``run_start`` record (with
    :func:`run_metadata` plus any caller ``meta``), then accepts
    :meth:`emit` calls until :meth:`close` writes ``run_end`` with the
    final metrics snapshot and span summary.  Each line is flushed as
    written: a crashed run leaves a readable (if ``run_end``-less)
    trace — that is the "flight recorder" property.

    ``silo_names`` (label -> human name, e.g. Gaia site names) is
    stored in the run metadata so reports can attribute bottleneck
    circuits to sites rather than integer labels.
    """

    def __init__(self, path: str, *,
                 meta: Optional[Dict[str, Any]] = None,
                 silo_names: Optional[Sequence[str]] = None):
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "w", encoding="utf-8")
        self._seq = 0
        self._t0 = time.time()
        m = run_metadata(meta)
        if silo_names is not None:
            m["silo_names"] = [str(s) for s in silo_names]
        self.silo_names = m.get("silo_names")
        self.emit("run_start", meta=m)

    # -- core ----------------------------------------------------------

    def emit(self, kind: str, **payload: Any) -> Dict[str, Any]:
        """Append one record.  Unknown kinds and missing required
        fields raise immediately — a trace that validates at write time
        validates at read time."""
        if self._fh is None:
            raise ValueError(f"FlightRecorder({self.path}) is closed")
        required = SCHEMA.get(kind)
        if required is None:
            raise ValueError(f"unknown trace record kind {kind!r}; "
                             f"known: {sorted(SCHEMA)}")
        missing = [k for k in required if k not in payload]
        if missing:
            raise ValueError(f"{kind} record missing required "
                             f"field(s) {missing}")
        rec: Dict[str, Any] = {
            "v": TRACE_SCHEMA_VERSION,
            "seq": self._seq,
            "t_s": round(time.time() - self._t0, 6),
            "kind": kind,
        }
        rec.update(payload)
        self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
        self._fh.flush()
        self._seq += 1
        return rec

    def close(self, **summary: Any) -> None:
        """Write ``run_end`` (metrics snapshot + span summary + caller
        summary fields) and close the file.  Idempotent."""
        if self._fh is None:
            return
        self.emit("run_end", metrics=_metrics.snapshot(),
                  spans=_spans.summary(), summary=summary)
        self._fh.close()
        self._fh = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# Readers / validators
# ---------------------------------------------------------------------------

def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace into a list of record dicts (no validation)."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_record(rec: Dict[str, Any]) -> List[str]:
    """Schema problems of one record (empty list == valid)."""
    problems: List[str] = []
    for k in _ENVELOPE:
        if k not in rec:
            problems.append(f"missing envelope field {k!r}")
    kind = rec.get("kind")
    if kind is not None:
        required = SCHEMA.get(kind)
        if required is None:
            problems.append(f"unknown record kind {kind!r}")
        else:
            for k in required:
                if k not in rec:
                    problems.append(f"{kind} record missing field {k!r}")
    v = rec.get("v")
    if v is not None and v > TRACE_SCHEMA_VERSION:
        problems.append(f"schema version {v} newer than reader "
                        f"({TRACE_SCHEMA_VERSION})")
    return problems


def validate_trace(path: str) -> Tuple[List[Dict[str, Any]], List[str]]:
    """(records, problems) for a whole trace file.

    Beyond per-record schema checks: the first record must be
    ``run_start`` carrying run metadata, and ``seq`` must count
    contiguously from 0 (a gap means lost records)."""
    problems: List[str] = []
    try:
        records = read_trace(path)
    except (OSError, json.JSONDecodeError) as exc:
        return [], [f"unreadable trace: {exc}"]
    if not records:
        return [], ["empty trace"]
    if records[0].get("kind") != "run_start":
        problems.append("first record is not run_start")
    elif not isinstance(records[0].get("meta"), dict):
        problems.append("run_start carries no metadata dict")
    for i, rec in enumerate(records):
        for p in validate_record(rec):
            problems.append(f"record {i}: {p}")
        if rec.get("seq") != i:
            problems.append(f"record {i}: seq {rec.get('seq')!r} "
                            f"(expected {i})")
    return records, problems
