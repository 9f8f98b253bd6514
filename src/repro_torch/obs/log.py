"""Structured logging: human-readable stderr lines + optional JSONL (a
copy of the reference's ``repro/obs/log.py``).

Each call names an *event* and attaches key=value fields; the human
rendering is one aligned line on stderr, the structured rendering (when
a JSONL path is configured) is one JSON object per line sharing the
field names — grep-able and machine-joinable with the flight-recorder
trace.

Deliberately *not* stdlib ``logging``: no handler graphs, no global
config mutation from library code, no formatter classes.  A logger is
a named object with a level, a stream and an optional JSONL sink.
Fields are host values: a CUDA tensor raises, as in the flight recorder.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, IO, Optional

__all__ = ["StructuredLogger", "get_logger", "set_global_jsonl"]

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class StructuredLogger:
    """One named logger.  See module docstring."""

    def __init__(self, name: str, *, level: str = "info",
                 stream: Optional[IO[str]] = None,
                 jsonl_path: Optional[str] = None):
        self.name = name
        self.level = level
        self._stream = stream
        self._jsonl_path = jsonl_path
        self._jsonl_fh: Optional[IO[str]] = None
        self._lock = threading.Lock()

    # -- config --------------------------------------------------------

    @property
    def stream(self) -> IO[str]:
        return self._stream if self._stream is not None else sys.stderr

    def set_jsonl(self, path: Optional[str]) -> None:
        """Attach (or detach, with None) a JSONL sink."""
        with self._lock:
            if self._jsonl_fh is not None:
                self._jsonl_fh.close()
                self._jsonl_fh = None
            self._jsonl_path = path

    # -- emission ------------------------------------------------------

    def log(self, level: str, event: str, msg: str = "",
            **fields: Any) -> None:
        if _LEVELS.get(level, 20) < _LEVELS.get(self.level, 20):
            return
        parts = [f"[{self.name}] {event}"]
        if msg:
            parts.append(msg)
        parts.extend(f"{k}={_fmt(v)}" for k, v in fields.items())
        line = " ".join(parts)
        with self._lock:
            print(line, file=self.stream, flush=True)
            if self._jsonl_path is not None:
                if self._jsonl_fh is None:
                    self._jsonl_fh = open(self._jsonl_path, "a",
                                          encoding="utf-8")
                rec = {"t_unix": time.time(), "logger": self.name,
                       "level": level, "event": event}
                if msg:
                    rec["msg"] = msg
                rec.update(fields)
                self._jsonl_fh.write(
                    json.dumps(rec, default=_default) + "\n")
                self._jsonl_fh.flush()

    def debug(self, event: str, msg: str = "", **fields: Any) -> None:
        self.log("debug", event, msg, **fields)

    def info(self, event: str, msg: str = "", **fields: Any) -> None:
        self.log("info", event, msg, **fields)

    def warn(self, event: str, msg: str = "", **fields: Any) -> None:
        self.log("warn", event, msg, **fields)

    def error(self, event: str, msg: str = "", **fields: Any) -> None:
        self.log("error", event, msg, **fields)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _default(o: Any) -> Any:
    if getattr(o, "is_cuda", False):
        raise TypeError("a CUDA tensor in a log field; convert it on the host first")
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


_REGISTRY: Dict[str, StructuredLogger] = {}
_REGISTRY_LOCK = threading.Lock()


def get_logger(name: str, **kwargs: Any) -> StructuredLogger:
    """Get-or-create the named logger (kwargs apply on first creation)."""
    lg = _REGISTRY.get(name)
    if lg is None:
        with _REGISTRY_LOCK:
            lg = _REGISTRY.get(name)
            if lg is None:
                lg = _REGISTRY[name] = StructuredLogger(name, **kwargs)
    return lg


def set_global_jsonl(path: Optional[str]) -> None:
    """Route every existing logger's structured stream to ``path``."""
    with _REGISTRY_LOCK:
        for lg in _REGISTRY.values():
            lg.set_jsonl(path)
