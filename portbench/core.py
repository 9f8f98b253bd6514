"""The harness: finds a cell's files by name, runs its entry once, reads
its metrics and prints the result line.

``BENCHMARK.json`` names the cells, their configurations and the
metrics.  For a cell ``<cell>`` the harness reads
``portbench/workloads/<cell>.json`` (the configuration's name, the entry,
the traffic and the limits of the comparison), the configuration's file
that ``BENCHMARK.json`` names, runs ``portbench/entries/<entry>.py``'s
``run(ctx)``, and for each metric the cell reports calls
``portbench/metrics/<metric>.py``'s ``read(rec)``.  A new cell,
configuration or metric is a new file.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start_s() -> float:
    """This process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (clock ticks since boot)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Context:
    """What an entry gets: the cell, its configuration and the run's
    arguments.  ``options`` carries the calibration's switches (a control
    or a planted fault); the benchmark's own runs leave it empty."""

    cell: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    options: Dict[str, Any] = field(default_factory=dict)

    @property
    def dims(self):
        from portbench.reference.model import Dims

        c = self.config
        return Dims(n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                    n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
                    d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
                    rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
                    sliding_window=c.get("sliding_window"))

    def model_config(self, **over):
        """The program's ``ModelConfig`` for this configuration, with the
        cell's execution options (``model`` in the cell's file)."""
        from repro_torch.models import ModelConfig

        d = self.dims
        kw = dict(arch_id=self.cell["config"], n_layers=d.n_layers, d_model=d.d_model,
                  n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, d_ff=d.d_ff,
                  vocab_size=d.vocab_size, rope_theta=d.rope_theta, norm_eps=d.norm_eps,
                  sliding_window=d.sliding_window)
        kw.update(self.cell.get("model", {}))
        kw.update(over)
        return ModelConfig(**kw)


def load_cell(name: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The cell's file (with its ``name``, ``config`` and ``chips`` from
    ``BENCHMARK.json``) and its configuration's file."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(ROOT / "portbench" / "workloads" / f"{name}.json")
    cell["name"] = name
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell["config"] = entry["config"]
    cell["chips"] = entry["chips"]
    return cell, load_json(ROOT / conf["file"])


def cell_metrics(name: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics the cell reports in this kind of run: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    bench = benchmark()
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if "workloads" not in m or name in m["workloads"]]


def read_metrics(name: str, rec: Dict[str, Any], trace: bool) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in cell_metrics(name, trace):
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             options: Optional[Dict[str, Any]] = None, t_start: Optional[float] = None
             ) -> Dict[str, Any]:
    """One run of a cell: the entry's record, with ``metrics`` read."""
    import torch

    cell, config = load_cell(name)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    ctx = Context(cell=cell, config=config, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=dev,
                  t_start=process_start_s() if t_start is None else t_start,
                  options=dict(options or {}))
    rec = importlib.import_module(f"portbench.entries.{cell['entry']}").run(ctx)
    rec["metrics"] = read_metrics(name, rec, trace)
    return rec


def judge(checks: List[Dict[str, Any]]) -> bool:
    """Each check holds ``value <= limit``; a number that is not finite fails."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)


def result_line(rec: Dict[str, Any], device_info: Dict[str, Any]) -> Dict[str, Any]:
    """The contract's last line: ``checks`` (each compared number beside
    its limit) comes last."""
    out = {"correct": judge(rec["checks"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": rec["metrics"], "device": device_info}
    if rec.get("profile"):
        p = rec["profile"]
        out["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in rec["checks"]}
    return out


def check(name: str, value: float, limit: float) -> Dict[str, Any]:
    return {"name": name, "value": float(value), "limit": float(limit)}


def leaf_norms(rows, table) -> List[List[float]]:
    """Per silo, the float64 norm of every leaf of ``rows`` ``[n, P]``."""
    import torch

    out = []
    for r in range(rows.shape[0]):
        parts = [torch.linalg.vector_norm(rows[r, lf.offset:lf.offset + lf.size],
                                          dtype=torch.float64) for lf in table]
        out.append(torch.stack(parts).cpu().tolist())
    return out


def delta_norms(rows, dims, seed: int) -> List[List[float]]:
    """Per silo, the norm of every leaf of ``rows`` minus the rows that
    ``seed`` drew at the start (drawn again here, one row at a time)."""
    import torch

    from portbench.reference.model import iter_rows, leaf_table

    table = leaf_table(dims)
    out = []
    for r, w0 in enumerate(iter_rows(dims, rows.shape[0], seed, rows.device)):
        w0.sub_(rows[r]).neg_()
        out.append(leaf_norms(w0[None], table)[0])
    torch.cuda.empty_cache() if rows.is_cuda else None
    return out

