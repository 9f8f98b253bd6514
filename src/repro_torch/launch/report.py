"""The dry-run JSONs as two markdown tables: the dry run (does each pair
fit one card, at what batch, how long a step takes) and the roofline
(the bounds, the bottleneck, the share of the bound a step reached).

    PYTHONPATH=src python -m repro_torch.launch.report [--out DIR] [--kind dryrun|roofline]

Counterpart of ``repro.launch.report``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.launch.dryrun import MESH_NAME, RESULTS_DIR

ARCH_ORDER = [
    "h2o-danube-1.8b", "xlstm-350m", "internvl2-76b", "internlm2-1.8b",
    "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "granite-20b",
    "mistral-large-123b", "whisper-large-v3", "hymba-1.5b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESH = MESH_NAME.replace("x", "-")

Rows = Dict[Tuple[str, str], Dict[str, Any]]


def load(out: str = RESULTS_DIR) -> Rows:
    """Every pair's record under ``out``, by (arch, shape)."""
    rows: Rows = {}
    for path in sorted(glob.glob(os.path.join(out, f"*_{MESH}.json"))):
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue
        rows[(d["arch"], d["shape"])] = d
    return rows


def _num(x: Any, fmt: str) -> str:
    return format(x, fmt) if isinstance(x, (int, float)) and not isinstance(x, bool) else "—"


def _status(d: Optional[Dict[str, Any]]) -> Optional[str]:
    """The status cell of a pair that did not run, None for one that did."""
    if d is None:
        return "MISSING"
    if d["status"] == "skipped":
        return "skipped (full attention: no long_500k)"
    if d["status"] == "needs_cards":
        why = "OOM at batch 1" if d.get("failed_batches") else \
            f"{d.get('fit_bytes', 0) / 1e9:.1f} GB"
        return f"needs_cards ({d.get('cards_needed')} cards: {why})"
    if d["status"] != "ok":
        return f"ERROR: {str(d.get('error', '?'))[:70]}"
    return None


def fmt_dryrun_table(rows: Rows) -> str:
    out = ["| arch | shape | status | batch / card | batches that failed | peak GiB | step s | "
           "idle share | compute ms | bytes ms | bottleneck | share |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            d = rows.get((arch, shape))
            st = _status(d)
            if st is not None:
                out.append(f"| {arch} | {shape} | {st} |" + " |" * 9)
                continue
            r = d["roofline"]
            cut = f" (reduced: {'; '.join(d['reduced'])})" if d.get("reduced") else ""
            out.append(
                f"| {arch} | {shape} | ok{cut} | {d['batch']} | "
                f"{', '.join(str(b) for b in d.get('failed_batches', [])) or 'none'} | "
                f"{_num(d.get('peak_gib'), '.2f')} | {_num(d.get('step_s'), '.4f')} | "
                f"{_num(r.get('idle_share'), '.3f')} | {r['compute_ms']:.3f} | "
                f"{r['memory_ms']:.3f} | {r['bottleneck']} | {_num(r.get('share'), '.3f')} |")
    return "\n".join(out)


def fmt_roofline_table(rows: Rows) -> str:
    out = ["| arch | shape | batch | GFLOP (analytic) | compute ms (f32) | compute ms (TF32) | "
           "GB moved | bytes ms | bound ms | step ms | share | useful-flop | device s by part |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            d = rows.get((arch, shape))
            if d is None or d["status"] != "ok":
                continue
            r = d["roofline"]
            step = d.get("step_s")
            parts = r.get("parts_s")
            parts = ", ".join(f"{k} {v:.3f}" for k, v in list(parts.items())[:3]) \
                if isinstance(parts, dict) else "—"
            out.append(
                f"| {arch} | {shape} | {d['batch']} | {r['analytic_gflops']:.1f} | "
                f"{r['compute_ms']:.3f} | {r['compute_tf32_ms']:.3f} | {r['gbytes']:.3f} | "
                f"{r['memory_ms']:.3f} | {r['bound_ms']:.3f} | "
                f"{_num(step * 1e3 if isinstance(step, float) else None, '.3f')} | "
                f"{_num(r.get('share'), '.3f')} | {r['useful_flop_ratio']:.2f} | {parts} |")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--kind", default="dryrun", choices=["dryrun", "roofline"])
    args = ap.parse_args(argv)
    rows = load(args.out)
    print(fmt_dryrun_table(rows) if args.kind == "dryrun" else fmt_roofline_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
