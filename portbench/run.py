"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds`` and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted`` and
``failed`` (rounds), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared, beside its
limit.  The same numbers end standard error.  Exits non-zero and prints
no result without a CUDA card (or fewer than the cell asks for), without
the program, or when JAX, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    # the program's kernel builds live in its checkout (``src/repro_torch/
    # kernels/_build``); any other build cache goes to a fixed place in it too
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "portbench" / ".cache" / sub))
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import core

    t_start = core.process_start_s()
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program (src/repro_torch) is not here: {exc}", file=sys.stderr)
        return 2
    import torch

    cell, _ = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    rec = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        t_start=t_start)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    dev = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": cell["chips"], "memory_peak_bytes": int(rec.get("peak_bytes", 0))}
    if args.trace and rec.get("profile"):
        info["busy_s"] = rec["profile"]["busy_s"]
        info["window_s"] = rec["profile"]["window_s"]
    line = core.result_line(rec, info)
    for name, sec in rec.get("setup_phases", {}).items():
        print(f"setup {name} {sec!r} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
