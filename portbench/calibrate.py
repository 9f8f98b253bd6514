"""Readings from which a cell's limits are set: the numbers that decide
``correct`` on many seeds of the program, of the control (the program's
matrix products in TF32, the nearest precision below the configuration's
float32) and of planted faults, each run only as far as the check rounds
and the reference that follows them.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch,no_mix --fault-seeds 7,8,9]

Prints one JSON line a run: the seed, the switch, every number compared
and the seconds of the reference.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import core

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    runs = [(s, {}) for s in seeds(args.seeds)]
    runs += [(s, {"control": "tf32"}) for s in seeds(args.control_seeds)]
    runs += [(s, {"fault": f}) for f in args.faults.split(",") if f
             for s in seeds(args.fault_seeds)]
    for seed, opt in runs:
        t0 = time.perf_counter()
        rec = core.run_cell(args.workload, seed, 0, False, device=args.device,
                            options=dict(opt, check_only=True), t_start=t0)
        print(json.dumps({"workload": args.workload, "seed": seed, "option": opt,
                          "checks": {c["name"]: c["value"] for c in rec["checks"]},
                          "correct": core.judge(rec["checks"]),
                          "reference_s": rec["ref"]["seconds"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
