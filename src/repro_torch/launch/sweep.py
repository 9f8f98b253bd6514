"""Sequential dry-run sweep: one subprocess per (arch x shape), so each
pair starts with a fresh allocator; a pair whose JSON already says
``ok``, ``needs_cards`` or ``skipped`` is skipped, so a cut run resumes.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--out DIR] [--flash-kernel] \
        [--arch A ...] [--timeout S] [--force]

Counterpart of ``repro.launch.sweep``; each pair runs
``python -m repro_torch.launch.dryrun --arch A --shape S --out DIR``.  A
pair killed at ``--timeout`` gets an ``error`` record with
``timed_out`` set to that timeout; it is not run again with the same or
a shorter one (it would time out again) unless ``--force``.  ``--arch``
(repeatable) keeps the sweep to those archs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch.dryrun import MESH_NAME, RESULTS_DIR, result_path

ARCHS = [
    "internlm2-1.8b", "xlstm-350m", "hymba-1.5b", "h2o-danube-1.8b",
    "whisper-large-v3", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
    "granite-20b", "internvl2-76b", "mistral-large-123b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DONE = ("ok", "needs_cards", "skipped", "timed_out")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cached_status(path: str, timeout: Optional[int] = None) -> Optional[str]:
    """The status a pair's JSON holds (``"timed_out"`` for a pair killed at
    ``timeout`` seconds or more), ``"corrupt"`` if it cannot be read, None
    if there is none."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return "corrupt"
    if d.get("timed_out") and (timeout is None or d["timed_out"] >= timeout):
        return "timed_out"
    return d.get("status")


def timeout_record(arch: str, shape: str, seconds: int) -> dict:
    return {"arch": arch, "shape": shape, "mesh": MESH_NAME,
            "kind": INPUT_SHAPES[shape]["kind"], "status": "error", "timed_out": seconds,
            "error": f"timed out after {seconds} s (the sweep's limit for one pair)"}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="sweep only this arch (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flash-kernel", action="store_true")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                                 else []))
    t0 = time.time()
    failures = []
    for arch in args.arch or ARCHS:
        for shape in SHAPES:
            path = result_path(args.out, arch, shape)
            st = cached_status(path, args.timeout)
            if st in DONE and not args.force:
                print(f"[skip] {arch} {shape} (cached: {st})", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--out", args.out, "--device", args.device,
                   "--reps", str(args.reps)]
            if args.flash_kernel:
                cmd.append("--flash-kernel")
            print(f"[run ] {' '.join(cmd[3:])}  t={time.time() - t0:.0f}s", flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout, env=env)
                if r.returncode != 0:
                    failures.append((arch, shape))
            except subprocess.TimeoutExpired:
                print(f"[TIMEOUT] {arch} {shape}", flush=True)
                failures.append((arch, shape))
                os.makedirs(args.out, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(timeout_record(arch, shape, args.timeout), f, indent=2)
    print(f"sweep done in {time.time() - t0:.0f}s; failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
