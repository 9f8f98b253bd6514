"""Run one cell of the benchmark once with the program's spans on, and
print the per-layer metrics that read them.

    python3 portbench/spans_run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--spans <0|1>] [--device cuda:0]

Until the benchmark's entries turn the spans on themselves in a
``--trace 1`` run, this script is how the span metrics are read.  The
cell runs through its own entry, as ``portbench/run.py`` runs it; this
script only wraps the names the entries call into the program: the batch
transfer (``train_loop``) or the built step (``steps_round``), to turn
the spans on at the window's first round (``portbench.spans.start``), and
``train``, to keep the program's own wall of each migration.  It keeps a
reference to each profiler the yardstick makes (``yardstick.profiler``
returns the same object; the yardstick reads it unchanged) and, after the
run, splits the named round's idle time by the span open over it.  It then
reads the spans into the record (``portbench.spans.stop``) and prints, as
its last line, one JSON object: the cell's metrics as ``run.py`` reads
them (end-to-end untraced, per-layer traced), the six span metrics of
``portbench/metrics/`` (``silo_loop_ms_per_round``,
``optimizer_ms_per_round``, ``mix_ms_per_round``, ``control_ms_per_round``,
``migration_ms``, ``idle_outside_step_ms``), the idle split of the named
round, the same reading of the device-only window (its idle time inside
the profiler's own window, and the profiler's stop call, which the
harness's wall of that window holds), ``correct``, the program's wall of
each migration, the CUDA-event time of the entry's optimizer wrapper and
the profiled K2 time per round beside them, and the device.  ``--spans 0``
runs the same with the spans off (the cost of tracing is the difference).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPAN_METRICS = ("silo_loop_ms_per_round", "optimizer_ms_per_round", "mix_ms_per_round",
                "control_ms_per_round", "migration_ms", "idle_outside_step_ms")


def run(workload: str, seed: int, seconds: float, trace: bool, spans_on: bool, device=None,
        t_start=None):
    """One run of ``workload`` with the spans turned on at its window's
    first round (``spans_on``); the record, with the span metrics under
    ``span_metrics``."""
    import repro_torch.launch.steps as ST
    import repro_torch.launch.train as TR

    from portbench import core, training, yardstick
    from portbench import spans as bs

    window = training.CHECK_ROUNDS
    calls = [0]
    extra = {"migration_wall_s": []}
    made = []
    to_device, build, make_profiler = TR.batch_to_device, ST.build_train_step, yardstick.profiler

    def at_round():
        if calls[0] == window and spans_on:
            bs.start()
        calls[0] += 1

    def batch_to_device(raw, dev):
        at_round()
        return to_device(raw, dev)

    def build_train_step(*args, **kwargs):
        step = build(*args, **kwargs)

        def counted(state, batch, *more):
            at_round()
            return step(state, batch, *more)

        return counted

    def profiler(host):
        made.append((host, make_profiler(host)))
        return made[-1][1]

    def train(*args, on_migration=None, **kwargs):
        def seen(mig):
            extra["migration_wall_s"].append(mig["wall_s"])   # the program's own wall
            return on_migration(mig)

        return train_fn(*args, on_migration=seen if on_migration else None, **kwargs)

    train_fn = TR.train
    TR.batch_to_device, ST.build_train_step = batch_to_device, build_train_step
    yardstick.profiler, TR.train = profiler, train
    try:
        rec = core.run_cell(workload, seed, seconds, trace, device=device, t_start=t_start)
    finally:
        TR.batch_to_device, ST.build_train_step = to_device, build
        yardstick.profiler, TR.train = make_profiler, train_fn
    # the last two made: the device-only window, then the named round
    # (the first is the warm-up's)
    if trace and len(made) >= 3 and not made[-2][0] and made[-1][0]:
        device_only, named = made[-2][1], made[-1][1]
        dev_iv, _, win = bs.profile_intervals(device_only)
        extra["device_window"] = dict(bs.idle_split(dev_iv, [], win),
                                      stop_s=bs.profiler_stop_s(device_only))
        extra["device_window_ranges"] = sum(
            1 for ev in device_only.events()
            if str(ev.device_type).endswith("CUDA") and getattr(ev, "is_user_annotation", False))
        extra["idle_split"] = bs.idle_split(*bs.profile_intervals(named))
    del made
    rec.update(bs.stop())
    rec.update(extra)
    rec["span_metrics"] = {}
    for name in SPAN_METRICS:
        value = importlib.import_module(f"portbench.metrics.{name}").read(rec)
        if value is not None:
            rec["span_metrics"][name] = value
    return rec


def main(argv=None) -> int:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "portbench" / ".cache" / sub))
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import core

    t_start = core.process_start_s()
    import torch

    if args.device is None:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device (pass --device cpu for a rehearsal)",
                  file=sys.stderr)
            return 3
        torch.set_num_threads(min(4, torch.get_num_threads()))
    rec = run(args.workload, args.seed, args.seconds, bool(args.trace), bool(args.spans),
              device=args.device, t_start=t_start)
    prof = rec.get("profile") or {}
    dev = torch.device(args.device or "cuda:0")
    per_round = {}
    if rec.get("optimizer") and rec.get("round_s"):
        per_round["timed_optimizer_ms"] = 1e3 * rec["optimizer"]["seconds"] / len(rec["round_s"])
    if prof:
        from portbench.yardstick import part_seconds

        per_round["k2_kernel_ms"] = 1e3 * part_seconds(prof, "gossip_mix kernel") / prof["rounds"]
    line = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
            "spans": args.spans, "correct": core.judge(rec["checks"]),
            "metrics": {k: v["value"] for k, v in rec["metrics"].items()},
            "span_metrics": rec["span_metrics"], "idle_split": rec.get("idle_split"),
            "device_window": rec.get("device_window"),
            "device_window_ranges": rec.get("device_window_ranges"),
            "migration_wall_s": rec["migration_wall_s"],
            "rounds": len(rec.get("round_s") or ()), "profiled": rec.get("profiled"),
            "per_round": per_round,
            "busy_s": prof.get("busy_s"), "window_s": prof.get("window_s"),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
