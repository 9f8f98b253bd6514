"""Where one DPASGD round's device time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_round --layers 4

Trains a few warm-up rounds through :func:`repro_torch.launch.train.train`
(internlm2-1.8b at full width, depth cut to ``--layers``, 4 silos on a
ring, ``pallas`` mix), then traces one more round with
``torch.profiler`` and prints: the round's wall time, the device's busy
time (the sum of its kernels' and copies' times), the idle share, and
the device time by part of the round (matrix products, the gossip-mix
kernel, copies, other kernels) and by kernel.  The profiler's own cost
is inside the traced round's wall time, so the idle share is an upper
bound.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.fed import make_train_step
from repro_torch.launch.train import TrainResult, batch_to_device, train


def kernel_part(name: str) -> str:
    """The part of a round a device kernel belongs to, from its name."""
    low = name.lower()
    if "gossip_mix" in low:
        return "gossip_mix kernel"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "gemv", "sm90_")):
        return "matrix products"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies and fills"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gathers and scatters"
    return "other kernels"


def device_profile(fn: Callable[[], Any], dev: torch.device) -> Tuple[Any, Dict[str, object]]:
    """One ``torch.profiler`` window around ``fn()``: its output and the
    window's wall time (from before the call to the device's last
    kernel), the device's busy time (the sum of its kernels' and copies'
    self times), the idle share, and the device time by part (see
    :func:`kernel_part`) and by kernel.  The idle share is None when the
    profiler saw no device events (the CPU)."""
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
    per_kernel: Dict[str, Tuple[int, float]] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        per_kernel[ev.key] = (ev.count, us)
    busy_us = sum(us for _, us in per_kernel.values())
    parts: Dict[str, float] = defaultdict(float)
    for name, (_, us) in per_kernel.items():
        parts[kernel_part(name)] += us
    kernels = sorted(((n, c, us) for n, (c, us) in per_kernel.items()),
                     key=lambda r: -r[2])
    return out, {
        "wall_s": wall_s,
        "busy_s": busy_us / 1e6,
        "idle_share": (1.0 - busy_us / 1e6 / wall_s) if busy_us else None,
        "parts_s": {k: v / 1e6 for k, v in sorted(parts.items(), key=lambda kv: -kv[1])},
        "kernels": kernels,
    }


def profile_round(result: TrainResult, round_idx: int) -> Dict[str, object]:
    """Trace round ``round_idx`` of a run continued from ``result``."""
    dev = result.state["params"].device
    step_fn = make_train_step(result.cfg, result.fed, result.optimizer, result.plan)
    batch = batch_to_device(result.batcher.batch(round_idx), dev)
    (result.state, _), prof = device_profile(lambda: step_fn(result.state, batch), dev)
    return prof


def report(prof: Dict[str, object], top: int = 15) -> List[str]:
    lines = [f"round wall {prof['wall_s']:.4f} s (host clock, traced)"]
    if prof["idle_share"] is None:
        lines.append("device time: not measured (the profiler saw no device events)")
        return lines
    lines.append(f"device busy {prof['busy_s']:.4f} s, idle share {prof['idle_share']:.3f}")
    for part, sec in prof["parts_s"].items():
        lines.append(f"  part {part:24s} {sec:.4f} s ({sec / prof['busy_s']:.1%} of busy)")
    for name, count, us in prof["kernels"][:top]:
        lines.append(f"  kernel {us / 1e3:10.3f} ms  x{count:<5d} {name[:110]}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"device {torch.cuda.get_device_name(dev)}")
    warmup = 2
    cfg = get_config("internlm2-1.8b", n_layers=args.layers)
    res = train(cfg, silos=4, topology="ring", gossip_impl="pallas",
                local_steps=2, batch_per_silo=4, seq_len=64, steps=warmup,
                device=dev, log=lambda line: print(line, flush=True))
    for line in report(profile_round(res, warmup)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
