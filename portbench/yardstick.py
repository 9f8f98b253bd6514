"""The benchmark's yardstick: the card's peaks, the model FLOPs of a
trained token, the reading of a ``torch.profiler`` window, the
percentile of round times, and the numbers that decide ``correct``.

Frozen here so that a change to the program cannot move them.  The FLOP
arithmetic is a copy of the program's analytic model (dense GQA layers,
SwiGLU MLP, the head), the kernel classes a copy of its round profiler's.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM, dense, at the 700 W power limit (NVIDIA's data sheet).
PEAK_TF32_FLOPS = 495e12    # the fastest unit that takes float32 operands
PEAK_HBM_BYTES = 3.35e12


# -- model FLOPs ----------------------------------------------------------------

def _attn_t_eff(S: int, window: Optional[int]) -> float:
    """Average number of keys a query sees under a causal mask."""
    if window is not None:
        return min(window, (S + 1) / 2)
    return (S + 1) / 2


def forward_flops(d, S: int) -> float:
    """Forward FLOPs of one sequence of ``S`` tokens (matrix products only;
    ``d`` a :class:`reference.model.Dims`)."""
    D, H, K, hd, Fd = d.d_model, d.n_heads, d.n_kv_heads, d.head_dim, d.d_ff
    te = _attn_t_eff(S, d.sliding_window)
    layer = (2 * S * D * (H + 2 * K) * hd      # q, k, v projections
             + 4 * S * te * H * hd             # q k^T and p v
             + 2 * S * H * hd * D              # output projection
             + 6 * S * D * Fd)                 # SwiGLU
    return d.n_layers * layer + 2 * S * D * d.padded_vocab


def train_flops_per_token(d, S: int) -> float:
    """Model FLOPs of a trained token: forward and backward (3x the
    forward), recomputation not counted."""
    return 3.0 * forward_flops(d, S) / S


# -- the profiler ----------------------------------------------------------------

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


def _device_intervals(prof):
    kernels: Dict[str, float] = defaultdict(float)
    dev_iv: List[Tuple[float, float]] = []
    host_iv: List[Tuple[float, float, str]] = []
    for ev in prof.events():
        tr = ev.time_range
        if str(ev.device_type).endswith("CUDA"):
            kernels[ev.name] += (tr.end - tr.start) / 1e6
            dev_iv.append((tr.start, tr.end))
        elif tr.end > tr.start:
            host_iv.append((tr.start, tr.end, ev.name))
    dev_iv.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in dev_iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return kernels, busy_us / 1e6, sorted(gaps, reverse=True), host_iv


def read_profile(prof, wall_s: float, rounds: int, named=None) -> Dict[str, object]:
    """What the benchmark keeps of a finished ``torch.profiler`` window
    that traced the device only: device seconds by kernel, busy seconds
    (the union of the device's activity intervals, so work of two streams
    at once counts once), the window's wall and its round count.
    ``named``, a window that traced the host as well, names the longest
    idle gaps by the innermost host operation open when each began."""
    kernels, busy_s, _, _ = _device_intervals(prof)
    idle = []
    if named is not None:
        _, _, gaps, host_iv = _device_intervals(named)
        for length, at in gaps[:10]:
            inner = [(e - s, n) for s, e, n in host_iv if s <= at < e]
            idle.append([f"host: {min(inner)[1]}" if inner else "host: no operation open",
                         length / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": wall_s, "rounds": rounds, "kernels": dict(kernels),
            "device_ops": [[n, s] for n, s in top[:10]], "idle_gaps": idle}


def profiler(host: bool):
    """A ``torch.profiler`` of the card, and of the host's operations
    with ``host`` (which slows a host-bound round, so the device-time
    metrics come from a window without it)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    return profile(activities=acts)


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its own start-up (CUPTI's)
    falls in set-up and not in a traced round."""
    import torch

    with profiler(True):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def part_seconds(profile: Dict[str, object], part: str) -> float:
    return sum(s for n, s in profile["kernels"].items() if kernel_part(n) == part)


# -- statistics ------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all ``values``, linear between the order
    statistics (the 'inclusive' definition: 0 the least, 100 the most)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# -- the numbers that decide `correct` -------------------------------------------

def worst_leaf_gap(prog, ref, rule=None) -> float:
    """Largest ``|prog - ref| / max(ref, median leaf of ref)`` over silos
    and leaves, for per-leaf norms ``[n_silos][n_leaves]``.  ``rule``
    (same shape, booleans) leaves out the leaves it marks False."""
    worst = 0.0
    for i, (p_row, r_row) in enumerate(zip(prog, ref)):
        med = sorted(r_row)[len(r_row) // 2]
        for j, (p, r) in enumerate(zip(p_row, r_row)):
            if rule is not None and not rule[i][j]:
                continue
            den = max(r, med)
            gap = abs(p - r) / den if den > 0 else (0.0 if p == r else math.inf)
            worst = max(worst, gap)
    return worst


def moving_leaves(grad_norms) -> List[List[bool]]:
    """Per silo, the leaves whose reference gradient is at least a
    thousandth of the median leaf's: the others move by round-off alone."""
    out = []
    for row in grad_norms:
        med = sorted(row)[len(row) // 2]
        out.append([g >= 1e-3 * med for g in row])
    return out


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """Largest relative gap between the program's and the reference's
    round losses."""
    return max(abs(p - r) / abs(r) if r else math.inf for p, r in zip(prog, ref))
