#!/usr/bin/env python3
"""Time the timing-recursion kernel (K1's fourth entry, the round-varying
Eq. 4 recursion of MATCHA pricing) of one or more checkouts of the
PyTorch port on one CUDA card, at the two shapes ``chip_smoke.py`` times.

    python3 scripts/port_timing_ab.py PATH/TO/CHECKOUT [PATH/TO/CHECKOUT ...]

Each checkout runs in a process of its own (its ``segment_max.cu`` is
built there, from its own sources).  The inputs are what that checkout's
budget sweep hands the recursion: the repo's engine shape (N = 64, a
degree-8 random-geometric base graph, 8 budgets x 8 seeds x 300 rounds)
and Ebone's design shape (8 budgets x 3 seeds x 150 rounds, iNaturalist).
For each it checks the kernel against its plain version bit for bit,
prints five means of 50 calls on CUDA events and a digest of the output
(equal digests: equal results across checkouts).  To compare two
versions on one card, unpack the parent beside the change and give the
checkouts in turns: parent, change, change, parent.

    python3 scripts/port_timing_ab.py --plans PATH/TO/CHECKOUT

times, at the same two shapes, every layout the checkout's cluster kernel
can take (``TimingPlan``: 1, 2, 4 or 8 CTAs a chain, a ring of 0, 2 or 4
rounds) beside the one its ``timing_plan`` picks, each held to the plain
version bit for bit.

    python3 scripts/port_timing_ab.py --segmax PATH/TO/CHECKOUT [...]
    python3 scripts/port_timing_ab.py --segmax-plans PATH/TO/CHECKOUT

do the same for K1's standalone segment max (``edge_segment_max``) at
the Ebone climb shape (B=16, E=261, S=87), the scoring shape (B=8,
E=8192, S=1024) and a wide one (B=2, E=5000, S=20000), float32 and
float64, on inputs made from one seed: five means of 200 calls on CUDA
events, the kernel's device time by the profiler, ``scatter_reduce_``
(one PyTorch call computing the same function) in the same process, the
bound and a digest; then, at the Ebone climb shape, the host's
microseconds a call of each piece of the wrapper's path.  ``--segmax-plans``
times every layout of the cluster kernel (``SegmentMaxPlan``: 1, 2, 4 or
8 CTAs a row x the maxima in shared memory or in the output) by the
profiler's device time, twice, with the one ``segment_max_plan`` picks
marked, at those shapes and one where every edge collides (S = 1).

    python3 scripts/port_timing_ab.py --reach PATH/TO/CHECKOUT [...]
    python3 scripts/port_timing_ab.py --reach-plans PATH/TO/CHECKOUT

do the same for K1's reachability entry (``reach_from_zero``) at the
Ebone climb shape (B=16, E=261, N=87) and the scoring shape (B=8,
E=8192, N=1024), on ``chip_smoke.py``'s arc lists (row 0 a path), and on
the graphs an Ebone ``design_overlay("sparse_rewire")`` on the card hands
``reach_from_zero``, captured here by wrapping the name the climb calls:
five means of 200 calls on CUDA events, the profiler's device time (for
the design graphs, summed over one replay of every captured call), the
bound, the levels (BFS depth + 1) and steps (vertices reached) of the
longest traversal and a digest; then, at the Ebone climb shape, the
host's microseconds a call of each piece of the wrapper's path.
``--reach-plans`` times every layout of ``reach_layouts`` (the bitsets
at one and two traversals a CTA, the hops over staged arcs, the hops
over arcs in global memory) by the profiler's device time, twice, with
the one ``reach_plan`` picks marked, at those shapes and two with more
traversals than SMs: (200, 600, 87) and (64, 8192, 1024).
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def time_checkout(root: Path, plans: bool = False) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core import (DEFAULT_MATCHA_BUDGETS, WORKLOADS, MatchaSchedule,
                                  TrainingParams, greedy_edge_coloring, make_underlay,
                                  matcha_schedule_from_connectivity)
    from repro_torch.core.schedule import _sweep_inputs
    from repro_torch.kernels import _build, timing_recursion
    from repro_torch.kernels.segment_max import timing_recursion_ref

    # the shapes' generator, the bound and the timer of chip_smoke.py
    # (imported after the port, so that the port stays the checkout's)
    sys.path.insert(1, str(HERE))
    from chip_smoke import fmt_times, geometric_gc, time_ms, timing_bound

    if not torch.cuda.is_available():
        raise SystemExit("port_timing_ab: no CUDA device")
    if not _build.CSRC.is_relative_to(root):
        raise SystemExit(f"port_timing_ab: imported the port from {_build.CSRC}, not {root}")
    _build.build_all(["segment_max"])
    dev = torch.device("cuda", 0)
    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    gc, pairs = geometric_gc(64, 8)
    matchings = tuple(tuple(m) for m in greedy_edge_coloring(pairs))
    ebone = make_underlay("ebone").connectivity_graph(comp_time_ms=Tc)
    eb_matchings = matcha_schedule_from_connectivity(ebone).matchings
    shapes = (("engine", matchings, gc, 300, tuple(range(8))),
              ("ebone_design", eb_matchings, ebone, 150, (0, 1, 2)))
    for name, mt, g, R, seeds in shapes:
        scheds = [MatchaSchedule(matchings=mt, budget=b) for b in DEFAULT_MATCHA_BUDGETS]
        src, dst, w, ids = (torch.from_numpy(a).to(dev) for a in _sweep_inputs(scheds, g, tp, R,
                                                                                seeds))
        N, (U, E), (C, _) = g.num_silos, w.shape, ids.shape
        got = timing_recursion(src, dst, w, ids, N)
        if not torch.equal(got, timing_recursion_ref(src, dst, w, ids, N)):
            raise SystemExit(f"port_timing_ab {root} {name}: kernel differs from its plain version")
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        times = [time_ms(torch, lambda: timing_recursion(src, dst, w, ids, N), reps=50)
                 for _ in range(5)]
        bound, by = timing_bound(C, R, U, E, N, 8)
        if plans:
            time_plans(torch, name, src, dst, w, ids, N, R, bound, digest)
            continue
        print(f"timing_ab {root} {name} C={C} R={R} U={U} E={E} N={N} f64: ms {fmt_times(times)} "
              f"mean {sum(times) / len(times):.5f}  bound_ms {bound:.6f} ({by})  digest {digest}  "
              f"({torch.cuda.get_device_name(0)})", flush=True)


def time_plans(torch, name, src, dst, w, ids, N, R, bound, digest) -> None:
    """Every layout of the cluster kernel at one shape, in turns (each
    plan twice, the grid walked forward then back), the picked one marked."""
    from repro_torch.kernels.segment_max import (TimingPlan, _launch_timing, _smem_cap,
                                                 timing_plan_on_card, timing_smem_bytes)

    from chip_smoke import time_ms

    (U, E), (C, _) = w.shape, ids.shape
    picked = timing_plan_on_card(C, E, N, w.dtype, w.device)
    cap = _smem_cap(torch.cuda.current_device())
    grid = []
    for cluster in (1, 2, 4, 8):
        arcs = -(-E // cluster)
        for stages in (0, 2, 4):
            plan = TimingPlan(cluster, arcs, stages,
                              timing_smem_bytes(N, arcs, stages, 8, cluster))
            if plan.smem_bytes <= cap:
                grid.append(plan)
    times = {p: [] for p in grid}
    for p in grid + grid[::-1]:
        got = _launch_timing(src, dst, w, ids, N, None, p)
        if hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16] != digest:
            raise SystemExit(f"port_timing_ab {name} {p}: differs from the plain version")
        times[p].append(time_ms(torch, lambda: _launch_timing(src, dst, w, ids, N, None, p),
                                reps=50))
    for p, ts in times.items():
        mean = sum(ts) / len(ts)
        mark = "  <- timing_plan" if (p.cluster, p.stages) == (picked.cluster,
                                                               picked.stages) else ""
        print(f"timing_plans {name} C={C} R={R} U={U} E={E} N={N} f64 cluster {p.cluster} "
              f"arcs/CTA {p.arcs_per_cta} stages {p.stages} smem {p.smem_bytes}: ms "
              f"{ts[0]:.4f} / {ts[1]:.4f}  ms a round {mean / R:.6f}  bound_ms {bound:.6f}{mark}",
              flush=True)


SEGMAX_SHAPES = (("ebone_climb", (16, 261, 87)), ("scoring", (8, 8192, 1024)),
                 ("wide", (2, 5000, 20000)), ("collide", (8, 8192, 1)))


def segmax_checkout(root: Path, plans: bool = False) -> None:
    """The standalone segment max of one checkout at SEGMAX_SHAPES."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, edge_segment_max
    from repro_torch.kernels.segment_max import edge_segment_max_ref

    sys.path.insert(1, str(HERE))
    from chip_smoke import device_kernels, fmt_times, same_values, segmax_bound_ms, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("port_timing_ab: no CUDA device")
    if not _build.CSRC.is_relative_to(root):
        raise SystemExit(f"port_timing_ab: imported the port from {_build.CSRC}, not {root}")
    _build.build_all(["segment_max"])
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    for name, (B, E, S) in SEGMAX_SHAPES:
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device=dev).manual_seed(B * E + S)
            vals = torch.randn((B, E), generator=gen, device=dev, dtype=torch.float64).to(dtype)
            ids = torch.randint(0, S, (B, E), generator=gen, device=dev, dtype=torch.int32)
            got = edge_segment_max(vals, ids, S)
            if not same_values(torch, got, edge_segment_max_ref(vals, ids, S)):
                raise SystemExit(f"port_timing_ab {root} segmax {name}: differs from plain")
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
            bound = segmax_bound_ms(B, E, S, vals.element_size())
            tag = f"{name} B={B} E={E} S={S} {str(dtype)[6:]}"
            if plans:
                segmax_plans(torch, tag, vals, ids, S, bound, digest)
                continue
            times = [time_ms(torch, lambda: edge_segment_max(vals, ids, S), reps=200, warmup=5)
                     for _ in range(5)]
            out = torch.full((B, S), float("-inf"), device=dev, dtype=dtype)
            ids64 = ids.long()
            lib_ms = [time_ms(torch, lambda: out.scatter_reduce_(1, ids64, vals, "amax"),
                              reps=200, warmup=5) for _ in range(2)]
            _, kernels = device_kernels(torch, lambda: [edge_segment_max(vals, ids, S)
                                                        for _ in range(100)])
            own = [(c, us) for k, (c, us) in kernels.items() if "segment_max_kernel" in k]
            dev_ms = f"{own[0][1] / own[0][0] / 1e3:.5f}" if own else "not measured"
            print(f"segmax_ab {root} {tag}: ms {fmt_times(times)} mean "
                  f"{sum(times) / len(times):.5f}  device_ms {dev_ms}  scatter_reduce_ ms "
                  f"{fmt_times(lib_ms)}  bound_ms {bound:.6f} (bytes)  digest {digest}  ({card})",
                  flush=True)
    if not plans:
        segmax_host_us(torch, root, dev)


def segmax_host_us(torch, root: Path, dev) -> None:
    """Host microseconds a call of each piece of the wrapper's path at the
    Ebone climb shape: enqueue only, 2000 calls between two synchronises."""
    import time

    from repro_torch.kernels import edge_segment_max
    from repro_torch.kernels import segment_max as mod
    from repro_torch.kernels.segment_max import _DTYPE_CODES, _library, edge_segment_max_cuda

    B, E, S = 16, 261, 87
    gen = torch.Generator(device=dev).manual_seed(1)
    vals = torch.randn((B, E), generator=gen, device=dev)
    ids = torch.randint(0, S, (B, E), generator=gen, device=dev, dtype=torch.int32)
    out = torch.empty((B, S), device=dev)
    ids64 = ids.long()
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    pieces = {
        "edge_segment_max": lambda: edge_segment_max(vals, ids, S),
        "edge_segment_max_cuda": lambda: edge_segment_max_cuda(vals, ids, S),
        "ctypes launch alone": lambda: lib.segment_max(vals.data_ptr(), ids.data_ptr(),
                                                       out.data_ptr(), B, E, S,
                                                       _DTYPE_CODES[vals.dtype], stream),
        "torch.empty": lambda: torch.empty((B, S), dtype=vals.dtype, device=vals.device),
        "Tensor.new_empty": lambda: vals.new_empty((B, S)),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": (lambda: raw(0)) if raw else None,
        "the wrapper's checks": ((lambda: mod._check_segment_max_cuda(vals, ids, S))
                                 if hasattr(mod, "_check_segment_max_cuda") else None),
        "torch.cuda.current_device": torch.cuda.current_device,
        "data_ptr x3": lambda: (vals.data_ptr(), ids.data_ptr(), out.data_ptr()),
        "scatter_reduce_ (in place)": lambda: out.scatter_reduce_(1, ids64, vals, "amax"),
    }
    parts = []
    for name, fn in pieces.items():
        if fn is None:
            parts.append(f"{name} n/a")
            continue
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        parts.append(f"{name} {(t1 - t0) / 2000 * 1e6:.3f}")
    print(f"segmax_host {root} B={B} E={E} S={S} float32, host us a call: " + "; ".join(parts),
          flush=True)


def segmax_plans(torch, tag, vals, ids, S, bound, digest) -> None:
    """Every layout of the cluster kernel at one shape, in turns (each
    twice, the grid walked forward then back), the picked one marked."""
    from repro_torch.kernels.segment_max import (_launch_segment_max, _smem_cap,
                                                 segment_max_layouts, segment_max_plan_on_card)

    from chip_smoke import device_kernels

    B, E = vals.shape
    picked = segment_max_plan_on_card(B, E, S, vals.dtype, vals.device)
    grid = segment_max_layouts(E, S, vals.element_size(), _smem_cap(torch.cuda.current_device()))
    times = {p: [] for p in grid}
    for p in grid + grid[::-1]:
        got = _launch_segment_max(vals, ids, S, p)
        if hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16] != digest:
            raise SystemExit(f"port_timing_ab segmax {tag} {p}: differs from the plain version")
        # the launcher's host path outlasts the kernel: time the device's side
        _, kernels = device_kernels(torch, lambda: [_launch_segment_max(vals, ids, S, p)
                                                    for _ in range(100)])
        own = [(c, us) for k, (c, us) in kernels.items() if "segment_max_kernel" in k]
        times[p].append(own[0][1] / own[0][0] / 1e3 if own else float("nan"))
    for p, ts in times.items():
        mark = "  <- segment_max_plan" if p == picked else ""
        print(f"segmax_plans {tag} cluster {p.cluster} edges/CTA {p.edges_per_cta} "
              f"{p.segments} smem {p.smem_bytes}: device_ms {ts[0]:.5f} / {ts[1]:.5f}  bound_ms "
              f"{bound:.6f}{mark}", flush=True)


REACH_SHAPES = (("ebone_climb", (16, 261, 87)), ("scoring", (8, 8192, 1024)))
REACH_PLAN_SHAPES = REACH_SHAPES + (("packed", (200, 600, 87)), ("sweep", (64, 8192, 1024)))


def reach_checkout(root: Path, plans: bool = False) -> None:
    """Reachability of one checkout at REACH_SHAPES and on the Ebone
    design's own graphs."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, reach_from_zero
    from repro_torch.kernels.segment_max import reach_from_zero_ref

    sys.path.insert(1, str(HERE))
    from chip_smoke import (device_kernels, fmt_times, karp_case, own_device_ms, reach_bound,
                            time_ms)

    if not torch.cuda.is_available():
        raise SystemExit("port_timing_ab: no CUDA device")
    if not _build.CSRC.is_relative_to(root):
        raise SystemExit(f"port_timing_ab: imported the port from {_build.CSRC}, not {root}")
    _build.build_all(["segment_max"])
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    for name, (B, E, N) in (REACH_PLAN_SHAPES if plans else REACH_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(B * E + N)
        src, dst, _, present = karp_case(torch, gen, dev, B, N, E, False)
        got = reach_from_zero(src, dst, present, N)
        if not torch.equal(got, reach_from_zero_ref(src, dst, present, N)):
            raise SystemExit(f"port_timing_ab {root} reach {name}: differs from plain")
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        bound, by, hops = reach_bound(torch, src, dst, present, N)
        tag = f"{name} B={B} E={E} N={N}"
        if plans:
            reach_plans(torch, tag, [(src, dst, present, N)], bound, digest, max(hops) + 1)
            continue
        times = [time_ms(torch, lambda: reach_from_zero(src, dst, present, N), reps=200, warmup=5)
                 for _ in range(5)]
        _, kernels = device_kernels(torch, lambda: [reach_from_zero(src, dst, present, N)
                                                    for _ in range(100)])
        dev_ms = own_device_ms(kernels, "reach_")
        steps = int(got.sum(dim=2).max())
        print(f"reach_ab {root} {tag}: ms {fmt_times(times)} mean {sum(times) / len(times):.5f}  "
              f"device_ms {'not measured' if dev_ms is None else f'{dev_ms:.5f}'}  bound_ms "
              f"{bound:.6f} ({by})  levels {max(hops) + 1}  steps {steps}  digest {digest}  "
              f"({card})", flush=True)

    calls = design_graphs(torch, dev)
    outs = [reach_from_zero(*c) for c in calls]
    for c, got in zip(calls, outs):
        if not torch.equal(got, reach_from_zero_ref(*c)):
            raise SystemExit(f"port_timing_ab {root} reach: a design graph differs from plain")
    digest = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs)).hexdigest()[:16]
    shapes = sorted({tuple(c[2].shape) + (c[3],) for c in calls})
    bounds = [reach_bound(torch, *c) for c in calls]
    bound = sum(b[0] for b in bounds)
    levels = [max(b[2]) + 1 for b in bounds]
    tag = (f"ebone_design ({len(calls)} calls, [B, E] x N {shapes}, levels "
           f"{min(levels)}-{max(levels)})")
    if plans:
        reach_plans(torch, tag, calls, bound, digest, max(levels))
        return
    replay = [time_ms(torch, lambda: [reach_from_zero(*c) for c in calls], reps=20, warmup=2)
              for _ in range(5)]
    sums = []
    for _ in range(3):
        _, kernels = device_kernels(torch, lambda: [reach_from_zero(*c) for c in calls])
        mine = [(n, us) for k, (n, us) in kernels.items() if "reach_" in k]
        sums.append(f"{sum(us for _, us in mine) / 1e3:.5f} ({sum(n for n, _ in mine)} launches)")
    print(f"reach_ab {root} {tag}: ms a replay of every call {fmt_times(replay)} mean "
          f"{sum(replay) / len(replay):.5f}  device_ms summed over the calls {' / '.join(sums)}  "
          f"bound_ms summed {bound:.6f} (bytes)  digest {digest}  ({card})", flush=True)
    reach_host_us(torch, root, dev)


def design_graphs(torch, dev) -> list:
    """(src, dst, present, N) of every call an Ebone sparse_rewire design
    on the card makes of reach_from_zero, cloned as they were passed."""
    import repro_torch.core.topologies as topo
    from repro_torch.core import WORKLOADS, TrainingParams, design_overlay, make_underlay

    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    gc = make_underlay("ebone").connectivity_graph(comp_time_ms=Tc)
    calls = []
    real = topo.reach_from_zero

    def record(src, dst, present, n):
        calls.append((src.clone(), dst.clone(), present.clone(), n))
        return real(src, dst, present, n)

    topo.reach_from_zero = record
    try:
        design_overlay("sparse_rewire", gc, tp, device=dev)
    finally:
        topo.reach_from_zero = real
    torch.cuda.synchronize()
    return calls


def reach_host_us(torch, root: Path, dev) -> None:
    """Host microseconds a call of each piece of the wrapper's path at the
    Ebone climb shape: enqueue only, 2000 calls between two synchronises."""
    import time

    from repro_torch.kernels import ops, reach_from_zero
    from repro_torch.kernels import segment_max as mod
    from repro_torch.kernels.segment_max import _library, check_reach_inputs, reach_from_zero_cuda

    from chip_smoke import karp_case

    B, E, N = 16, 261, 87
    gen = torch.Generator(device=dev).manual_seed(1)
    src, dst, _, present = karp_case(torch, gen, dev, B, N, E, False)
    out = torch.empty((2, B, N), dtype=torch.bool, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    card_ids = getattr(ops, "_card_ids", None)
    pieces = {
        "reach_from_zero": lambda: reach_from_zero(src, dst, present, N),
        "reach_from_zero_cuda": lambda: reach_from_zero_cuda(src, dst, present, N),
        "ctypes launch alone": lambda: lib.reach(src.data_ptr(), dst.data_ptr(),
                                                 present.data_ptr(), out.data_ptr(), B, E, N,
                                                 stream),
        "torch.empty": lambda: torch.empty((2, B, N), dtype=torch.bool, device=present.device),
        "Tensor.new_empty": lambda: present.new_empty((2, B, N)),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": (lambda: raw(0)) if raw else None,
        "check_reach_inputs": lambda: check_reach_inputs(src, dst, present, N),
        "the wrapper's checks": ((lambda: mod._check_reach_cuda(src, dst, present, N))
                                 if hasattr(mod, "_check_reach_cuda") else None),
        "ids .to(int32).contiguous() x2": lambda: (
            src.to(device=present.device, dtype=torch.int32).contiguous(),
            dst.to(device=present.device, dtype=torch.int32).contiguous()),
        "_card_ids x2": ((lambda: (card_ids(src, present, 0), card_ids(dst, present, 0)))
                         if card_ids else None),
        "data_ptr x4": lambda: (src.data_ptr(), dst.data_ptr(), present.data_ptr(),
                                out.data_ptr()),
    }
    parts = []
    for name, fn in pieces.items():
        if fn is None:
            parts.append(f"{name} n/a")
            continue
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        parts.append(f"{name} {(t1 - t0) / 2000 * 1e6:.3f}")
    print(f"reach_host {root} B={B} E={E} N={N}, host us a call: " + "; ".join(parts), flush=True)


def reach_plans(torch, tag, calls, bound, digest, levels) -> None:
    """Every layout of reachability over ``calls`` (one shape, or the
    design's graphs), in turns (each twice, the grid walked forward then
    back), summed device time, the layout reach_plan picks (for the first
    call) marked."""
    from repro_torch.kernels.segment_max import (_launch_reach, _smem_cap, reach_layouts,
                                                 reach_plan_on_card)

    from chip_smoke import device_kernels

    E, N = calls[0][2].shape[1], calls[0][3]
    picked = reach_plan_on_card(E, N, calls[0][2].device)
    cap = _smem_cap(torch.cuda.current_device())
    grid = [p for p in reach_layouts(E, N, cap)
            if all(p in reach_layouts(c[2].shape[1], c[3], cap) for c in calls)]
    times = {p: [] for p in grid}
    for p in grid + grid[::-1]:
        outs = [_launch_reach(*c, p) for c in calls]
        got = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs)).hexdigest()[:16]
        if got != digest:
            raise SystemExit(f"port_timing_ab reach {tag} {p}: differs from the plain version")
        _, kernels = device_kernels(torch, lambda: [_launch_reach(*c, p) for c in calls])
        times[p].append(sum(us for k, (_, us) in kernels.items() if "reach_" in k) / 1e3)
    for p, ts in times.items():
        mark = "  <- reach_plan" if p == picked else ""
        print(f"reach_plans {tag} {p.layout} rows {p.rows} smem {p.smem_bytes}: device_ms "
              f"{ts[0]:.5f} / {ts[1]:.5f}  levels {levels}  bound_ms {bound:.6f}{mark}",
              flush=True)


def main(argv: list) -> int:
    modes = {"--one": time_checkout, "--plans": lambda r: time_checkout(r, plans=True),
             "--one-segmax": segmax_checkout,
             "--segmax-plans": lambda r: segmax_checkout(r, plans=True),
             "--one-reach": reach_checkout,
             "--reach-plans": lambda r: reach_checkout(r, plans=True)}
    if len(argv) == 2 and argv[0] in modes:
        modes[argv[0]](Path(argv[1]).resolve())
        return 0
    one = "--one"
    if argv and argv[0] in ("--segmax", "--reach"):
        one, argv = f"--one-{argv[0][2:]}", argv[1:]
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    for root in argv:
        done = subprocess.run([sys.executable, __file__, one, root])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
