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
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def time_checkout(root: Path) -> None:
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
        print(f"timing_ab {root} {name} C={C} R={R} U={U} E={E} N={N} f64: ms {fmt_times(times)} "
              f"mean {sum(times) / len(times):.5f}  bound_ms {bound:.6f} ({by})  digest {digest}  "
              f"({torch.cuda.get_device_name(0)})", flush=True)


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_checkout(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    for root in argv:
        done = subprocess.run([sys.executable, __file__, "--one", root])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
