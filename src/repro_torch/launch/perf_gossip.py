"""DPASGD gossip measured per plan and lowering, with one silo per process.

    PYTHONPATH=src python -m repro_torch.launch.perf_gossip               # 16 silos, full model
    PYTHONPATH=src python -m repro_torch.launch.perf_gossip --device cuda:0 \\
        --dist-backend gloo --silos 4 --layers 1 --seq-len 1024 --batch 1   # one card
    PYTHONPATH=src python -m repro_torch.launch.perf_gossip --device cpu --reduced \\
        --silos 16 --seq-len 16 --batch 2                                     # the CPU

Counterpart of ``repro.launch.perf_gossip``, which compiles the 16-silo
internlm2-1.8b AdamW step (``flash_vjp``) for ring, chain and star under
``ppermute`` and for ring under ``einsum`` and reads the collective bytes
and the peak from the compiled HLO.  Here the step runs: ``--silos`` ranks
on a :class:`~repro_torch.launch.mesh.SiloMesh` (spawned once for every
entry), each training its silo through ``build_train_step(mesh=)`` with
AdamW at 1e-4, and the same plans under ``pallas`` (K2, the port's default
lowering) beside the reference's four entries.  Every entry starts from
the same ``init_state(seed)``, so a plan's rows after its rounds can be
held across its lowerings.  For each entry and rank it records the bytes
received each round (checked equal to
:func:`~repro_torch.fed.gossip.recv_bytes_per_round`), the bytes staged
through pinned host memory and the copies' seconds, each round's wall
(the last is the warm one), the peak (on the card), the K2 launches and
``plan.num_transfers``; then the star/ring traffic ratio the reference
prints, and a roofline whose collective term is a rank's received bytes
(:mod:`repro_torch.launch.roofline`).  One card holds 4 ranks of the full
width at 1 of 24 layers (a rank holds params, gradients, mu, nu and the
``[K, P]`` stack); 16 ranks of the full model need 16 cards.  Writes
``perf_gossip.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

ARCH = "internlm2-1.8b"
N_SILOS = 16
# the reference's four entries and K2's, grouped by plan: a plan's first
# params are held on the rank's device only until its last entry
ENTRIES: Tuple[Tuple[str, str], ...] = (
    ("ring", "ppermute"), ("ring", "einsum"), ("ring", "pallas"), ("chain", "ppermute"),
    ("chain", "pallas"), ("star", "ppermute"), ("star", "pallas"))
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments_torch")
DIGEST_CHUNK = 1 << 24


@dataclass(frozen=True)
class Options:
    """One run's settings, the same on every rank."""

    device: str = "cuda"
    backend: Optional[str] = None      # None: nccl on CUDA, gloo on the CPU
    layers: Optional[int] = None       # depth cut (None: all 24)
    reduced: bool = False              # the config's tiny CPU variant
    seq_len: int = 4096
    batch: int = 16                    # sequences a silo a round
    rounds: int = 2                    # the last is timed warm when there are two
    seed: int = 0
    keep_rows: bool = False            # return each entry's final rows (CPU tests)


def config(n_silos: int, opts: Options):
    """internlm2-1.8b with ``flash_vjp``, ``n_silos`` silos, depth cut to
    ``opts.layers`` or reduced."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(ARCH, flash_vjp=True, n_silos=n_silos)
    if opts.reduced:
        cfg = dataclasses.replace(cfg.reduced(), flash_vjp=True, n_silos=n_silos)
    if opts.layers is not None and opts.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=opts.layers,
                                  block_pattern=cfg.block_pattern[:opts.layers])
    return cfg


def digest(t: torch.Tensor) -> Tuple[int, float]:
    """``(sum of the float32 bit patterns as integers, float64 sum)`` of a
    flat row, a chunk at a time: equal rows give equal digests."""
    bits, total = 0, 0.0
    flat = t.reshape(-1)
    for lo in range(0, flat.numel(), DIGEST_CHUNK):
        part = flat[lo:lo + DIGEST_CHUNK]
        bits += int(part.view(torch.int32).sum(dtype=torch.int64))
        total += float(part.sum(dtype=torch.float64))
    return bits, total


def run_entries(mesh, opts: Options) -> Dict[str, Any]:
    """Every entry of ``ENTRIES`` on this rank of ``mesh`` (every rank
    calls it): a fresh ``init_state``, ``opts.rounds`` rounds of
    ``build_train_step(mesh=)``, and the rank's record of each, with the
    largest difference of its params to the plan's first entry's."""
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.fed import init_state, plan_for_n_silos
    from repro_torch.fed.gossip import recv_bytes_per_round
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import ParamLayout, model_specs
    from repro_torch.optim import adamw

    dev = mesh.device
    cuda = dev.type == "cuda"
    n = len(mesh.active)
    cfg = config(n, opts)
    P = ParamLayout(model_specs(cfg)).size
    opt = adamw(1e-4)
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, opts.seq_len, n_silos=n,
                                                 seed=opts.seed), 1, opts.batch)
    batches = [batch_to_device({k: v[0] for k, v in batcher.batch(r, silos=(mesh.rank,)).items()},
                               dev) for r in range(opts.rounds)]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out: Dict[str, Any] = {"rank": mesh.rank, "P": P, "n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "entries": []}
    held: Dict[str, torch.Tensor] = {}  # a plan's first entry's params, until its last entry
    last = {kind: i for i, (kind, _) in enumerate(ENTRIES)}
    for i, (kind, impl) in enumerate(ENTRIES):
        plan = plan_for_n_silos(kind, n)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(cfg, opt, seed=opts.seed, device=dev, mesh=mesh)
        step = build_train_step(cfg, optimizer=opt, gossip_impl=impl, plan=plan, mesh=mesh)
        rounds = []
        k2 = LAUNCHES["gossip_mix"]
        for r in range(opts.rounds):
            recv, staged, staging = mesh.recv_bytes, mesh.staged_bytes, mesh.staging_s
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batches[r])
            loss = float(m["loss"])
            sync()
            rounds.append({"wall_s": time.perf_counter() - t0, "loss": loss,
                           "recv_bytes": mesh.recv_bytes - recv,
                           "staged_bytes": mesh.staged_bytes - staged,
                           "staging_s": mesh.staging_s - staging})
        rec = {"kind": kind, "impl": impl, "num_transfers": plan.num_transfers,
               "K": len(plan.terms), "rounds": rounds,
               "expected_recv_bytes": recv_bytes_per_round(plan, impl, mesh.position, P * 4),
               "launches": LAUNCHES["gossip_mix"] - k2,
               "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
               "digest": {k: digest(v) for k, v in (("params", state["params"]),
                                                    ("mu", state["opt_state"]["mu"]),
                                                    ("nu", state["opt_state"]["nu"]))}}
        ref = held.setdefault(kind, state["params"].clone())
        rec["max_abs_diff_params"] = max(
            (float((state["params"][lo:lo + DIGEST_CHUNK] - ref[lo:lo + DIGEST_CHUNK])
                   .abs().max()) for lo in range(0, P, DIGEST_CHUNK)), default=0.0)
        if last[kind] == i:
            del held[kind]
        if opts.keep_rows:
            rec["rows"] = {"params": state["params"].cpu(),
                           "mu": state["opt_state"]["mu"].cpu(),
                           "nu": state["opt_state"]["nu"].cpu()}
        out["entries"].append(rec)
        state = step = None
    return out


def run_rank(rank: int, world: int, init: str, opts: Options) -> Dict[str, Any]:
    from repro_torch.launch.mesh import init_silo_mesh

    if torch.device(opts.device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores

    def say(line: str) -> None:  # one write a line: the ranks share stdout
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    mesh = init_silo_mesh(rank, world, init, backend=opts.backend, device=opts.device,
                          log=say if rank == 0 else (lambda line: None))
    return run_entries(mesh, opts)


def summarise(ranks: Sequence[Dict[str, Any]], opts: Options) -> Dict[str, Any]:
    """The entries over the ranks: the received bytes against the plan's
    (``recv_ok``), a plan's rows across its lowerings (``same_bits``
    against the plan's first entry), the last round's wall (warm when
    there are two or more), the largest
    peak, the K2 launches, the roofline with a rank's received bytes as
    its collective term, and the star/ring traffic ratio."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.analytic_model import analytic_step_flops
    from repro_torch.launch.roofline import make_roofline, model_flops_estimate

    r0 = ranks[0]
    n = len(ranks)
    cfg = config(n, opts)
    P = r0["P"]
    spec = dict(INPUT_SHAPES["train_4k"], seq_len=opts.seq_len, global_batch=opts.batch)
    flops = analytic_step_flops(cfg, spec, "train")
    model = model_flops_estimate(spec, float(P), "train")
    first: Dict[str, Dict[int, Any]] = {}
    rows = []
    for i, (kind, impl) in enumerate(ENTRIES):
        per = [r["entries"][i] for r in ranks]
        warm = [e["rounds"][-1] for e in per]
        recv = [e["rounds"][-1]["recv_bytes"] for e in per]
        recv_ok = all(rd["recv_bytes"] == e["expected_recv_bytes"]
                      for e in per for rd in e["rounds"])
        ref = first.setdefault(kind, {r["rank"]: e["digest"] for r, e in zip(ranks, per)})
        same = all(e["digest"] == ref[r["rank"]] for r, e in zip(ranks, per))
        wall = max(w["wall_s"] for w in warm)
        roof = make_roofline(arch=cfg.arch_id, shape=f"{kind}/{impl}", batch=opts.batch,
                             flops=flops, bytes_moved=6 * P * 4, model_flops=model,
                             coll_bytes=max(recv), measured={"step_s": wall})
        peaks = [e["peak_bytes"] for e in per]
        rows.append({
            "kind": kind, "impl": impl, "num_transfers": per[0]["num_transfers"],
            "K": per[0]["K"], "recv_bytes": recv, "recv_ok": recv_ok,
            "staged_bytes": [w["staged_bytes"] for w in warm],
            "staging_s": [w["staging_s"] for w in warm],
            "round_s": [[rd["wall_s"] for rd in e["rounds"]] for e in per],
            "last_round_s": wall, "losses": per[0]["rounds"][-1]["loss"],
            "peak_bytes": None if peaks[0] is None else max(peaks),
            "launches": [e["launches"] for e in per], "same_bits_as_first": same,
            "max_abs_diff_params": max(e["max_abs_diff_params"] for e in per),
            "first_of_plan": f"{kind}/{next(m for k, m in ENTRIES if k == kind)}",
            "roofline": asdict(roof)})
    total = {(r["kind"], r["impl"]): sum(r["recv_bytes"]) for r in rows}
    ring = total.get(("ring", "ppermute"))
    star = total.get(("star", "ppermute"))
    return {"arch": ARCH, "silos": n, "n_layers": r0["n_layers"], "d_model": r0["d_model"],
            "P": P, "options": asdict(opts),
            "entries": rows,
            "star_ring_traffic_ratio": (star / max(ring, 1)) if ring and star else None}


def run(silos: int = N_SILOS, opts: Options = Options()) -> Tuple[Dict[str, Any], List[Any]]:
    """Spawn ``silos`` ranks once for every entry; returns the summary and
    the ranks' raw records."""
    from repro_torch.launch.mesh import spawn

    ranks = spawn(run_rank, silos, opts)
    return summarise(ranks, opts), ranks


def table(summary: Dict[str, Any]) -> List[str]:
    lines = [f"{summary['arch']}: {summary['silos']} ranks, {summary['n_layers']} layers, "
             f"d_model {summary['d_model']}, P {summary['P']}"]
    for r in summary["entries"]:
        peak = "—" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2 ** 30:.2f} GiB"
        lines.append(
            f"{r['kind']:>6s}/{r['impl']:8s} transfers={r['num_transfers']:2d} K={r['K']} "
            f"recv/rank={max(r['recv_bytes']) / 2 ** 30:7.3f} GiB (== plan: {r['recv_ok']}) "
            f"staged={max(r['staged_bytes']) / 2 ** 30:6.3f} GiB in {max(r['staging_s']):.3f} s "
            f"last round={r['last_round_s']:.4f} s peak={peak} k2={r['launches']} "
            f"bits == {r['first_of_plan']}: {r['same_bits_as_first']} "
            f"(max abs params diff {r['max_abs_diff_params']:.3g})")
    if summary["star_ring_traffic_ratio"] is not None:
        lines.append(f"ring vs star gossip traffic ratio: "
                     f"{summary['star_ring_traffic_ratio']:.2f}x")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--silos", type=int, default=N_SILOS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    resolve_device(args.device)
    opts = Options(device=args.device, backend=args.dist_backend, layers=args.layers,
                   reduced=args.reduced, seq_len=args.seq_len, batch=args.batch,
                   rounds=args.rounds, seed=args.seed)
    summary, _ = run(args.silos, opts)
    for line in table(summary):
        print(line, flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "perf_gossip.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {path}")
    bad = [f"{r['kind']}/{r['impl']}" for r in summary["entries"] if not r["recv_ok"]]
    if bad:
        print(f"received bytes differ from the plan's: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
