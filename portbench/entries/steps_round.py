"""Entry ``steps_round``: the program's DPASGD step from
``repro_torch.launch.steps.build_train_step``, driven by the harness
round by round in a closed loop.

Set-up draws the silos' rows from the seed (the reference's recipe, on
the card), builds the step with the cell's optimizer, gossip lowering and
the ring plan, and runs the first rounds, which the reference follows
later and which warm every shape.  The window then runs rounds until
``seconds`` have passed, each round's tokens drawn on the card from
``(seed, round)``; a round ends when its loss reaches the host.  A
traced run also profiles the window's first rounds and times every
optimizer update with CUDA events.  Once the window has closed and the
peak is read, the program's state is freed and the reference follows
the first rounds from the same rows and tokens.
"""

from __future__ import annotations

import time

import torch

from portbench import core, training, yardstick
from portbench.reference import model as M
from portbench.reference import recipes


def run(ctx):
    from repro_torch.fed.topology_runtime import plan_for_n_silos
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    t = ctx.cell["traffic"]
    n, s, B, S = t["silos"], t["local_steps"], t["batch_per_silo"], t["seq_len"]
    d, dev, opts = ctx.dims, ctx.device, ctx.options
    shape = (n, s, B, S)
    cuda = dev.type == "cuda"

    def batch(r):
        return recipes.round_tokens(ctx.seed, r, shape, d.vocab_size, dev)

    phases = {"start_to_entry": time.perf_counter() - ctx.t_start}
    t_phase = time.perf_counter()
    cfg = ctx.model_config(n_silos=n)
    opt = adamw(float(t["lr"]))
    timed = training.TimedOptimizer(opt, streams=7) if ctx.trace and cuda else None
    impl = "none" if opts.get("fault") == "no_mix" else t["gossip_impl"]
    plan = plan_for_n_silos(t["topology"], n)
    step = training.faulty(build_train_step(cfg, optimizer=timed or opt, gossip_impl=impl,
                                            plan=plan, local_steps=s), opts.get("fault", ""))
    params = M.init_rows(d, n, ctx.seed, dev)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    del params
    phases["weights_and_step"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # the first rounds: warm-up, and what the reference follows
    training.tf32(opts.get("control") == "tf32")
    prog = {"losses": []}
    for r in range(training.CHECK_ROUNDS):
        state, m = step(state, batch(r))
        prog["losses"].append(float(m["loss"]))
        phases[f"check_round_{r}"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        if r == 0:
            prog["grad"] = core.leaf_norms(training.slot_rows(state["opt_state"]),
                                           M.leaf_table(d))
    prog["delta"] = core.delta_norms(state["params"], d, ctx.seed)
    phases["check_norms"] = time.perf_counter() - t_phase
    if opts.get("check_only"):
        training.tf32(False)
        del state
        return dict(_judge(ctx, t, n, batch, prog), attempted=0, failed=0)

    # the window
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    profile, named = None, None
    trace_rounds = int(ctx.cell.get("trace_rounds", 3))
    profiler = None
    if timed is not None:
        yardstick.warm_profiler(dev)
        timed.arm()
        profiler = yardstick.profiler(host=False)
        profiler.start()
    marks, losses = [], []
    r = training.CHECK_ROUNDS
    t0 = time.perf_counter()
    marks.append(t0)
    while True:
        state, m = step(state, batch(r))
        losses.append(float(m["loss"]))
        r += 1
        if profiler is not None and len(losses) == trace_rounds:
            # the device-only window is read once the window has closed;
            # one more round traces the host as well, to name the idle gaps
            profiler.stop()
            traced = (profiler, time.perf_counter() - t0)
            profiler = named = yardstick.profiler(host=True)
            profiler.start()
        elif profiler is not None and len(losses) == trace_rounds + 1:
            profiler.stop()
            profiler = None
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= ctx.seconds and profiler is None:
            break
    training.tf32(False)
    if timed is not None:
        profile = yardstick.read_profile(traced[0], traced[1], trace_rounds, named=named)
    rounds = len(losses)
    rec = {
        "attempted": rounds,
        "failed": sum(1 for x in losses if x != x or x in (float("inf"), float("-inf"))),
        "setup_s": t0 - ctx.t_start,
        "window_s": marks[-1] - t0,
        "round_s": [b - a for a, b in zip(marks, marks[1:])],
        "tokens": [n * s * B * S] * rounds,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
        "flops_per_token": yardstick.train_flops_per_token(d, S),
        "profile": profile,
        "profiled": list(range(trace_rounds + 1)) if profile is not None else [],
        "setup_phases": phases,
    }
    if profile is not None:
        row_bytes = n * M.row_size(d) * 4
        profile["mix_bytes"] = (len(plan.terms) + 1) * row_bytes * trace_rounds
        rec["optimizer"] = {"bytes": timed.bytes(), "seconds": timed.seconds()}
    del state, m
    rec.update(_judge(ctx, t, n, batch, prog))
    return rec


def _judge(ctx, t, n, batch, prog):
    """Follow the first rounds with the reference (the caller has freed
    the program's state) and compare."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    arcs = [(i, (i + 1) % n) for i in range(n)]    # the ring over the silos in label order
    A = M.ring_matrix_from_arcs(arcs, n)
    ref = training.reference(ctx, n, batch, lambda r: A,
                             {"kind": "adamw", "lr": float(t["lr"])})
    checks = training.training_checks(prog, ref, ctx.cell["limits"])
    return {"checks": checks, "prog": prog, "ref": ref}

