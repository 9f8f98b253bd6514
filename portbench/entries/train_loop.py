"""Entry ``train_loop``: the program's training loop,
``repro_torch.launch.train.train``, called once for the check rounds and
the window together.

``train()`` builds the silos' state from the seed, designs the overlay or
the schedule, and trains ``CHECK_ROUNDS + R`` rounds: the first rounds
warm every shape and are what the reference follows; the window is the
R rounds after them.  The harness observes the loop without changing
it: it wraps ``train``'s ``batch_to_device`` to mark when each round
moves its batch to the card (a round runs from its mark to the next),
``make_train_step`` to read the optimizer's slot after round 0, the rows'
change after the check rounds, each plan a step is built on and, under
MATCHA, each round's consensus matrix, and the controller's re-design to
keep the network it designed on.  ``on_migration`` checks each migration
against the reference while the old state still exists, and the round
after it copies, into host memory set aside in set-up, the rows that
one silo's new row is mixed from and that row after the round.  The
time of these copies and of the migration check is the harness's, and
is taken out of its round and of the window.  A traced run profiles
``trace_rounds`` rounds near the window's end, clear of the scenario's
events.  After ``train()`` returns, the state is freed and the reference
follows the check rounds and each round after a migration, and
recomputes each re-design's cycle time and each plan's consensus matrix.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

from portbench import core, training, yardstick
from portbench.reference import designer, dpasgd, membership, recipes
from portbench.reference import model as M

MIN_ROUNDS = 12  # window rounds at the least, and a check run's rounds after the check rounds


def run(ctx):
    import repro_torch.launch.train as TR
    from repro_torch.dynamics.controller import OnlineTopologyController as CTL
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics as obs_metrics

    t_entry = time.perf_counter()
    t = ctx.cell["traffic"]
    d, dev, opts = ctx.dims, ctx.device, ctx.options
    cuda = dev.type == "cuda"
    kw = dict(t["train"])
    s, B, S = kw["local_steps"], kw["batch_per_silo"], kw["seq_len"]
    W = training.CHECK_ROUNDS
    # a check run keeps MIN_ROUNDS rounds after the check rounds, so that
    # the scenario's events fall where they fall in a run
    R = MIN_ROUNDS if opts.get("check_only") else max(
        MIN_ROUNDS, round(ctx.seconds * t["rounds_per_second"]))
    if t.get("sample_seed_from_seed"):
        kw["scenario_seed"] = ctx.seed % 2 ** 32
    if opts.get("fault") == "no_mix":
        kw["gossip_impl"] = "none"
    if cuda:
        for name in ctx.cell.get("kernels", []):
            _build.load_library(name)   # built once per checkout, loaded before the window
    trace = ctx.trace and cuda and R > 0
    # the profiled rounds end one round before the window does, after the
    # scenario's events (at a quarter and half of the rounds)
    k_prof = int(ctx.cell.get("trace_rounds", 3))
    prof_from = W + R - k_prof - 2
    prof_to = prof_from + k_prof
    prof = {}

    t_pin = time.perf_counter()
    host = _HostRows(5 * int(t.get("migrations", 0)), M.row_size(d), cuda)
    t_pin = time.perf_counter() - t_pin
    marks, mats, builds, designs, follow = [], [], [], [], []
    prog = {}
    migrations = {"count": 0, "faults": 0, "last": None}
    calls = [0]
    to_device, make_step, redesign = TR.batch_to_device, TR.make_train_step, CTL._redesign

    def marked_to_device(raw, device):
        # rounds prof_from .. prof_to - 1 trace the device alone, round
        # prof_to the host as well (to name the idle gaps)
        k = len(marks)
        if k == W and cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        if trace and k in (prof_to, prof_to + 1):
            prof["named" if k > prof_to else "device"].stop()
        marks.append(time.perf_counter())
        if trace and k in (prof_from, prof_to):
            prof["named" if k == prof_to else "device"] = p = yardstick.profiler(k == prof_to)
            p.start()
        return to_device(raw, device)

    def observed_redesign(self, *args, **kwargs):
        out = redesign(self, *args, **kwargs)
        designs.append((_plain_network(self.gc, self.tp), out))
        return out

    def observed_step(cfg, fed, opt, plan, **kwargs):
        mig = migrations["last"] if migrations["count"] > len(follow) else None
        prev = builds[-1]["plan"] if builds else None
        builds.append({"plan": plan, "design": len(designs) - 1,
                       "order": tuple(migrations["last"]["new_active"]) if migrations["last"]
                       else None})
        step = training.faulty(make_step(cfg, fed, opt, plan, **kwargs), opts.get("fault", ""))
        if mig is not None:
            follow.append(_follow_entry(mig, prev, plan, designs[-1][1] if designs else None))

        def run_step(state, batch, *args):
            k = calls[0]
            calls[0] += 1
            watch = follow[-1] if mig is not None and "round" not in follow[-1] else None
            if watch is not None:
                slot = training.slot_rows(state["opt_state"])
                with host.clock(k):
                    watch.update(round=k, pre={c: (host.take(state["params"][c]),
                                                   host.take(slot[c])) for c in watch["rows"]})
            out, metrics = step(state, batch, *args)
            if watch is not None:
                with host.clock(k):
                    watch["post"] = host.take(out["params"][watch["j"]])
            if args:
                mats.append(np.array(args[0], dtype=np.float64))
            if k == 0:
                prog["grad"] = core.leaf_norms(training.slot_rows(out["opt_state"]),
                                               M.leaf_table(d))
            if k == W - 1:
                prog["delta"] = core.delta_norms(out["params"], d, ctx.seed)
            return out, metrics

        return run_step

    def on_migration(rec):
        migrations["count"] += 1
        migrations["last"] = {k: rec[k] for k in ("old_active", "new_active", "joined")}
        with host.clock(calls[0] - 1):
            migrations["faults"] += membership.migration_faults(
                rec["old_state"], rec["new_state"], rec["old_active"], rec["new_active"])

    if trace:
        yardstick.warm_profiler(dev)
        obs_metrics.REGISTRY.reset()
    training.tf32(opts.get("control") == "tf32")
    TR.batch_to_device, TR.make_train_step = marked_to_device, observed_step
    CTL._redesign = observed_redesign
    try:
        result = TR.train(ctx.model_config(), steps=W + R, seed=ctx.seed, device=dev,
                          on_migration=on_migration, trace_out="", log=_quiet, **kw)
        t_end = time.perf_counter()
    finally:
        TR.batch_to_device, TR.make_train_step = to_device, make_step
        CTL._redesign = redesign
        training.tf32(False)
    prog["losses"] = result.losses[:W]

    rec = {"attempted": R, "failed": sum(1 for x in result.losses[W:] if not np.isfinite(x))}
    if R:
        marks.append(t_end)
        n_all = kw.get("silos", 0)
        n_round = [r["n"] for r in result.rounds] or [n_all] * (W + R)
        peaks = [r.get("peak_bytes", 0) for r in result.rounds[W:]]
        rec.update({
            "setup_s": marks[W] - ctx.t_start,
            # the harness's own work in the window (its copies, the migration
            # check) is not the program's time
            "window_s": t_end - marks[W] - sum(host.seconds.values()),
            "round_s": [b - a - host.seconds.get(W + i, 0.0)
                        for i, (a, b) in enumerate(zip(marks[W:], marks[W + 1:]))],
            "tokens": [n * s * B * S for n in n_round[W:]],
            "peak_bytes": max(peaks + [torch.cuda.max_memory_allocated(dev) if cuda else 0]),
            "flops_per_token": yardstick.train_flops_per_token(d, S),
            "profiled": list(range(prof_from - W, prof_to - W + 1)) if trace else [],
            "setup_phases": dict({"start_to_entry": t_entry - ctx.t_start,
                                  "host_rows": t_pin,
                                  "entry_to_round_0": marks[0] - t_entry - t_pin},
                                 **{f"check_round_{r}": marks[r + 1] - marks[r] for r in range(W)}),
        })
        if trace:
            profile = yardstick.read_profile(prof["device"], marks[prof_to] - marks[prof_from],
                                             k_prof, named=prof["named"])
            P = M.row_size(d)
            if result.rounds:
                profile["mix_bytes"] = sum((r["K"] + 1) * r["n"] * P * 4
                                           for r in result.rounds[prof_from:prof_to])
            rec["profile"] = profile
            hist = obs_metrics.histogram("controller.redesign_s").snapshot()
            rec["redesign_mean_s"] = hist["mean"] if hist.get("count") else None
    n0 = len(builds[0]["plan"].matrix) if builds and builds[0]["plan"] is not None \
        else kw.get("silos")
    del result
    for b in builds:
        b["plan"] = None if b["plan"] is None else np.asarray(b["plan"].matrix, np.float64)
    if cuda:
        torch.cuda.empty_cache()
    rec.update(_judge(ctx, t, kw, prog, builds, n0, mats, designs, migrations, follow, R))
    return rec


def _plain_network(gc, tp):
    """The network a re-design saw, as plain data (``reference.designer``)."""
    par = gc.silo_params
    return {"silos": list(gc.silos), "latency_ms": dict(gc.latency_ms),
            "available_bw_gbps": dict(gc.available_bw_gbps),
            "comp_time_ms": {v: par[v].comp_time_ms for v in gc.silos},
            "uplink_gbps": {v: par[v].uplink_gbps for v in gc.silos},
            "downlink_gbps": {v: par[v].downlink_gbps for v in gc.silos},
            "model_size_mbits": tp.model_size_mbits, "local_steps": tp.local_steps}


def _follow_entry(mig, prev_plan, plan, design):
    """What the round after a migration keeps: the silo ``j`` whose new row
    the reference recomputes (a joiner, else one that took from a
    leaver), the reference's weights for that row and the rows they and
    the program's plan take from, in the new row order."""
    old, new = tuple(mig["old_active"]), tuple(mig["new_active"])
    j = new.index(mig["joined"][0]) if mig["joined"] else 0
    if not mig["joined"] and prev_plan is not None:
        A = np.asarray(prev_plan.matrix)
        took = [v for r, v in enumerate(old) if v in new and
                any(A[r, c] and old[c] not in new for c in range(len(old)))]
        j = new.index(took[0]) if took else 0
    try:
        row = designer.consensus_matrix(design.overlay.name, design.overlay.edges, new)[j]
    except (AttributeError, ValueError):
        row = None   # no fixed overlay, or one the rule refuses: judged as a fault
    taken = set() if row is None else {c for c, a in enumerate(row) if a}
    if plan is not None and len(plan.matrix) == len(new):
        taken |= {c for c in range(len(new)) if plan.matrix[j][c]}
    return {"j": j, "order": new, "weights": row, "rows": sorted(taken | {j})}


class _HostRows:
    """Rows on the host for the rounds after the migrations, allocated in
    set-up (pinned, on a card) so that each copy inside the window is one
    transfer into memory that is already there: ``count`` rows of ``size``
    float32, and a fresh one past them.  ``clock(round)`` times the
    harness's own work in a round (``seconds`` per round), after the card
    has finished the work queued before it, which is the program's."""

    def __init__(self, count: int, size: int, pin: bool):
        self._free = [torch.empty(size, pin_memory=pin) for _ in range(count)]
        self._cuda = pin
        self.seconds: Dict[int, float] = {}

    @contextmanager
    def clock(self, round_idx: int):
        if self._cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        self.seconds[round_idx] = self.seconds.get(round_idx, 0.0) + time.perf_counter() - t0

    def take(self, row):
        buf = self._free.pop() if self._free else torch.empty(row.numel())
        return buf.copy_(row)


def _judge(ctx, t, kw, prog, builds, n, mats, designs, migrations, follow, R):
    """Follow the check rounds with the reference and compare; judge the
    window's migrations, re-designs, plans and sampled matrices, and
    follow the round after each migration."""
    limits = ctx.cell["limits"]
    stream = recipes.LMStream(ctx.dims.vocab_size, kw["seq_len"], n)
    dev = ctx.device
    momentum = {"kind": "momentum", "lr": kw.get("lr", 0.05), "beta": 0.9}

    def batch(r, silos=range(n)):
        raw = recipes.stream_batch(stream, r, silos, kw["local_steps"], kw["batch_per_silo"])
        return {k: torch.from_numpy(v).to(dev, torch.long) for k, v in raw.items()}

    checks = []
    if kw.get("designer") == "matcha":
        budget, sample_seed = kw["matcha_budget"], kw.get("scenario_seed", 0)
        matchings = recipes.greedy_matchings(n)

        def matrix(r):
            return recipes.matcha_matrix(n, budget, sample_seed, r, matchings)

        gap = max((float(np.abs(a - matrix(r)).max()) for r, a in enumerate(mats)), default=0.0)
        checks.append(core.check("matcha_matrix_gap", gap, limits["matcha_matrix_gap"]))
    else:
        A0 = builds[0]["plan"]
        arcs = [(i, j) for i in range(n) for j in range(n) if i != j and A0[j, i] > 0]
        ring = M.ring_matrix_from_arcs(arcs, n)    # the designer's answer, judged as a ring

        def matrix(r):
            return ring

    ref = training.reference(ctx, n, batch, matrix, momentum)
    checks = training.training_checks(prog, ref, limits) + checks
    if kw.get("dynamic") and R:
        checks += _judge_dynamics(ctx, builds, n, designs, migrations, follow, batch, momentum,
                                  t["migrations"], limits)
    return {"checks": checks, "prog": prog, "ref": ref}


def _judge_dynamics(ctx, builds, n, designs, migrations, follow, batch, momentum, expected,
                    limits):
    """The churn cell's own numbers: each migration against the float64
    survivor mean, each re-design's overlay (spanning the active silos,
    strongly connected) and its cycle time against Karp's on the network
    it saw (with ``control``, Karp in float32 put in the program's
    place), each rebuilt plan's matrix against the rule's, and silo j's
    row after the round that follows each migration."""
    faults, tau_gap = 0, 0.0
    active = tuple(range(n))
    for net, r in designs:
        active = tuple(r.membership) if r.membership is not None else active
        arcs = r.overlay.edges if r.overlay is not None else r.schedule.round_edges(0)
        faults += membership.overlay_faults(arcs, active)
        if r.overlay is None:
            tau_gap = float("inf")
            continue
        name = r.overlay.name
        want = designer.overlay_cycle_time_ms(net, name, arcs)
        got = (designer.overlay_cycle_time_ms(net, name, arcs, np.float32)
               if ctx.options.get("control") == "tf32" else r.predicted_tau_ms)
        tau_gap = max(tau_gap, abs(got - want) / want)
    plan_gap = 0.0
    for b in builds[1:]:
        r = designs[b["design"]][1] if b["design"] >= 0 else None
        try:
            want = np.asarray(designer.consensus_matrix(r.overlay.name, r.overlay.edges,
                                                        b["order"] or range(n)))
        except (AttributeError, ValueError):
            want = None
        got = b["plan"]
        plan_gap = max(plan_gap, float(np.abs(got - want).max())
                       if want is not None and got is not None and got.shape == want.shape
                       else float("inf"))
    follow_gap, followed = 0.0, 0
    table = M.leaf_table(ctx.dims)
    for f in follow:
        if "post" not in f:
            continue
        followed += 1
        if f["weights"] is None:
            follow_gap = float("inf")
            continue
        rows = {c: (p.to(ctx.device), m.to(ctx.device)) for c, (p, m) in f["pre"].items()}
        weights = {c: f["weights"][c] for c in rows}
        new, grads = dpasgd.one_round_row(ctx.dims, rows, batch(f["round"], [f["order"][c]
                                                                            for c in sorted(rows)]),
                                          weights, momentum)
        pre = rows[f["j"]][0]
        prog = core.leaf_norms((f["post"].to(ctx.device) - pre)[None], table)
        want = core.leaf_norms((new - pre)[None], table)
        rule = yardstick.moving_leaves([grads[f["j"]]])
        follow_gap = max(follow_gap, yardstick.worst_leaf_gap(prog, want, rule))
        del rows, new, pre
    return [
        core.check("migration_faults", migrations["faults"], limits["migration_faults"]),
        core.check("migrations_missing", max(0, expected - min(migrations["count"], followed)),
                   limits["migrations_missing"]),
        core.check("redesign_faults", faults, limits["redesign_faults"]),
        core.check("tau_gap", tau_gap, limits["tau_gap"]),
        core.check("plan_matrix_gap", plan_gap, limits["plan_matrix_gap"]),
        core.check("follow_gap", follow_gap, limits["follow_gap"]),
    ]


def _quiet(line: str) -> None:
    """``train()``'s progress lines are not the benchmark's output."""
