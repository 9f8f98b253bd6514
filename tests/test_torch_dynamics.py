"""The port's dynamics subsystem against the JAX package, on the CPU.

Scenario events and their folding into epochs, the dense engines of
``repro_torch.core.maxplus_vec`` the simulator runs on, the simulator
itself (``simulate_dynamic``, ``simulate_scenarios_batched``,
``DynamicTimeline``) and the schedule pricing per epoch must give the
reference's bits.  The online controller, with the rewire climb off
(``rewire_restarts=0``: the climb draws from a torch generator, whose
stream differs from ``jax.random``'s), must make the reference's
re-designs field for field on Gaia under a link failure, silo churn and
a MATCHA re-fit on a degraded silo."""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.maxplus_vec as RV  # noqa: E402
import repro.dynamics as RD  # noqa: E402
import repro.fed.gossip as RG  # noqa: E402
import repro.fed.topology_runtime as RT  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.core.maxplus_vec as PV  # noqa: E402
import repro_torch.dynamics as PD  # noqa: E402
import repro_torch.dynamics.controller as ctl  # noqa: E402
import repro_torch.fed as PF  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.checkpoint.io import _leaves_with_keys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import ParamLayout, model_specs, state_to_tree  # noqa: E402

REF = dict(core=R, dyn=RD, slots=RG, runtime=RT, kw={})
PORT = dict(core=P, dyn=PD, slots=PF, runtime=PF, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default of one thread per core in each
    makes these small eager loops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gaia(pkg):
    C = pkg["core"]
    M, Tc = C.WORKLOADS["inaturalist"]
    u = C.make_underlay("gaia")
    return u, u.connectivity_graph(comp_time_ms=Tc), \
        C.TrainingParams(model_size_mbits=M, local_steps=1), Tc


def _event_fields(ev):
    return (type(ev).__name__, tuple(sorted(vars(ev).items())))


def _gc_fields(gc):
    return (gc.silos, dict(gc.latency_ms), dict(gc.available_bw_gbps),
            {v: (p.comp_time_ms, p.uplink_gbps, p.downlink_gbps)
             for v, p in gc.silo_params.items()})


def _scenarios(pkg):
    """Every scenario constructor on Gaia, as the reference launcher and
    tests build them."""
    D = pkg["dyn"]
    u, gc, tp, Tc = _gaia(pkg)
    ring = pkg["core"].design_overlay("ring", gc, tp, **pkg["kw"])
    tau = ring.cycle_time_ms
    out = {
        "static": D.static_scenario(u, Tc),
        "linkfail": D.link_failure_scenario(u, Tc, t_fail_ms=400 * tau / 3,
                                            overlay_edges=ring.edges, horizon_ms=400 * tau),
        "linkfail-nooverlay": D.link_failure_scenario(u, Tc, t_fail_ms=1000.0),
        "silodegrade": D.silo_degrade_scenario(u, Tc, silo=u.load_centrality_center(),
                                               t_ms=30 * tau, horizon_ms=300 * tau),
        "churn": D.churn_scenario(u, Tc, silo=5, t_leave_ms=20 * tau, t_rejoin_ms=50 * tau,
                                  horizon_ms=200 * tau),
    }
    for seed in range(4):
        for p in (0.15, 1.0):
            out[f"random-{seed}-{p}"] = D.random_scenario(u, Tc, seed=seed, p_churn=p,
                                                          horizon_ms=60 * tau)
    # a hand-built stream touching every event type and the restore /
    # clear-degradation semantics
    link = u.core_edges[0]
    out["mixed"] = D.Scenario(
        name="mixed", underlay=u, comp_time_ms=Tc, horizon_ms=10_000.0,
        events=(D.LinkDegraded(t_ms=1000.0, link=link, factor=0.1),
                D.ComputeStraggler(t_ms=1000.0, silo=2, factor=5.0),
                D.LinkFailed(t_ms=3000.0, link=link),
                D.SiloLeave(t_ms=5000.0, silo=4),
                D.LinkRestored(t_ms=6000.0, link=link),
                D.SiloJoin(t_ms=7000.0, silo=4),
                D.LinkDegraded(t_ms=8000.0, link=link, factor=1.0),
                D.ComputeStraggler(t_ms=8000.0, silo=2, factor=1.0)))
    return out


@pytest.fixture(scope="module")
def scenarios():
    return _scenarios(REF), _scenarios(PORT)


@pytest.mark.parametrize("name", ["static", "linkfail", "linkfail-nooverlay", "silodegrade",
                                  "churn", "mixed"]
                         + [f"random-{s}-{p}" for s in range(4) for p in (0.15, 1.0)])
def test_scenario_and_segments_equal_reference(scenarios, name):
    r, p = scenarios[0][name], scenarios[1][name]
    assert p.name == r.name and p.horizon_ms == r.horizon_ms
    assert [_event_fields(e) for e in p.events] == [_event_fields(e) for e in r.events]
    sr, sp = r.segments(), p.segments()
    assert len(sp) == len(sr)
    for er, ep in zip(sr, sp):
        assert (ep.t_start_ms, ep.t_end_ms, ep.active) == (er.t_start_ms, er.t_end_ms, er.active)
        assert _gc_fields(ep.gc) == _gc_fields(er.gc)
        assert _gc_fields(PD.active_subgraph(ep.gc, ep.active)) == \
            _gc_fields(RD.active_subgraph(er.gc, er.active))


def test_busiest_core_link_and_bad_events_equal_reference():
    ur, ur_gc, ur_tp, Tc = _gaia(REF)
    up, _, _, _ = _gaia(PORT)
    ring = R.design_overlay("ring", ur_gc, ur_tp)
    assert PD.busiest_core_link(up) == RD.busiest_core_link(ur)
    assert PD.busiest_core_link(up, ring.edges) == RD.busiest_core_link(ur, ring.edges)
    for bad in (lambda D: D.LinkDegraded(t_ms=0.0, link=(0, 1), factor=0.0),
                lambda D: D.ComputeStraggler(t_ms=0.0, silo=0, factor=-1.0),
                lambda D, u=up: D.churn_scenario(u, Tc, silo=1, t_leave_ms=5.0, t_rejoin_ms=2.0),
                lambda D, u=up: D.silo_degrade_scenario(u, Tc, silo=99, t_ms=1.0)):
        with pytest.raises(ValueError):
            bad(PD)
    state = PD.Scenario("s", up, Tc, (), 1.0).initial_state()
    with pytest.raises(ValueError):
        state.apply(PD.LinkFailed(t_ms=1.0, link=(0, 0)))


# ---------------------------------------------------------------------------
# Dense engines and the simulator


def test_dense_engines_equal_reference():
    rng = np.random.default_rng(0)
    for n in (1, 3, 11, 24):
        W = rng.uniform(1.0, 50.0, (n, n))
        W[rng.random((n, n)) < 0.5] = -np.inf
        Ws = np.stack([W, W * 1.5, W + 3.0])
        np.testing.assert_array_equal(PV.timing_recursion_dense(W, 40),
                                      RV.timing_recursion_dense(W, 40))
        t0 = rng.uniform(0, 10, n)
        np.testing.assert_array_equal(PV.timing_recursion_dense(W, 20, t0),
                                      RV.timing_recursion_dense(W, 20, t0))
        np.testing.assert_array_equal(PV.batched_timing_recursion(Ws, 30),
                                      RV.batched_timing_recursion(Ws, 30))
        assert PV.empirical_cycle_time_dense(W, 60) == RV.empirical_cycle_time_dense(W, 60)
        np.testing.assert_array_equal(PV.batched_throughput(Ws), RV.batched_throughput(Ws))
        starts = np.array([0.0, 40.0, 95.0])
        np.testing.assert_array_equal(PV.timing_recursion_piecewise(Ws, starts, 50),
                                      RV.timing_recursion_piecewise(Ws, starts, 50))
        B_starts = np.stack([starts, [0.0, 10.0, np.inf]])
        np.testing.assert_array_equal(
            PV.batched_timing_recursion_piecewise(np.stack([Ws, Ws[::-1]]), B_starts, 50),
            RV.batched_timing_recursion_piecewise(np.stack([Ws, Ws[::-1]]), B_starts, 50))
        t = rng.uniform(-5, 120, (2, n))
        np.testing.assert_array_equal(PV._epoch_of(starts, t[0]), RV._epoch_of(starts, t[0]))
        np.testing.assert_array_equal(PV._epoch_of(B_starts, t), RV._epoch_of(B_starts, t))
        tp_, cp = PV.critical_circuit_dense(W)
        tr_, cr = RV.critical_circuit_dense(W)
        assert (tp_ == tr_ or (math.isinf(tp_) and math.isinf(tr_))) and cp == cr
    assert PV.NEG_INF == RV.NEG_INF


@pytest.mark.parametrize("name", ["static", "linkfail", "churn", "mixed", "random-1-1.0"])
def test_simulate_dynamic_equals_reference(scenarios, name):
    u, gc, tp, _ = _gaia(REF)
    ring = R.design_overlay("ring", gc, tp)
    _, _, tpp, _ = _gaia(PORT)
    r = RD.simulate_dynamic(scenarios[0][name], tp, ring.edges, num_rounds=150)
    p = PD.simulate_dynamic(scenarios[1][name], tpp, ring.edges, num_rounds=150)
    for f in ("times", "round_finish_ms", "round_durations_ms", "epoch_starts_ms",
              "predicted_tau_ms", "empirical_tau_ms"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f), err_msg=f)
    deadline = 100 * ring.cycle_time_ms
    assert p.rounds_completed_by(deadline) == r.rounds_completed_by(deadline)
    assert p.throughput_loss_vs(ring.cycle_time_ms, deadline) == \
        r.throughput_loss_vs(ring.cycle_time_ms, deadline)


def test_simulate_scenarios_batched_equals_reference(scenarios):
    names = ["static", "linkfail", "churn", "random-0-0.15", "random-2-1.0"]
    _, gc, tp, _ = _gaia(REF)
    _, _, tpp, _ = _gaia(PORT)
    ring = R.design_overlay("ring", gc, tp)
    r = RD.simulate_scenarios_batched([scenarios[0][k] for k in names], tp, ring.edges, 80)
    p = PD.simulate_scenarios_batched([scenarios[1][k] for k in names], tpp, ring.edges, 80)
    np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("kind", ["overlay", "matcha", "swap"])
def test_dynamic_timeline_equals_reference(scenarios, kind):
    """``round_finish_ms`` of the plant under a fixed overlay, under a
    MATCHA schedule, and across a hot swap from one to the other."""
    lines = []
    for pkg, scs in ((REF, scenarios[0]), (PORT, scenarios[1])):
        C, D = pkg["core"], pkg["dyn"]
        u, gc, tp, _ = _gaia(pkg)
        ring = C.design_overlay("ring", gc, tp, **pkg["kw"])
        ms = C.matcha_schedule_from_underlay(u, 0.4, sample_seed=2)
        tl = D.DynamicTimeline(scs["random-1-1.0"], tp)
        if kind == "matcha":
            tl.set_schedule(ms)
        else:
            tl.set_overlay(ring.edges)
        durations = [tl.step() for _ in range(60)]
        if kind == "swap":
            tl.set_schedule(ms)
            durations += [tl.step() for _ in range(60)]
            tl.set_schedule(C.FixedSchedule(ring))
            durations += [tl.step() for _ in range(30)]
        lines.append((durations, list(tl.round_finish_ms), tl.current_active(),
                      tl.rounds_done, tl.now_ms))
    assert lines[1] == lines[0]


def test_schedule_epoch_estimates_equal_reference():
    ests = []
    for pkg in (REF, PORT):
        C, D = pkg["core"], pkg["dyn"]
        u, gc, tp, Tc = _gaia(pkg)
        ms = C.matcha_schedule_from_underlay(u, 0.3)
        sc = D.silo_degrade_scenario(u, Tc, silo=3, t_ms=5000.0, factor=0.02)
        ests.append(D.schedule_epoch_estimates(sc, tp, ms, rounds=50, seeds=(0, 1),
                                               **pkg["kw"]))
    assert len(ests[1]) == 2
    assert [(e.tau_ms, e.ci95_ms, e.per_seed_ms) for e in ests[1]] == \
        [(e.tau_ms, e.ci95_ms, e.per_seed_ms) for e in ests[0]]


# ---------------------------------------------------------------------------
# The online controller


def _overlay_fields(ov):
    return None if ov is None else (ov.name, tuple(ov.edges), ov.cycle_time_ms)


def _schedule_fields(s):
    if s is None:
        return None
    if not s.is_randomized:
        return ("fixed", _overlay_fields(s.overlay))
    return ("matcha", s.matchings, s.budget, s.sample_seed)


def _plan_fields(plan):
    return None if plan is None else (plan.matrix.tolist(), plan.terms, plan.n_silos)


def redesign_fields(rd):
    """Every field of a ``Redesign`` but its wall time (NaN as a string,
    so two NaNs compare equal)."""
    def num(x):
        return "nan" if isinstance(x, float) and math.isnan(x) else x

    return (rd.round_idx, _overlay_fields(rd.overlay), _plan_fields(rd.plan),
            num(rd.predicted_tau_ms), num(rd.measured_ms), rd.n_candidates, rd.bottleneck,
            num(rd.expected_window_ms), num(rd.drift), _schedule_fields(rd.schedule),
            rd.membership, num(rd.rho), rd.objective)


def controller_loop(pkg, case, recorder=None, silo_names=None):
    """The reference tests' closed loops, with the rewire climb off:
    ``(redesign records, slot versions, audit notes, rounds done)``.
    ``recorder`` (the package's flight recorder) is attached to the
    timeline and the controller, with ``silo_names``."""
    C, D, S = pkg["core"], pkg["dyn"], pkg["slots"]
    u, gc, tp, Tc = _gaia(pkg)
    ring = C.design_overlay("ring", gc, tp, **pkg["kw"])
    tau = ring.cycle_time_ms
    kw = dict(pkg["kw"])
    cfg = dict(seed=0, rewire_restarts=0)
    slot = mem = None
    if case == "linkfail":
        deadline = 400 * tau
        sc = D.link_failure_scenario(u, Tc, t_fail_ms=deadline / 3, overlay_edges=ring.edges,
                                     horizon_ms=deadline)
        rounds = None
        slot = S.PlanSlot(pkg["runtime"].plan_from_overlay(ring, gc.num_silos))
        kw["plan_slot"] = slot
    elif case == "churn-leave":  # SiloLeave at round 30, no membership signal
        sc = D.Scenario(name="churn", underlay=u, comp_time_ms=Tc, horizon_ms=200 * tau,
                        events=(D.SiloLeave(t_ms=30 * tau, silo=5),))
        rounds = 120
    elif case == "churn-membership":
        sc = D.churn_scenario(u, Tc, silo=5, t_leave_ms=20 * tau, t_rejoin_ms=50 * tau,
                              horizon_ms=200 * tau)
        rounds = 150
        slot = S.PlanSlot(pkg["runtime"].plan_from_overlay(ring, gc.num_silos))
        mem = S.MembershipSlot(range(u.num_silos), u.num_silos)
        kw.update(plan_slot=slot, membership_slot=mem)
    else:  # MATCHA re-fit on a degraded silo, tau or time-to-eps
        sc = D.silo_degrade_scenario(u, Tc, silo=3, t_ms=30 * tau, factor=0.02,
                                     horizon_ms=300 * tau)
        rounds = 100
        slot = S.ScheduleSlot(C.FixedSchedule(ring), gc.num_silos, silos=gc.silos)
        kw["schedule_slot"] = slot
        if case == "matcha":
            cfg.update(schedule_family="matcha", matcha_budgets=(0.1, 0.2, 0.3, 0.5),
                       matcha_rounds=80, matcha_seeds=(0, 1))
        else:
            cfg.update(schedule_family="matcha", objective="time_to_eps",
                       matcha_budgets=(0.3, 0.5), matcha_rounds=60, matcha_seeds=(0,),
                       mixing_rounds=60)
    tl = D.DynamicTimeline(sc, tp)
    if recorder is not None:
        tl.attach_recorder(recorder)
    tl.set_overlay(ring.edges)

    def provider():
        ep = tl.current_epoch()
        return D.active_subgraph(ep.gc, ep.active)

    if mem is not None:
        kw["membership_provider"] = tl.current_active
    ctl = D.OnlineTopologyController(gc, tp, ring, config=D.ControllerConfig(**cfg),
                                     connectivity_provider=provider, recorder=recorder,
                                     silo_names=silo_names, **kw)
    k = 0
    while (tl.now_ms < deadline) if rounds is None else (k < rounds):
        rd = ctl.observe_round(tl.step())
        if rd is not None:
            tl.set_schedule(rd.schedule)
        k += 1
    versions = (slot.version if slot is not None else None,
                mem.version if mem is not None else None)
    notes = list(slot.history) if slot is not None else []
    return ([redesign_fields(rd) for rd in ctl.redesigns], versions, notes,
            list(tl.round_finish_ms), ctl)


@pytest.mark.parametrize("case", ["linkfail", "churn-leave", "churn-membership", "matcha",
                                  "time_to_eps"])
def test_controller_redesigns_equal_reference(case):
    ref = controller_loop(REF, case)
    before = dict(LAUNCHES)
    port = controller_loop(PORT, case)
    assert dict(LAUNCHES) == before  # the CPU runs the plain versions
    assert port[0] == ref[0]
    assert port[1:4] == ref[1:4]
    redesigns = port[4].redesigns
    assert len(redesigns) >= 1
    if case == "linkfail":
        assert port[1][0] >= 2
        rd = redesigns[0]
        assert len(rd.bottleneck) >= 2 and rd.bottleneck[0] == rd.bottleneck[-1]
    elif case == "churn-membership":
        assert [rd.membership for rd in redesigns if rd.membership is not None] == \
            [tuple(v for v in range(11) if v != 5), tuple(range(11))]
    elif case in ("matcha", "time_to_eps"):
        assert redesigns[0].schedule.is_randomized and redesigns[0].overlay is None
    if case == "time_to_eps":
        r_rho = [f[11] for f in ref[0]]
        p_rho = [f[11] for f in port[0]]
        np.testing.assert_allclose(p_rho, r_rho, rtol=1e-12)
        assert all(0.0 < x < 1.0 for x in p_rho)


def test_design_best_overlay_and_schedule_equal_reference():
    _, gr, tr, _ = _gaia(REF)
    _, gp, tpp, _ = _gaia(PORT)
    br, sr = RD.design_best_overlay(gr, tr, n_candidates=64, rng=np.random.default_rng(3))
    bp, sp = PD.design_best_overlay(gp, tpp, n_candidates=64, rng=np.random.default_rng(3),
                                    device="cpu")
    assert (_overlay_fields(bp), sp) == (_overlay_fields(br), sr)
    rr = RD.search_ring_candidates(gr, tr, 128, np.random.default_rng(5))
    rp = PD.search_ring_candidates(gp, tpp, 128, np.random.default_rng(5))
    assert _overlay_fields(rp) == _overlay_fields(rr)
    kw = dict(n_candidates=32, rewire_restarts=0, matcha_budgets=(0.2, 0.5),
              matcha_rounds=40, matcha_seeds=(0,), objective="time_to_eps", mixing_rounds=40)
    sched_r, nr = RD.design_best_schedule(gr, tr, **kw)
    sched_p, np_ = PD.design_best_schedule(gp, tpp, device="cpu", **kw)
    assert (_schedule_fields(sched_p), np_) == (_schedule_fields(sched_r), nr)


# ---------------------------------------------------------------------------
# In-process runs of the launcher (the reference's acceptance patterns)

MEMBERSHIP = (r"membership v(\d+): (\d+) -> (\d+) silos \(left \[([\d, ]*)\], "
              r"joined \[([\d, ]*)\]\)")
REBUILT = r"mesh\+state rebuilt, survivors-bit-identical=(\w+), joiners-at-consensus=(\w+)"


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _run(tmp_path, **kw):
    lines, migrations = [], []

    def keep(info):  # the leavers' rows and the migrated rows, before the old buffers go
        old = info["old_state"]
        rows = {v: {k: old[k][info["old_active"].index(v)].clone()
                    for k in ("params", "opt_state")} for v in info["left"]}
        migrations.append(dict(info, rows=rows, step=old["step"], old_state=None,
                               new_state=None))

    res = train(get_config("internlm2-1.8b").reduced(), dynamic=True, seq_len=16,
                batch_per_silo=2, device="cpu", verify_migration=True, log=lines.append,
                churn_checkpoint=str(tmp_path / "leavers"), on_migration=keep, **kw)
    return res, "\n".join(lines), migrations


@pytest.mark.parametrize("case", ["churn", "random"])
def test_train_dynamic_churn_rebuilds_state(tmp_path, case):
    kw = (dict(scenario="churn", steps=12, gossip_impl="pallas",
               checkpoint=str(tmp_path / "final.msgpack")) if case == "churn"
          else dict(scenario="random", p_churn=1.0, scenario_seed=0, steps=35))
    res, out, migrations = _run(tmp_path, **kw)
    swaps = re.findall(MEMBERSHIP, out)
    assert len(swaps) >= 2, out[-2000:]
    leavers = {s for _, _, _, left, _ in swaps for s in left.split(", ") if s}
    joiners = {s for _, _, _, _, jn in swaps for s in jn.split(", ") if s}
    assert leavers and (leavers & joiners), swaps
    assert any(int(a) > int(b) for _, a, b, _, _ in swaps)
    assert any(int(a) < int(b) for _, a, b, _, _ in swaps)
    rebuilds = re.findall(REBUILT, out)
    assert len(rebuilds) == len(swaps) == len(migrations)
    assert all(s == "True" and j == "True" for s, j in rebuilds), rebuilds
    assert "membership swap(s)" in out and "dynamic summary:" in out
    assert all(np.isfinite(res.losses)) and len(res.rounds) == kw["steps"]
    # each round trained on the active set of its start; K is the plan's transfers
    ns = [r["n"] for r in res.rounds]
    assert min(ns) < 11 and ns[-1] == len(res.active) == res.state["params"].shape[0]
    layout = ParamLayout(model_specs(res.cfg))
    for m in migrations:  # every leaver's checkpoint holds its pre-migration row
        for v, path in zip(m["left"], m["checkpoints"]):
            like = state_to_tree(dict(m["rows"][v], step=m["step"]), layout)
            got = load_checkpoint(path, like)
            for key, leaf in _leaves_with_keys(like):
                assert torch.equal(_leaf(got, key), torch.from_numpy(leaf)), key
            assert f"leaver silo {v} checkpoint -> {path}" in out
    if case == "churn":
        assert [(m["left"], m["joined"]) for m in migrations] == [((5,), ()), ((), (5,))]
        assert "checkpoint -> " + str(tmp_path / "final.msgpack") in out
        like = state_to_tree(res.state, layout)["params"]
        final = load_checkpoint(str(tmp_path / "final.msgpack"), like)
        for key, leaf in _leaves_with_keys(like):
            assert torch.equal(_leaf(final, key), torch.from_numpy(leaf)), key


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-moe-30b-a3b"])
def test_train_dynamic_churn_on_hybrid_and_moe(arch):
    """``--dynamic`` churn on the reduced hybrid (attention + Mamba) and MoE
    configs: both membership swaps migrate the whole parameter tree with
    survivors bit-identical and joiners at consensus, losses finite."""
    lines = []
    res = train(get_config(arch).reduced(), dynamic=True, scenario="churn", steps=6,
                gossip_impl="pallas", seq_len=16, batch_per_silo=2, device="cpu",
                verify_migration=True, log=lines.append)
    out = "\n".join(lines)
    swaps = re.findall(MEMBERSHIP, out)
    rebuilds = re.findall(REBUILT, out)
    assert [(a, b) for _, a, b, _, _ in swaps] == [("11", "10"), ("10", "11")], out[-2000:]
    assert len(rebuilds) == 2 and all(s == j == "True" for s, j in rebuilds), rebuilds
    assert all(np.isfinite(res.losses)) and len(res.losses) == 6
    assert res.state["params"].shape == (11, ParamLayout(model_specs(res.cfg)).size)


def test_train_dynamic_matcha_hot_swaps_to_a_randomized_schedule(tmp_path):
    res, out, _ = _run(tmp_path, designer="matcha", scenario="silodegrade", steps=30)
    assert "matcha schedule (budget sweep" in out
    assert "controller re-design -> randomized schedule" in out, out[-2000:]
    assert "final randomized schedule" in out
    assert len(res.consensus) == 30 and res.fed.gossip_impl == "einsum"


def test_undeployable_rewire_result_is_left_out(monkeypatch):
    """A directed rewire result with unbalanced degrees (the one the CPU
    climb picked in the random-churn run) has no doubly-stochastic
    consensus matrix: the pool leaves it out but counts its proposals."""

    _, gc, tp, _ = _gaia(PORT)
    arcs = ((0, 4), (1, 2), (2, 0), (3, 1), (4, 5), (4, 10), (5, 4), (6, 8), (6, 9), (7, 6),
            (8, 7), (9, 3), (10, 8))
    directed = P.evaluate_overlay(gc, tp, arcs, "sparse_rewire")
    assert not ctl._deployable(directed, gc)
    assert ctl._deployable(P.ring_overlay(gc, tp), gc)
    monkeypatch.setattr(ctl, "search_overlays_jit", lambda *a, **k: directed)
    pool, scored = ctl._overlay_candidates(gc, tp, n_candidates=16, rewire_restarts=2,
                                           rewire_steps=5, device="cpu")
    assert directed not in pool and scored == 4 + 16 + 2 * 5
    assert all(ctl._deployable(ov, gc) for ov in pool)
