"""MATCHA schedules of the port against the JAX package, on the CPU.

The sampling (edge coloring, the counter-based ``round_active`` draw and
the ``random.Random`` activation stream) must give the reference's
values, and the pricing -- Eq. 3 of the distinct activation rows on the
host, the round-varying Eq. 4 recursion through the port's
``timing_recursion`` (its plain version here) -- the reference's bits:
``average_cycle_times_batched`` on Gaia, AWS NA and Géant, the budget
sweep under both objectives, fixed schedules, the legacy scalar oracle
and a row of the paper's Table 10."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402

NETS = ("gaia", "aws_na", "geant")


def _both(net, **kw):
    M, Tc = R.WORKLOADS["inaturalist"]
    ur, up = R.make_underlay(net, **kw), P.make_underlay(net, **kw)
    return ((ur, ur.connectivity_graph(comp_time_ms=Tc),
             R.TrainingParams(model_size_mbits=M, local_steps=1)),
            (up, up.connectivity_graph(comp_time_ms=Tc),
             P.TrainingParams(model_size_mbits=M, local_steps=1)))


@pytest.mark.parametrize("seed", range(4))
def test_greedy_edge_coloring_equals_reference(seed):
    rng = random.Random(seed)
    n = rng.randint(3, 20)
    pairs = sorted({tuple(sorted(rng.sample(range(n), 2))) for _ in range(3 * n)})
    assert P.greedy_edge_coloring(pairs) == R.greedy_edge_coloring(pairs)


@pytest.mark.parametrize("budget", [0.1, 0.5, 1.0])
def test_sampling_equals_reference(budget):
    (_, gr, _), (_, gp, _) = _both("geant")
    sr = R.matcha_schedule_from_connectivity(gr, budget, sample_seed=3)
    sp = P.matcha_schedule_from_connectivity(gp, budget, sample_seed=3)
    assert sp.matchings == sr.matchings
    for k in range(40):
        assert sp.round_active(k) == sr.round_active(k)
        assert sp.round_edges(k) == sr.round_edges(k)
    for seed in (0, 5):
        np.testing.assert_array_equal(sp.activation_masks(150, seed),
                                      sr.activation_masks(150, seed))


@pytest.mark.parametrize("net", NETS)
def test_average_cycle_times_batched_bit_identical(net):
    (_, gr, tr), (_, gp, tpp) = _both(net)
    mr = R.matcha_schedule_from_connectivity(gr).matchings
    mp = P.matcha_schedule_from_connectivity(gp).matchings
    budgets = (0.1, 0.3, 0.6, 1.0)
    want = R.average_cycle_times_batched(
        [R.MatchaSchedule(matchings=mr, budget=b) for b in budgets], gr, tr,
        rounds=60, seeds=(0, 1))
    before = dict(LAUNCHES)
    got = P.average_cycle_times_batched(
        [P.MatchaSchedule(matchings=mp, budget=b) for b in budgets], gp, tpp,
        rounds=60, seeds=(0, 1), device="cpu")
    assert LAUNCHES == before  # the CPU takes the plain version
    assert got.shape == (4, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("objective", ["tau", "time_to_eps"])
def test_design_matcha_schedule_equals_reference(objective):
    (_, gr, tr), (_, gp, tpp) = _both("aws_na")
    sr, er = R.design_matcha_schedule(gr, tr, rounds=50, seeds=(0, 1, 2), objective=objective)
    sp, ep = P.design_matcha_schedule(gp, tpp, rounds=50, seeds=(0, 1, 2), objective=objective,
                                      device="cpu")
    assert (sp.budget, sp.matchings, sp.sample_seed) == (sr.budget, sr.matchings, sr.sample_seed)
    assert (ep.tau_ms, ep.ci95_ms, ep.per_seed_ms) == (er.tau_ms, er.ci95_ms, er.per_seed_ms)
    if objective == "tau":
        assert np.isnan(ep.rho) and np.isnan(er.rho)
    else:
        assert ep.rho == er.rho


def test_design_schedule_kinds_equal_reference():
    (_, gr, tr), (_, gp, tpp) = _both("gaia")
    assert P.SCHEDULE_KINDS == R.SCHEDULE_KINDS
    sr = R.design_schedule("matcha", gr, tr)
    sp = P.design_schedule("matcha", gp, tpp, device="cpu")
    assert (sp.budget, sp.matchings) == (sr.budget, sr.matchings)
    fr = R.design_schedule("ring", gr, tr)
    fp = P.design_schedule("ring", gp, tpp, device="cpu")
    assert isinstance(fp, P.FixedSchedule) and fp.overlay.edges == fr.overlay.edges
    assert fp.price(gp, tpp, device="cpu").tau_ms == fr.price(gr, tr).tau_ms


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_fixed_schedule_price_and_simulated_rounds(net):
    (_, gr, tr), (_, gp, tpp) = _both(net)
    fr = R.FixedSchedule(R.ring_overlay(gr, tr))
    fp = P.FixedSchedule(P.ring_overlay(gp, tpp))
    er, ep = fr.price(gr, tr), fp.price(gp, tpp, device="cpu")
    assert (ep.tau_ms, ep.ci95_ms, ep.per_seed_ms) == (er.tau_ms, er.ci95_ms, er.per_seed_ms)
    np.testing.assert_array_equal(fp.simulate_rounds(gp, tpp, 40, device="cpu"),
                                  fr.simulate_rounds(gr, tr, 40))
    mr = R.matcha_schedule_from_connectivity(gr, 0.4)
    mp = P.matcha_schedule_from_connectivity(gp, 0.4)
    np.testing.assert_array_equal(
        mp.simulate_rounds_batch(gp, tpp, 30, (0, 2), device="cpu"),
        mr.simulate_rounds_batch(gr, tr, 30, (0, 2)))


def test_legacy_oracle_equals_batched_tau():
    (_, gr, tr), (_, gp, tpp) = _both("gaia")
    for budget in (0.2, 0.7):
        legacy = P.matcha_from_connectivity(gp, budget)
        sched = P.schedule_from_matcha(legacy)
        tau = legacy.average_cycle_time(gp, tpp, rounds=40, seed=1)
        assert tau == R.matcha_from_connectivity(gr, budget).average_cycle_time(
            gr, tr, rounds=40, seed=1)
        est = sched.price(gp, tpp, rounds=40, seeds=(1,), device="cpu")
        np.testing.assert_allclose(est.tau_ms, tau, rtol=1e-12)


@pytest.mark.parametrize("access", [10.0, 0.1])
def test_table10_row_identical(access):
    """A row of Table 10 (ring speedup vs MATCHA+ on AWS NA) at 30 rounds,
    as benchmarks/matcha_budget.py prices it."""
    budgets = (1.0, 0.8, 0.6, 0.5, 0.4, 0.2, 0.1)
    (ur, gr, tr), (up, gp, tpp) = _both("aws_na", access_capacity_gbps=access)
    want = R.average_cycle_times_batched(
        [R.matcha_schedule_from_underlay(ur, cb) for cb in budgets], gr, tr,
        rounds=30, seeds=(0,))[:, 0] / R.ring_overlay(gr, tr).cycle_time_ms
    got = P.average_cycle_times_batched(
        [P.matcha_schedule_from_underlay(up, cb) for cb in budgets], gp, tpp,
        rounds=30, seeds=(0,), device="cpu")[:, 0] / P.ring_overlay(gp, tpp).cycle_time_ms
    np.testing.assert_array_equal(got, want)


def test_infeasible_and_invalid_schedules_raise():
    (_, _, _), (_, gp, tpp) = _both("gaia")
    with pytest.raises(ValueError, match="budget"):
        P.MatchaSchedule(matchings=(((0, 1),),), budget=0.0)
    lonely = P.MatchaSchedule(matchings=((("x", "y"),),), budget=0.5)  # pairs gc does not route
    with pytest.raises(P.ScheduleInfeasibleError):
        P.average_cycle_times_batched([lonely], gp, tpp, rounds=5, device="cpu")
