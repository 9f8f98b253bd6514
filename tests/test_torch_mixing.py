"""Mixing-rate pricing of the port against the JAX package: every copied
numpy function at 1e-12 (most are exact), the torch twins
``batched_rho_torch`` / ``batched_spectral_gap_torch`` against the numpy
SVD at 1e-10, and the consensus matrices the copy added."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.mixing as RM  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.core.mixing as PM  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _arc_pool(rng, n, p=0.5):
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n) if rng.random() < p]
    arcs = [a for (i, j) in pairs for a in ((i, j), (j, i))]
    return np.array([a[0] for a in arcs]), np.array([a[1] for a in arcs])


@pytest.mark.parametrize("rule", ["local_degree", "metropolis", "uniform"])
def test_mixing_matrices_equal_reference(rule):
    rng = np.random.default_rng(0)
    n = 9
    src, dst = _arc_pool(rng, n)
    masks = rng.random((6, src.size)) < 0.6
    masks[0] = False  # no active arc: the identity
    np.testing.assert_allclose(PM.batched_mixing_matrices(n, src, dst, masks, rule=rule),
                               RM.batched_mixing_matrices(n, src, dst, masks, rule=rule), **TOL)
    edges = list(zip(src[masks[1]].tolist(), dst[masks[1]].tolist()))
    np.testing.assert_allclose(PM.mixing_matrix(n, edges, rule=rule),
                               RM.mixing_matrix(n, edges, rule=rule), **TOL)


def test_consensus_matrices_equal_reference():
    rng = np.random.default_rng(1)
    src, dst = _arc_pool(rng, 7)
    edges = list(zip(src.tolist(), dst.tolist()))
    np.testing.assert_array_equal(P.metropolis_matrix(7, edges), R.metropolis_matrix(7, edges))
    np.testing.assert_array_equal(P.star_matrix(7, 2), R.star_matrix(7, 2))
    A = P.local_degree_matrix(7, edges)
    assert P.spectral_gap(A) == R.spectral_gap(A)


@pytest.mark.parametrize("symmetric", [False, True])
def test_batched_rho_and_gap_equal_reference(symmetric):
    rng = np.random.default_rng(2)
    src, dst = _arc_pool(rng, 8)
    W = RM.batched_mixing_matrices(8, src, dst, rng.random((5, src.size)) < 0.5)
    np.testing.assert_allclose(PM.batched_rho(W, symmetric=symmetric),
                               RM.batched_rho(W, symmetric=symmetric), **TOL)
    np.testing.assert_allclose(PM.batched_spectral_gap(W, symmetric=symmetric),
                               RM.batched_spectral_gap(W, symmetric=symmetric), **TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_torch_twins_match_numpy_svd(dtype):
    rng = np.random.default_rng(3)
    W = rng.random((4, 6, 6)).astype(dtype)
    W /= W.sum(axis=2, keepdims=True)  # row-stochastic, not symmetric
    want = RM.batched_rho(W.astype(np.float64))
    got = PM.batched_rho_torch(torch.from_numpy(W))
    assert got.dtype == torch.from_numpy(W).dtype and got.shape == (4,)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(PM.batched_spectral_gap_torch(torch.from_numpy(W)).double().numpy(),
                               1.0 - want, rtol=tol, atol=tol)


def test_overlay_and_schedule_rho_equal_reference():
    M, Tc = R.WORKLOADS["inaturalist"]
    gr = R.make_underlay("geant").connectivity_graph(comp_time_ms=Tc)
    gp = P.make_underlay("geant").connectivity_graph(comp_time_ms=Tc)
    tr = R.TrainingParams(model_size_mbits=M, local_steps=1)
    tpp = P.TrainingParams(model_size_mbits=M, local_steps=1)
    ovs_r = [R.ring_overlay(gr, tr), R.mst_overlay(gr, tr), R.star_overlay(gr, tr)]
    ovs_p = [P.ring_overlay(gp, tpp), P.mst_overlay(gp, tpp), P.star_overlay(gp, tpp)]
    n = gr.num_silos
    for a, b in zip(ovs_p, ovs_r):
        np.testing.assert_allclose(PM.overlay_mixing_matrix(a, n, silos=gp.silos),
                                   RM.overlay_mixing_matrix(b, n, silos=gr.silos), **TOL)
        np.testing.assert_allclose(PM.overlay_rho(a, n, silos=gp.silos),
                                   RM.overlay_rho(b, n, silos=gr.silos), **TOL)
    np.testing.assert_allclose(PM.overlay_rho_batch(ovs_p, n, silos=gp.silos),
                               RM.overlay_rho_batch(ovs_r, n, silos=gr.silos), **TOL)
    sr = R.matcha_schedule_from_connectivity(gr, 0.3)
    sp = P.matcha_schedule_from_connectivity(gp, 0.3)
    Gr = RM.matcha_expected_gram(sr, gr, rounds=64, seed=4)
    Gp = PM.matcha_expected_gram(sp, gp, rounds=64, seed=4)
    np.testing.assert_allclose(Gp, Gr, **TOL)
    np.testing.assert_allclose(PM.contraction_from_gram(Gp), RM.contraction_from_gram(Gr), **TOL)
    np.testing.assert_allclose(PM.schedule_rho(sp, gp, rounds=64, seed=4),
                               RM.schedule_rho(sr, gr, rounds=64, seed=4), **TOL)
    np.testing.assert_allclose(PM.schedule_rho(P.FixedSchedule(ovs_p[0]), gp),
                               RM.schedule_rho(R.FixedSchedule(ovs_r[0]), gr), **TOL)


def test_objectives_and_frontier_equal_reference():
    assert PM.OBJECTIVES == RM.OBJECTIVES and PM.WEIGHT_RULES == RM.WEIGHT_RULES
    for tau, rho in ((120.0, 0.5), (80.0, 0.0), (50.0, 1.0), (10.0, float("nan"))):
        a, b = PM.wall_clock_to_eps(tau, rho), RM.wall_clock_to_eps(tau, rho)
        assert (math.isnan(a) and math.isnan(b)) or a == b
    est = P.ScheduleEstimate(tau_ms=100.0, ci95_ms=0.0, per_seed_ms=(100.0,), rho=0.3)
    for obj in PM.OBJECTIVES:
        assert PM.score_estimate(est, obj) == RM.score_estimate(est, obj)
    assert est.time_to_eps_score == RM.wall_clock_to_eps(100.0, 0.3)
    with pytest.raises(ValueError, match="priced rho"):
        PM.score_estimate(P.ScheduleEstimate(1.0, 0.0, (1.0,)), "time_to_eps")
    rng = np.random.default_rng(5)
    taus, rhos = rng.random(20), rng.random(20)
    np.testing.assert_array_equal(PM.pareto_frontier(taus, rhos), RM.pareto_frontier(taus, rhos))
