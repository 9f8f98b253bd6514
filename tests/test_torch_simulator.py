"""The port's time simulator (Algorithm 3) and exact brute-force MCT
solver against the JAX package, on the CPU, from the same inputs.

* ``simulate_overlay``, ``simulate_overlays_batched``,
  ``predicted_cycle_time`` and ``training_time_ms`` equal the reference's
  on the paper's Gaia network bit for bit (both are numpy float64 in the
  same order), and the mirrored claims of tests/test_simulator.py hold on
  the port: the timeline's slope is Karp's tau (2 %), the training time
  grows by tau a round, the ring completes more rounds than the star in a
  fixed wall-clock budget, local steps shrink the gap, and
  ``rounds_completed_by`` counts as the reference's.
* ``brute_force_mct`` returns the reference's tau and arc set on seeded 5-
  and 6-silo instances (undirected, the directed heuristic cut) and a
  4-silo directed one, certifies the MST optimal among undirected overlays
  on edge-capacitated graphs and the ring within 3N of the optimum
  (tests/test_topologies.py), and keeps the reference's unsound-cut
  regression; no design of the port beats the exhaustive optimum.
* ``edges_to_matrix`` and ``graph_to_matrix`` equal the reference's.
"""

import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as C  # noqa: E402
from repro.core import maxplus_vec as JV  # noqa: E402
from repro.core.simulator import (  # noqa: E402
    predicted_cycle_time as j_predicted_cycle_time,
    simulate_overlay as j_simulate_overlay,
    simulate_overlays_batched as j_simulate_overlays_batched,
    training_time_ms as j_training_time_ms,
)
from repro.core.topologies import brute_force_mct as j_brute_force_mct  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import maxplus_vec as TV  # noqa: E402
from repro_torch.core.delays import overlay_delay_digraph  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402

NETWORK = "gaia"


def _gaia(mod, access=10.0, s=1):
    M, Tc = mod.WORKLOADS["inaturalist"]
    u = mod.make_underlay(NETWORK, access_capacity_gbps=access)
    return u, u.connectivity_graph(comp_time_ms=Tc), mod.TrainingParams(model_size_mbits=M,
                                                                         local_steps=s)


def random_euclidean_gc(mod, n, seed, access=10.0, comp=5.0):
    """tests/test_topologies.py's instance, built with ``mod``'s classes."""
    rng = random.Random(seed)
    pts = [(rng.uniform(0, 100), rng.uniform(0, 100)) for _ in range(n)]
    lat, bw = {}, {}
    for i in range(n):
        for j in range(n):
            if i != j:
                lat[(i, j)] = 4.0 + math.hypot(pts[i][0] - pts[j][0], pts[i][1] - pts[j][1]) * 0.1
                bw[(i, j)] = 1.0
    params = {i: mod.SiloParams(comp, access, access) for i in range(n)}
    return mod.ConnectivityGraph(tuple(range(n)), lat, bw, params)


def _tp(mod):
    return mod.TrainingParams(model_size_mbits=42.88, local_steps=1)


@pytest.mark.parametrize("kind", ["mst", "ring", "delta_mbst"])
def test_simulator_matches_reference_and_slope_matches_karp(kind):
    u, gc, tp = _gaia(P)
    _, jgc, jtp = _gaia(C)
    ov = P.design_overlay(kind, gc, tp, device="cpu")
    jov = C.design_overlay(kind, jgc, jtp)
    assert ov.edges == jov.edges and ov.cycle_time_ms == jov.cycle_time_ms
    tl = P.simulate_overlay(gc, tp, ov.edges, num_rounds=200)
    ref = j_simulate_overlay(jgc, jtp, jov.edges, num_rounds=200)
    assert tl.num_rounds == ref.num_rounds and tl.times == ref.times
    assert tl.empirical_cycle_time() == ref.empirical_cycle_time()
    assert tl.empirical_cycle_time() == pytest.approx(ov.cycle_time_ms, rel=0.02)
    assert P.predicted_cycle_time(gc, tp, ov.edges) == \
        j_predicted_cycle_time(jgc, jtp, jov.edges) == ov.cycle_time_ms


def test_training_time_is_cycle_time_times_rounds_asymptotically():
    _, gc, tp = _gaia(P)
    _, jgc, jtp = _gaia(C)
    ov = P.design_overlay("ring", gc, tp, device="cpu")
    t100 = P.training_time_ms(gc, tp, ov.edges, 100)
    t200 = P.training_time_ms(gc, tp, ov.edges, 200)
    assert (t100, t200) == (j_training_time_ms(jgc, jtp, ov.edges, 100),
                            j_training_time_ms(jgc, jtp, ov.edges, 200))
    assert (t200 - t100) / 100 == pytest.approx(ov.cycle_time_ms, rel=0.02)


def test_batched_simulator_matches_single_and_reference():
    _, gc, tp = _gaia(P)
    _, jgc, jtp = _gaia(C)
    overlays = [P.design_overlay(k, gc, tp, device="cpu").edges
                for k in ("star", "mst", "ring", "delta_mbst")]
    got = P.simulate_overlays_batched(gc, tp, overlays, num_rounds=60)
    assert got.shape == (4, 61, gc.num_silos)
    np.testing.assert_array_equal(got, j_simulate_overlays_batched(jgc, jtp, overlays,
                                                                   num_rounds=60))
    for b, edges in enumerate(overlays):
        tl = P.simulate_overlay(gc, tp, edges, num_rounds=60)
        np.testing.assert_array_equal(got[b], np.array([tl.times[v] for v in gc.silos]).T)


def test_ring_throughput_beats_star_in_rounds_completed():
    """The headline claim: within a fixed wall-clock budget the ring
    completes about 3x more rounds than the star on Gaia; the simulated
    ring completes budget / tau of them."""
    u, gc, tp = _gaia(P)
    ring = P.design_overlay("ring", gc, tp, device="cpu")
    star = P.star_overlay(gc, tp, center=u.load_centrality_center())
    budget = 60_000.0
    assert (budget / ring.cycle_time_ms) / (budget / star.cycle_time_ms) > 2.5
    tl_ring = P.simulate_overlay(gc, tp, ring.edges, num_rounds=600)
    assert tl_ring.rounds_completed_by(budget) == pytest.approx(budget / ring.cycle_time_ms,
                                                                rel=0.02)


def test_local_steps_shrink_relative_gap():
    gaps = []
    for s in (1, 10):
        u, gc, tp = _gaia(P, s=s)
        ring = P.design_overlay("ring", gc, tp, device="cpu")
        star = P.star_overlay(gc, tp, center=u.load_centrality_center())
        gaps.append(star.cycle_time_ms / ring.cycle_time_ms)
    assert gaps[1] < gaps[0]


def test_timeline_rounds_completed_by():
    _, gc, tp = _gaia(P)
    _, jgc, jtp = _gaia(C)
    ov = P.design_overlay("mst", gc, tp, device="cpu")
    tl = P.simulate_overlay(gc, tp, ov.edges, num_rounds=50)
    ref = j_simulate_overlay(jgc, jtp, ov.edges, num_rounds=50)
    for t in (0.0, 3 * ov.cycle_time_ms, 10 * ov.cycle_time_ms, 1e9):
        assert tl.rounds_completed_by(t) == ref.rounds_completed_by(t)
        assert tl.finish_time() == ref.finish_time()
    assert 5 <= tl.rounds_completed_by(10 * ov.cycle_time_ms) <= 12


def test_graph_to_matrix_matches_reference():
    _, gc, tp = _gaia(P)
    ov = P.ring_overlay(gc, tp)
    dg = overlay_delay_digraph(gc, tp, ov.edges)
    W, nodes = P.graph_to_matrix(dg)
    W_ref, nodes_ref = JV.graph_to_matrix(dg)
    assert nodes == nodes_ref == tuple(gc.silos)
    np.testing.assert_array_equal(W, W_ref)
    np.testing.assert_array_equal(TV.edges_to_matrix(dg.delays, gc.silos), W)
    assert P.cycle_time_dense(W) == ov.cycle_time_ms


@pytest.mark.parametrize("n,seed,kw", [
    (5, 0, {"undirected": True}),
    (6, 1, {"undirected": True}),
    (5, 2, {"exhaustive": False}),
    (4, 3, {}),
], ids=["undirected-5", "undirected-6", "directed-cut-5", "directed-4"])
def test_brute_force_matches_reference(n, seed, kw):
    got = P.brute_force_mct(random_euclidean_gc(P, n, seed), _tp(P), **kw)
    ref = j_brute_force_mct(random_euclidean_gc(C, n, seed), _tp(C), **kw)
    assert got.cycle_time_ms == ref.cycle_time_ms
    assert got.edges == ref.edges and got.name == ref.name == "bf"


def test_mst_optimal_undirected_edge_capacitated():
    """Prop. 3.1: the MST is optimal among undirected overlays on
    edge-capacitated graphs, certified by the port's brute force."""
    for n, seed in ((5, 0), (6, 1)):
        gc = random_euclidean_gc(P, n, seed, access=1e5)
        best = P.brute_force_mct(gc, _tp(P), undirected=True)
        assert P.mst_overlay(gc, _tp(P)).cycle_time_ms == pytest.approx(best.cycle_time_ms,
                                                                        rel=1e-6)


def test_ring_within_3n_approximation():
    """Prop. 3.3/3.6: the Christofides ring is a 3N-approximation."""
    for n, seed in ((5, 2), (6, 3)):
        gc = random_euclidean_gc(P, n, seed)
        best_und = P.brute_force_mct(gc, _tp(P), undirected=True)
        assert P.ring_overlay(gc, _tp(P)).cycle_time_ms <= 3 * n * best_und.cycle_time_ms


def test_no_design_beats_the_exhaustive_optimum():
    """Every designer of the port (the climbs on the CPU) on a 5-silo
    instance is at or above the exhaustive directed optimum, and the
    oracle launches no kernel."""
    gc, tp = random_euclidean_gc(P, 5, 4), _tp(P)
    before = dict(LAUNCHES)
    best = P.brute_force_mct(gc, tp)
    assert dict(LAUNCHES) == before
    assert P.brute_force_mct(gc, tp, exhaustive=False).cycle_time_ms >= best.cycle_time_ms
    assert P.evaluate_overlay(gc, tp, best.edges).cycle_time_ms == best.cycle_time_ms
    for kind in ("star", "mst", "ring", "ring_2opt", "delta_mbst", "sparse_rewire",
                 "delta_rewire"):
        ov = P.design_overlay(kind, gc, tp, device="cpu")
        assert ov.cycle_time_ms >= best.cycle_time_ms - 1e-9, kind


def test_brute_force_heuristic_cut_is_opt_in_and_unsound():
    """The reference's regression for the unsound ``r >= n + 2`` cut, on
    the port: hub + 4 leaves, hub<->leaf latency 1, one leaf-leaf pair at
    latency 100; the exhaustive optimum is the bidirected star (tau about
    1), the cut stops at a 3-circuit through the slow pair (102 / 3)."""
    hub, leaves = "h", ["l1", "l2", "l3", "l4"]
    silos = tuple([hub] + leaves)
    lat, bw = {}, {}

    def link(a, b, latency):
        for (i, j) in ((a, b), (b, a)):
            lat[(i, j)] = latency
            bw[(i, j)] = 1e6

    for leaf in leaves:
        link(hub, leaf, 1.0)
    link("l1", "l2", 100.0)
    gc = P.ConnectivityGraph(silos, lat, bw, {v: P.SiloParams(0.0, 1e6, 1e6) for v in silos})
    tp = P.TrainingParams(model_size_mbits=1e-6, local_steps=0)
    exact = P.brute_force_mct(gc, tp)
    cut = P.brute_force_mct(gc, tp, exhaustive=False)
    assert exact.cycle_time_ms == pytest.approx(1.0, rel=1e-3)
    assert cut.cycle_time_ms == pytest.approx(102.0 / 3.0, rel=1e-3)
    assert set(exact.edges) == {(hub, leaf) for leaf in leaves} | {(leaf, hub) for leaf in leaves}
    with pytest.raises(ValueError, match="tiny"):
        P.brute_force_mct(random_euclidean_gc(P, 8, 0), tp)
