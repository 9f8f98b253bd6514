"""The reference's view of a re-design against a brute force and against
the program: Karp's cycle time is the heaviest mean over every circuit,
the delay model and the cycle time agree with the program's on the
paper's Gaia network, and each overlay's consensus matrix is the plan's
that the program compiles from it."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from portbench.reference import designer


def _circuits(nodes, arcs):
    """Every simple circuit, as a node list (the smallest node first)."""
    succ = {v: [j for i, j in arcs if i == v] for v in nodes}
    out = []

    def walk(path):
        for w in succ[path[-1]]:
            if w == path[0]:
                out.append(list(path))
            elif w > path[0] and w not in path:
                walk(path + [w])

    for v in nodes:
        walk([v])
    return out


@pytest.mark.parametrize("seed", range(8))
def test_cycle_time_is_the_heaviest_circuit_mean(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    perm = rng.permutation(n)
    arcs = {(int(perm[k]), int(perm[(k + 1) % n])) for k in range(n)}   # strongly connected
    arcs |= {(int(i), int(j)) for i, j in rng.integers(0, n, size=(n, 2)) if i != j}
    delays = {a: float(rng.uniform(1, 100)) for a in arcs}
    delays.update({(v, v): float(rng.uniform(1, 100)) for v in range(n)})
    want = max(sum(delays[(c[k], c[(k + 1) % len(c)])] for k in range(len(c))) / len(c)
               for c in _circuits(range(n), list(delays)))
    assert designer.cycle_time_ms(list(range(n)), delays) == pytest.approx(want, rel=1e-12)
    assert designer.cycle_time_ms(list(range(n)), delays, np.float32) == pytest.approx(want,
                                                                                       rel=1e-5)


def _gaia(local_steps=2):
    from repro_torch.core import WORKLOADS, TrainingParams, make_underlay

    M, Tc = WORKLOADS["inaturalist"]
    gc = make_underlay("gaia").connectivity_graph(comp_time_ms=Tc)
    return gc, TrainingParams(model_size_mbits=M, local_steps=local_steps)


def _plain(gc, tp):
    from portbench.entries.train_loop import _plain_network

    return _plain_network(gc, tp)


@pytest.mark.parametrize("kind", ["ring", "star", "mst", "delta_mbst"])
def test_delays_and_cycle_time_are_the_programs(kind):
    from repro_torch.core import design_overlay
    from repro_torch.core.delays import overlay_delay_matrix
    from repro_torch.core.maxplus_vec import cycle_time_dense

    gc, tp = _gaia()
    ov = design_overlay(kind, gc, tp, device="cpu")
    net = _plain(gc, tp)
    w = designer.overlay_delays(net, ov.edges)
    W = overlay_delay_matrix(gc, tp, ov.edges)
    idx = {v: k for k, v in enumerate(gc.silos)}
    for (i, j), x in w.items():
        assert x == pytest.approx(W[idx[i], idx[j]], rel=1e-12)
    assert sum(np.isfinite(W).ravel()) == len(w)
    assert designer.cycle_time_ms(net["silos"], w) == pytest.approx(cycle_time_dense(W), rel=1e-12)
    tau = designer.overlay_cycle_time_ms(net, ov.name, ov.edges)
    assert tau == pytest.approx(ov.cycle_time_ms, rel=1e-12)


@pytest.mark.parametrize("kind", ["ring", "star", "mst", "delta_mbst"])
def test_consensus_matrix_is_the_plans(kind):
    from repro_torch.core import design_overlay
    from repro_torch.fed import plan_from_overlay

    gc, tp = _gaia()
    ov = design_overlay(kind, gc, tp, device="cpu")
    order = list(gc.silos)
    plan = plan_from_overlay(ov, len(order), silos=order)
    A = np.asarray(designer.consensus_matrix(ov.name, ov.edges, order))
    assert np.array_equal(A, np.asarray(plan.matrix))


def test_consensus_matrix_over_a_subset_and_refusals():
    # silo 5 gone: rows are the remaining labels in order
    order = [0, 1, 2, 3, 4, 6]
    ring = [(0, 3), (3, 6), (6, 1), (1, 4), (4, 2), (2, 0)]
    A = np.asarray(designer.consensus_matrix("ring_2opt", ring, order))
    assert A[order.index(3), order.index(0)] == 0.5 and np.allclose(A.sum(0), 1)
    with pytest.raises(ValueError):
        designer.consensus_matrix("ring_2opt", ring + [(5, 0)], order)   # a leaver's arc
    with pytest.raises(ValueError):
        designer.consensus_matrix("ring", ring[:-1] + [(2, 3)], order)   # not one cycle
    for perm in itertools.permutations(range(3)):
        arcs = [(perm[k], perm[(k + 1) % 3]) for k in range(3)]
        assert np.allclose(np.asarray(designer.consensus_matrix("ring", arcs, range(3))).sum(1), 1)
