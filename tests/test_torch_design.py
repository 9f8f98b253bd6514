"""The design slice of the port against the JAX package, on the CPU.

* the copied host code (underlays, Eq. 3 pricing, the host designers,
  the delta climb) gives exactly the reference's overlays;
* the device climb's score of its seeds (``n_steps=0``) is bit-identical
  to the reference's jitted climb, for one universe and for padded
  multi-universe packs;
* the full searches meet the reference's invariants
  (tests/test_sparse_search.py);
* ``plan_from_overlay`` gives the reference's plans, and a designed plan
  trains one DPASGD round that agrees with the reference's ``einsum``
  round (2e-5, as tests/test_torch_dpasgd.py)."""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as C  # noqa: E402
from repro.core.maxplus_sparse import batched_cycle_time_auto as j_cycle_time_auto  # noqa: E402
from repro.core.topologies import Overlay as JOverlay  # noqa: E402
from repro.core.topologies import _rewire_climb_fn  # noqa: E402
from repro.fed.topology_runtime import plan_from_overlay as j_plan_from_overlay  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import topologies as PT  # noqa: E402
from repro_torch.fed import plan_from_overlay  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402

CPU = torch.device("cpu")
M, TC = C.WORKLOADS["inaturalist"]


def _problem(pkg, net):
    return (pkg.make_underlay(net).connectivity_graph(comp_time_ms=TC),
            pkg.TrainingParams(model_size_mbits=M, local_steps=1))


@pytest.mark.parametrize("net", list(C.NETWORK_NAMES))
def test_underlays_and_pricing_match_reference(net):
    jgc, jtp = _problem(C, net)
    gc, tp = _problem(P, net)
    assert (gc.num_silos, P.make_underlay(net).num_core_links) == P.EXPECTED_SIZES[net]
    assert gc.latency_ms == jgc.latency_ms and gc.available_bw_gbps == jgc.available_bw_gbps
    ring = C.ring_overlay(jgc, jtp)
    np.testing.assert_array_equal(P.overlay_delay_matrix(gc, tp, ring.edges),
                                  C.overlay_delay_matrix(jgc, jtp, ring.edges))
    pool = sorted({e for e in ring.edges} | {(j, i) for (i, j) in ring.edges})
    masks = np.random.default_rng(0).random((5, len(pool))) < 0.7
    ours = P.batched_overlay_delay_edges(gc, tp, pool, masks)
    ref = C.batched_overlay_delay_edges(jgc, jtp, pool, masks)
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.batched_cycle_time_auto(ours), j_cycle_time_auto(ref))
    np.testing.assert_array_equal(P.batched_is_strongly_connected_sparse(ours),
                                  C.batched_is_strongly_connected_sparse(ref))


@pytest.mark.parametrize("net", ["gaia", "geant"])
@pytest.mark.parametrize("kind", ["star", "mst", "ring", "ring_2opt", "delta_mbst",
                                  "delta_rewire"])
def test_host_designers_match_reference(kind, net):
    jgc, jtp = _problem(C, net)
    gc, tp = _problem(P, net)
    if kind == "delta_rewire" and net == "geant":
        # the registry's default budget takes half a minute per package
        # here; a smaller budget runs the same host climb
        ref = C.search_overlays_delta(jgc, jtp, n_restarts=2, n_steps=128, seed=3)
        got = P.search_overlays_delta(gc, tp, n_restarts=2, n_steps=128, seed=3)
    else:
        ref = C.design_overlay(kind, jgc, jtp)
        got = P.design_overlay(kind, gc, tp, device="cpu")
    assert got.name == ref.name and got.edges == ref.edges
    assert got.cycle_time_ms == ref.cycle_time_ms


def _single_inputs(gc, tp, n_restarts, delta_max, seed=0):
    index = {v: k for k, v in enumerate(gc.silos)}
    universe = PT._universe(gc, tp, index)
    rng = np.random.default_rng(seed)
    asrc, adst, aact, _ = PT._seed_states(gc, tp, index, n_restarts, 2 * gc.num_silos,
                                          delta_max, rng, None)
    return universe + (asrc, adst, aact)


def _multi_inputs(gc, tp, clusters, n_restarts, delta_intra, seed=0):
    multi = [c for c in clusters if len(c) >= 2]
    packed, _ = PT._pack_universes(gc, tp, multi, n_restarts, delta_intra,
                                   np.random.default_rng(seed), None)
    return packed


def _scores(arrays, delta_max, multi):
    """btau of the reference's jitted climb and of the port's, n_steps=0."""
    jfn = _rewire_climb_fn(multi)
    ref = jfn(*arrays[:6], np.float32(M), *arrays[6:], jax.random.PRNGKey(0), 0,
              delta_max, np.float32(0.05), np.float32(1e-3))
    got = PT.rewire_climb(*PT._on_device(CPU, *arrays[:6]), np.float32(M),
                          *PT._on_device(CPU, *arrays[6:]),
                          generator=torch.Generator().manual_seed(0), n_steps=0,
                          delta_max=delta_max, multi=multi)
    np.testing.assert_array_equal(got[0].numpy(), arrays[6])  # the seeds come back
    return np.asarray(ref[3]), got[3].numpy()


@pytest.mark.parametrize("net,delta", [("gaia", 8), ("gaia", 3), ("geant", 8), ("ebone", 8)])
def test_climb_score_bit_identical_single_universe(net, delta):
    gc, tp = _problem(P, net)
    ref, got = _scores(_single_inputs(gc, tp, 8, delta), delta, multi=False)
    assert np.isfinite(got).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_climb_score_bit_identical_padded_universes(net):
    gc, tp = _problem(P, net)
    if net == "gaia":  # clusters of 4, 4 and 3 silos: the last universe is padded
        labels = [k % 3 for k in range(gc.num_silos)]
        clusters = PT.cluster_silos(gc, labels=labels)
    else:
        clusters = PT.cluster_silos(gc, seed=0)
    sizes = {len(c) for c in clusters if len(c) >= 2}
    assert len(sizes) > 1  # padding is exercised
    ref, got = _scores(_multi_inputs(gc, tp, clusters, 2, 7), 7, multi=True)
    assert np.isfinite(got).any()
    np.testing.assert_array_equal(got, ref)


def _assert_valid(gc, tp, ov, delta):
    W = P.overlay_delay_matrix(gc, tp, ov.edges)
    assert bool(P.batched_is_strongly_connected(W))
    for v in gc.silos:
        assert ov.out_degree(v) <= delta and ov.in_degree(v) <= delta
    for (i, j) in ov.edges:
        assert gc.has_edge(i, j)
    # the reported tau is the exact f64 host price of the edges
    assert ov.cycle_time_ms == P.evaluate_overlay(gc, tp, ov.edges).cycle_time_ms
    assert np.isfinite(ov.cycle_time_ms) and ov.cycle_time_ms > 0


@pytest.mark.parametrize("net,delta,kw", [
    ("gaia", 3, {"n_restarts": 8, "n_steps": 24}),
    ("gaia", 8, {}),
    ("geant", 8, {"n_restarts": 8, "n_steps": 24}),
])
def test_sparse_rewire_search_invariants(net, delta, kw):
    gc, tp = _problem(P, net)
    before = dict(LAUNCHES)
    ov = PT.search_overlays_jit(gc, tp, delta_max=delta, seed=0, device="cpu", **kw)
    assert LAUNCHES == before  # no kernel launches on the CPU
    assert ov.name == "sparse_rewire"
    _assert_valid(gc, tp, ov, delta)
    ring = P.ring_overlay(gc, tp)
    if _degrees(ring) <= delta:
        assert ov.cycle_time_ms <= ring.cycle_time_ms + 1e-6


def _degrees(ov):
    return max(max(ov.out_degree(v), ov.in_degree(v)) for e in ov.edges for v in e)


def test_sparse_rewire_registry_and_delta_delegation_match_reference():
    gc, tp = _problem(P, "gaia")
    jgc, jtp = _problem(C, "gaia")
    ov = P.design_overlay("sparse_rewire", gc, tp, device="cpu")
    assert ov.name == "sparse_rewire" and "sparse_rewire" in P.OVERLAY_KINDS
    assert ov.cycle_time_ms <= P.design_overlay("ring", gc, tp, device="cpu").cycle_time_ms
    # the delta engine is host code: the delegation gives the reference's overlay
    got = PT.search_overlays_jit(gc, tp, n_restarts=2, n_steps=16, engine="delta",
                                 seed=1, device="cpu")
    ref = C.search_overlays_jit(jgc, jtp, n_restarts=2, n_steps=16, engine="delta", seed=1)
    assert got.name == ref.name == "sparse_rewire"
    assert got.edges == ref.edges and got.cycle_time_ms == ref.cycle_time_ms
    with pytest.raises(ValueError, match="engine"):
        PT.search_overlays_jit(gc, tp, engine="xla", device="cpu")


def test_hierarchical_search_invariants():
    gc, tp = _problem(P, "gaia")
    ov = P.design_overlay("hierarchical", gc, tp, device="cpu")
    assert ov.name == "hierarchical" and "hierarchical" in P.OVERLAY_KINDS
    W = P.overlay_delay_matrix(gc, tp, ov.edges)
    assert bool(P.batched_is_strongly_connected(W))
    assert np.isfinite(ov.cycle_time_ms) and ov.cycle_time_ms > 0
    assert ov.cycle_time_ms == P.evaluate_overlay(gc, tp, ov.edges).cycle_time_ms
    for (i, j) in ov.edges:
        assert gc.has_edge(i, j)


def test_hierarchical_search_with_labels_incumbent_and_one_cluster():
    gc, tp = _problem(P, "geant")
    labels = {v: k % 3 for k, v in enumerate(gc.silos)}
    ring = P.design_overlay("ring", gc, tp, device="cpu")
    ov = PT.search_overlays_hierarchical(gc, tp, labels=labels, n_restarts=2, n_steps=16,
                                         seed=0, incumbent=ring, device="cpu")
    # the incumbent competes in the final exact pricing
    assert ov.cycle_time_ms <= ring.cycle_time_ms + 1e-9
    for (i, j) in ov.edges:
        assert gc.has_edge(i, j)
    one = PT.search_overlays_hierarchical(gc, tp, n_clusters=1, n_steps=8, device="cpu")
    assert one.name == "hierarchical" and np.isfinite(one.cycle_time_ms)


def _plans_equal(a, b):
    assert a.n_silos == b.n_silos and a.terms == b.terms
    np.testing.assert_array_equal(a.matrix, b.matrix)


@pytest.mark.parametrize("kind", ["star", "mst", "ring", "ring_2opt", "delta_mbst",
                                  "sparse_rewire"])
def test_plans_from_designed_overlays_match_reference(kind):
    gc, tp = _problem(P, "gaia")
    ov = P.design_overlay(kind, gc, tp, device="cpu")
    ref = j_plan_from_overlay(JOverlay(ov.name, ov.edges, ov.cycle_time_ms), gc.num_silos)
    _plans_equal(plan_from_overlay(ov, gc.num_silos), ref)


RUNTIME_CASES = {
    "string_ring": ("ring", [("tokyo", "paris"), ("paris", "lyon"), ("lyon", "tokyo")], 3, None),
    "pinned_order": ("ring", [("tokyo", "paris"), ("paris", "lyon"), ("lyon", "tokyo")], 3,
                     ["paris", "lyon", "tokyo"]),
    "sparse_ids": ("ring", [(17, 42), (42, 5), (5, 17)], 3, None),
    "string_mst": ("mst", [("a", "b"), ("b", "a"), ("b", "c"), ("c", "b")], 3, None),
    "broken_ring": ("ring", [("a", "b"), ("b", "a"), ("c", "d"), ("d", "c")], 4, None),
    "double_out_degree": ("ring", [("a", "b"), ("a", "c"), ("b", "a"), ("c", "a")], 3, None),
    "count_mismatch": ("ring", [("a", "b"), ("b", "a")], 5, None),
    "unknown_label": ("mst", [("a", "b"), ("b", "a")], 2, ["a", "c"]),
}


@pytest.mark.parametrize("case", list(RUNTIME_CASES))
def test_plan_from_overlay_cases_match_reference(case):
    """The cases of tests/test_topology_runtime.py: same plan, or the
    same error."""
    name, edges, n, silos = RUNTIME_CASES[case]
    try:
        ref = j_plan_from_overlay(JOverlay(name, tuple(edges), 1.0), n, silos=silos)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            plan_from_overlay(P.Overlay(name, tuple(edges), 1.0), n, silos=silos)
        return
    _plans_equal(plan_from_overlay(P.Overlay(name, tuple(edges), 1.0), n, silos=silos), ref)


def test_design_to_plan_to_one_round_matches_reference():
    """The slice end to end: design Gaia on the CPU, build the plan, and
    train one DPASGD round through the port's kernel lowering against the
    reference's einsum round on the same plan (2e-5)."""
    from repro.configs import get_config as j_get_config
    from repro.data import FederatedBatcher as JBatcher
    from repro.data import SyntheticLMStream as JStream
    from repro.fed import DPASGDConfig as JFed
    from repro.fed import init_state as j_init_state
    from repro.fed import make_train_step as j_make_train_step
    from repro.optim import momentum as j_momentum
    from repro_torch.configs import get_config
    from repro_torch.fed import DPASGDConfig, make_train_step
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import from_jax_params
    from repro_torch.optim import momentum

    gc, tp = _problem(P, "gaia")
    ov = P.design_overlay("sparse_rewire", gc, tp, device="cpu")
    n = gc.num_silos
    plan = plan_from_overlay(ov, n)
    j_plan = j_plan_from_overlay(JOverlay(ov.name, ov.edges, ov.cycle_time_ms), n)
    _plans_equal(plan, j_plan)

    jcfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=n)
    jopt = j_momentum(0.05, 0.9)
    state = j_init_state(jcfg, jopt, jax.random.PRNGKey(0))
    init_np = jax.device_get(state)
    raw = JBatcher(JStream(jcfg.vocab_size, 16, n_silos=n), 2, 2).batch(0)
    jstep = jax.jit(j_make_train_step(jcfg, JFed(local_steps=2, gossip_impl="einsum"),
                                      jopt, j_plan))
    j_state, j_metrics = jstep(state, {k: jax.numpy.asarray(v) for k, v in raw.items()})

    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=n)
    step = make_train_step(cfg, DPASGDConfig(local_steps=2, gossip_impl="pallas"),
                           momentum(0.05, 0.9), plan)
    port_state, metrics = step(from_jax_params(init_np, device="cpu"),
                               batch_to_device(raw, CPU))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), atol=2e-5)
    expect = from_jax_params(jax.device_get(j_state), device="cpu")
    np.testing.assert_allclose(port_state["params"].numpy(), expect["params"].numpy(),
                               atol=2e-5)
