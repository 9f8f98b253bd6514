"""The port's dict-graph max-plus API (``repro_torch.core.maxplus``), the
six numpy edge-list engines of ``repro_torch.core.maxplus_sparse`` and
``lognormal_sizes`` / ``jensen_shannon`` held against the JAX package's.

Inputs are made from a seed with numpy (the overlays are the port's
deterministic designs on the paper's Gaia and Ebone underlays) and go
through both packages.  Tolerance: none.  Every result is compared for
exact equality, floats bit for bit, because both packages run the same
float64 arithmetic in the same order.
"""

import contextlib
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.analysis.contracts as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.data as RD  # noqa: E402
import repro_torch.analysis.contracts as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.data as PD  # noqa: E402
from repro.core import maxplus_sparse as RS  # noqa: E402
from repro_torch.core import maxplus_sparse as PS  # noqa: E402

GRAPHS = ("gaia_ring", "gaia_mst", "ebone_mst", "random_mixed", "acyclic")


@functools.lru_cache(maxsize=None)
def _delays(name):
    """An arc -> delay dict (self-loops included where the graph has them)."""
    if name in ("gaia_ring", "gaia_mst", "ebone_mst"):
        net, kind = name.split("_")
        M, Tc = P.WORKLOADS["inaturalist"]
        gc = P.make_underlay(net).connectivity_graph(comp_time_ms=Tc)
        tp = P.TrainingParams(model_size_mbits=M, local_steps=1)
        ov = P.design_overlay(kind, gc, tp, device="cpu")
        return tuple(P.overlay_delay_digraph(gc, tp, ov.edges).delays.items())
    rng = np.random.default_rng(7)
    out = {}
    if name == "random_mixed":
        # two strongly connected blocks (0-4, 5-8) joined one way, and an
        # acyclic tail 9-13 hanging off them with no self-loops
        for block in (range(0, 5), range(5, 9)):
            nodes = list(block)
            for a, b in zip(nodes, nodes[1:] + nodes[:1]):
                out[(a, b)] = float(rng.uniform(1.0, 9.0))
            for _ in range(4):
                a, b = rng.choice(nodes, 2, replace=False)
                out[(int(a), int(b))] = float(rng.uniform(1.0, 9.0))
            for v in nodes[::2]:
                out[(v, v)] = float(rng.uniform(0.5, 3.0))
        out[(2, 6)] = float(rng.uniform(1.0, 9.0))
        for v in range(9, 14):
            src = int(rng.integers(0, v))
            out[(src, v)] = float(rng.uniform(1.0, 9.0))
    else:  # a DAG: no circuit at all
        for v in range(1, 9):
            for u in rng.choice(v, min(v, 2), replace=False):
                out[(int(u), v)] = float(rng.uniform(1.0, 9.0))
    return tuple(out.items())


def _pair(name):
    d = dict(_delays(name))
    return R.DelayDigraph.from_edges(d), P.DelayDigraph.from_edges(d)


def _same(a, b):
    """Exact equality that also holds for -inf/inf and nested containers."""
    if isinstance(a, float) or isinstance(b, float):
        assert type(a) is type(b) or {type(a), type(b)} <= {float, np.float64}
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


CALLS = {
    "max_cycle_mean": lambda M, g: M.max_cycle_mean(g),
    "max_cycle_mean_legacy": lambda M, g: M.max_cycle_mean_legacy(g),
    "cycle_time": lambda M, g: M.cycle_time(g),
    "throughput": lambda M, g: M.throughput(g),
    "strongly_connected_components": lambda M, g: M.strongly_connected_components(g),
    "is_strongly_connected": lambda M, g: M.is_strongly_connected(g),
    "timing_recursion": lambda M, g: M.timing_recursion(g, 40),
    "timing_recursion_t0": lambda M, g: M.timing_recursion(
        g, 25, {v: 1.5 * k for k, v in enumerate(g.nodes[::3])}),
    "timing_recursion_legacy": lambda M, g: M.timing_recursion_legacy(g, 40),
    "empirical_cycle_time": lambda M, g: M.empirical_cycle_time(g, 120),
    "critical_circuit": lambda M, g: M.critical_circuit(g),
    "critical_circuit_legacy": lambda M, g: M.critical_circuit_legacy(g),
    "to_matrix": lambda M, g: tuple(np.asarray(x).tolist() for x in g.to_matrix()),
}


@pytest.mark.parametrize("fn", sorted(CALLS))
@pytest.mark.parametrize("graph", GRAPHS)
def test_dict_graph_api_matches_reference(graph, fn):
    ref_g, port_g = _pair(graph)
    _same(CALLS[fn](R, ref_g), CALLS[fn](P, port_g))


@pytest.mark.parametrize("graph", GRAPHS)
def test_dict_graph_api_is_self_consistent(graph):
    """The delegating entry points agree with the legacy oracles (the
    reference's own equivalence property, on the port)."""
    _, g = _pair(graph)
    tau = P.cycle_time(g)
    assert P.max_cycle_mean_legacy(g) == pytest.approx(tau, rel=1e-12, abs=0.0) or (
        np.isneginf(tau) and np.isneginf(P.max_cycle_mean_legacy(g)))
    ctau, circuit = P.critical_circuit(g)
    assert ctau == tau
    if np.isneginf(tau):
        assert circuit == [] and P.throughput(g) == np.inf
        return
    assert circuit[0] == circuit[-1]
    mean = sum(g.delays[(a, b)] for a, b in zip(circuit, circuit[1:])) / (len(circuit) - 1)
    assert mean == pytest.approx(tau, rel=1e-9)


# ---------------------------------------------------------------------------
# The numpy edge-list engines


def _dense_stack(seed, B=3, N=7, p=0.4):
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.5, 10.0, (B, N, N))
    W[rng.random((B, N, N)) > p] = -np.inf
    return W


def _assert_eb_equal(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.num_nodes == b.num_nodes


@pytest.mark.parametrize("case", ["batch", "single", "e_max"])
def test_dense_to_edge_batch_and_back(case):
    W = _dense_stack(1)
    kw = {}
    if case == "single":
        W = W[0]
    elif case == "e_max":
        kw = {"e_max": 40}
    ref, port = RS.dense_to_edge_batch(W, **kw), PS.dense_to_edge_batch(W, **kw)
    _assert_eb_equal(ref, port)
    back = PS.edge_batch_to_dense(port)
    np.testing.assert_array_equal(back, RS.edge_batch_to_dense(ref))
    np.testing.assert_array_equal(back, W if W.ndim == 3 else W[None])


def test_edge_batch_to_dense_keeps_the_max_of_duplicate_arcs():
    src = np.array([[0, 0, 1, 1]], dtype=np.int32)
    dst = np.array([[1, 1, 0, 1]], dtype=np.int32)
    w = np.array([[2.0, 5.0, 1.0, -np.inf]])
    ref = RS.edge_batch_to_dense(RS.EdgeBatch(src, dst, w, 2))
    port = PS.edge_batch_to_dense(PS.EdgeBatch(src, dst, w, 2))
    np.testing.assert_array_equal(port, ref)
    assert port[0, 0, 1] == 5.0


def test_dense_to_edge_batch_refuses_a_small_e_max():
    with pytest.raises(ValueError, match="e_max"):
        PS.dense_to_edge_batch(_dense_stack(1), e_max=2)


@pytest.mark.parametrize("graph", GRAPHS)
def test_cycle_time_sparse_matches_reference(graph):
    d = dict(_delays(graph))
    nodes = list(dict.fromkeys(v for e in d for v in e))
    idx = {v: k for k, v in enumerate(nodes)}
    src = [idx[i] for i, _ in d]
    dst = [idx[j] for _, j in d]
    w = list(d.values())
    got = PS.cycle_time_sparse(src, dst, w, len(nodes))
    assert got == RS.cycle_time_sparse(src, dst, w, len(nodes))
    assert got == P.cycle_time(P.DelayDigraph.from_edges(d)) or (
        np.isneginf(got) and np.isneginf(P.cycle_time(P.DelayDigraph.from_edges(d))))


@pytest.mark.parametrize("t0", [False, True])
def test_batched_timing_recursion_sparse_matches_reference(t0):
    W = _dense_stack(2, B=4, N=9)
    loops = np.arange(0, 9, 2)
    W[:, loops, loops] = 1.0  # self-loops on every other vertex
    eb_r, eb_p = RS.dense_to_edge_batch(W), PS.dense_to_edge_batch(W)
    init = np.random.default_rng(3).uniform(0, 5, (4, 9)) if t0 else None
    got = PS.batched_timing_recursion_sparse(eb_p, 30, init)
    np.testing.assert_array_equal(got, RS.batched_timing_recursion_sparse(eb_r, 30, init))
    np.testing.assert_array_equal(got, P.batched_timing_recursion(W, 30, init))


def _pool(seed, full_cover):
    """An Eq. 3-like pool: arcs of a random graph plus (with full_cover)
    every vertex's self-loop; U distinct weight rows with absent arcs."""
    rng = np.random.default_rng(seed)
    N, E0, U = 8, 18, 5
    src = rng.integers(0, N, E0)
    dst = (src + rng.integers(1, N, E0)) % N
    if full_cover:
        src = np.concatenate([src, np.arange(N)])
        dst = np.concatenate([dst, np.arange(N)])
    E = src.size
    w = rng.uniform(1.0, 8.0, (U, E))
    w[rng.random((U, E)) < 0.3] = -np.inf
    if full_cover:
        w[:, E0:] = rng.uniform(0.5, 2.0, (U, N))
        w[1, E0 + 2] = -np.inf  # one row misses a self-loop
    return src, dst, w, N


@pytest.mark.parametrize("full_cover", [True, False])
@pytest.mark.parametrize("sorted_by_dst", [False, True])
def test_timing_recursion_unique_rounds_sparse_matches_reference(full_cover, sorted_by_dst):
    src, dst, w, N = _pool(4, full_cover)
    if sorted_by_dst:
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[:, order]
    ids = np.random.default_rng(5).integers(0, w.shape[0], (3, 20))
    t0 = np.random.default_rng(6).uniform(0, 2, (3, N))
    for init in (None, t0):
        got = PS.timing_recursion_unique_rounds_sparse(src, dst, w, ids, N, init)
        ref = RS.timing_recursion_unique_rounds_sparse(src, dst, w, ids, N, init)
        np.testing.assert_array_equal(got, ref)
    # and the port's device twin, on the CPU, bit for bit in float64
    import torch
    twin = PS.timing_recursion_unique_rounds_sparse_torch(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        torch.from_numpy(ids), N)
    np.testing.assert_array_equal(twin.numpy(), PS.timing_recursion_unique_rounds_sparse(
        src, dst, w, ids, N))


@contextlib.contextmanager
def _checks(on):
    """Both packages' contract checks on or off, as they were after."""
    was = (RC._FORCED, PC.checking_enabled())
    for c in (RC, PC):
        (c.enable if on else c.disable)()
    try:
        yield
    finally:
        RC._FORCED = was[0]
        (PC.enable if was[1] else PC.disable)()


def _refused_alike(port_call, ref_call):
    """Both packages refuse the call alike: with checks on, each its own
    ``ContractError`` (a ``TypeError``) with the same text; with them
    off, the body's ``ValueError`` with the same text."""
    for on, err in ((True, TypeError), (False, ValueError)):
        with _checks(on):
            with pytest.raises(err) as ref:
                ref_call()
            with pytest.raises(err) as got:
                port_call()
        assert type(got.value).__name__ == type(ref.value).__name__
        assert str(got.value) == str(ref.value)


def test_timing_recursion_unique_rounds_sparse_refuses_bad_shapes():
    src, dst, w, N = _pool(4, True)
    ids = np.zeros((2, 3), int)
    _refused_alike(lambda: PS.timing_recursion_unique_rounds_sparse(src, dst, w[:, :-1], ids, N),
                   lambda: RS.timing_recursion_unique_rounds_sparse(src, dst, w[:, :-1], ids, N))


def test_timing_recursion_time_varying_sparse_matches_reference():
    src, dst, w, N = _pool(8, True)
    rng = np.random.default_rng(9)
    stack = w[rng.integers(0, w.shape[0], (2, 12))]  # [C, R, E]
    got = PS.timing_recursion_time_varying_sparse(src, dst, stack, N)
    np.testing.assert_array_equal(got, RS.timing_recursion_time_varying_sparse(src, dst, stack, N))
    _refused_alike(lambda: PS.timing_recursion_time_varying_sparse(src, dst, stack[0], N),
                   lambda: RS.timing_recursion_time_varying_sparse(src, dst, stack[0], N))


# ---------------------------------------------------------------------------
# Data partitioning


@pytest.mark.parametrize("n,total,seed", [(11, 50_000, 0), (87, 1_000_000, 3), (4, 10, 1)])
def test_lognormal_sizes_matches_reference(n, total, seed):
    got = PD.lognormal_sizes(n, total, seed=seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, RD.lognormal_sizes(n, total, seed=seed))


@pytest.mark.parametrize("alpha", [0.05, 0.3, 5.0])
def test_jensen_shannon_matches_reference(alpha):
    from repro.data.partition import jensen_shannon as ref_js

    probs = PD.dirichlet_vocab_partition(6, 40, alpha=alpha, seed=2)
    for i in range(5):
        got = PD.jensen_shannon(probs[i], probs[i + 1])
        assert got == ref_js(probs[i], probs[i + 1])
        assert 0.0 <= got <= np.log(2) + 1e-12
    assert PD.jensen_shannon(probs[0], probs[0]) == 0.0
