"""The round-varying Eq. 4 recursion of the port against the JAX package.

On the card ``repro_torch.kernels.timing_recursion`` runs every round of
every Monte-Carlo chain in one launch of the persistent K1 recursion;
here, on the CPU, it takes its plain version (one gather and one
``scatter_reduce_`` a round), which this file holds to the reference:
bit for bit against the reference's numpy host engines
(``timing_recursion_unique_rounds_sparse`` on both its full-cover and its
scatter path, missing self-loops and ``t0`` included, on random pools and
on the pool MATCHA pricing builds for Gaia, and
``timing_recursion_time_varying_sparse``), and at the reference's rtol
1e-6 against ``timing_recursion_time_varying_sparse_jax`` with the Pallas
kernel in interpret mode.  A numpy emulation of the cluster kernel -- the
arcs split over 1, 2, 4 or 8 CTAs as ``timing_plan`` cuts them,
order-preserving integer keys, each CTA's arcs grouped by dst and folded
by groups of lanes into per-CTA partials (or one atomic max an arc when
they are read in place), the cross-CTA max, and the carry where no CTA
flagged a present self-loop -- equals the plain
version bit for bit; the rule that picks the cluster, the split and the
ring's depth is held to its examples."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.contracts import ContractError  # noqa: E402

import repro.core.maxplus_sparse as ref_sparse  # noqa: E402
import repro_torch.core.maxplus_sparse as port_sparse  # noqa: E402
from repro.core.maxplus_sparse import timing_recursion_time_varying_sparse_jax  # noqa: E402
from repro_torch.kernels import LAUNCHES, timing_recursion  # noqa: E402
from repro_torch.kernels.segment_max import (  # noqa: E402
    TIMING_CLUSTERS,
    TIMING_MAX_STAGES,
    TIMING_MIN_ARCS_PER_CTA,
    timing_plan,
    timing_recursion_cuda,
    timing_recursion_ref,
    timing_smem_bytes,
)


def _pool(rng, N, E, U, C, R, *, full_cover, drop_self, t0):
    """An arc pool as MATCHA's pricing builds it: random arcs plus (with
    ``full_cover``) one self-loop per vertex; ``drop_self`` removes some
    self-loops from some rows (the carry) and makes one row all -inf;
    without ``full_cover`` the arcs' dst skips some vertices (the scatter
    path)."""
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N if full_cover else max(N - 2, 1), E)
    if full_cover:
        src = np.concatenate([src, np.arange(N)])
        dst = np.concatenate([dst, np.arange(N)])
    w = np.where(rng.random((U, src.size)) < 0.7, rng.uniform(0.1, 40.0, (U, src.size)), -np.inf)
    if full_cover:
        w[:, E:] = rng.uniform(0.5, 5.0, (U, N))
    if drop_self:
        loops = np.flatnonzero(src == dst)
        w[:, loops] = np.where(rng.random((U, loops.size)) < 0.4, -np.inf, w[:, loops])
        w[U - 1] = -np.inf
    ids = rng.integers(0, U, (C, R))
    start = rng.uniform(0.0, 10.0, (C, N)) if t0 else None
    return src, dst, w, ids, start


CASES = [
    # N, E, U, C, R, full_cover, drop_self, t0
    (5, 7, 3, 2, 8, True, False, False),
    (11, 40, 6, 3, 30, True, False, True),
    (11, 40, 6, 3, 30, True, True, False),
    (9, 25, 4, 4, 20, False, False, False),
    (9, 25, 4, 4, 20, False, True, True),
    (24, 96, 12, 6, 50, True, True, True),
    (3, 1, 2, 1, 5, False, True, False),
]



@contextlib.contextmanager
def _checks(on):
    """The port's contract checks on (True), off (False) or as they are
    (None), as they were after."""
    was = contracts.checking_enabled()
    if on is not None:
        (contracts.enable if on else contracts.disable)()
    try:
        yield
    finally:
        (contracts.enable if was else contracts.disable)()

@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_plain_bit_identical_to_reference_unique_rounds(case):
    N, E, U, C, R, full_cover, drop_self, t0 = case
    rng = np.random.default_rng(sum(case[:5]))
    src, dst, w, ids, start = _pool(rng, N, E, U, C, R, full_cover=full_cover,
                                    drop_self=drop_self, t0=t0)
    want = ref_sparse.timing_recursion_unique_rounds_sparse(src, dst, w, ids, N, start)
    got = timing_recursion_ref(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(w), torch.from_numpy(ids), N,
                               None if start is None else torch.from_numpy(start))
    assert got.dtype == torch.float64 and got.shape == (C, R + 1, N)
    np.testing.assert_array_equal(got.numpy(), want)
    twin = port_sparse.timing_recursion_unique_rounds_sparse_torch(src, dst, torch.from_numpy(w),
                                                                   ids, N, start)
    np.testing.assert_array_equal(twin.numpy(), want)


@pytest.mark.parametrize("case", CASES[:5], ids=[f"case{i}" for i in range(5)])
def test_time_varying_twin_bit_identical_to_reference(case):
    N, E, U, C, R, full_cover, drop_self, t0 = case
    rng = np.random.default_rng(100 + sum(case[:5]))
    src, dst, w, ids, start = _pool(rng, N, E, U, C, R, full_cover=full_cover,
                                    drop_self=drop_self, t0=t0)
    stack = w[ids]  # [C, R, E]
    want = ref_sparse.timing_recursion_time_varying_sparse(src, dst, stack, N, start)
    got = port_sparse.timing_recursion_unique_rounds_sparse_torch(
        src, dst, torch.from_numpy(stack.reshape(C * R, -1)), np.arange(C * R).reshape(C, R), N,
        start)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [2, 3])
def test_time_varying_twin_matches_jax_pallas(seed):
    """The reference's own check (tests/test_schedule.py), with the Pallas
    kernel in interpret mode on the JAX side: every self-loop present (the
    JAX twin has no carry), float32 there, rtol 1e-6."""
    rng = np.random.default_rng(seed)
    N, C, R, E = 5, 2, 8, 7
    src = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    w = np.where(rng.random((C, R, E + N)) < 0.8, rng.uniform(0.1, 10.0, (C, R, E + N)), -np.inf)
    w[:, :, E:] = rng.uniform(0.0, 3.0, (C, R, N))
    want = np.asarray(timing_recursion_time_varying_sparse_jax(src, dst, w, N, kernel="pallas"))
    got = port_sparse.timing_recursion_unique_rounds_sparse_torch(
        src, dst, torch.from_numpy(w.reshape(C * R, -1)), np.arange(C * R).reshape(C, R), N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    got32 = timing_recursion(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(w.reshape(C * R, -1).astype(np.float32)),
                             torch.arange(C * R).view(C, R), N)
    np.testing.assert_allclose(got32.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("budget", [0.2, 0.7])
def test_plain_bit_identical_to_reference_on_a_matcha_pool(budget):
    """The pool MATCHA pricing hands the recursion (Gaia, one budget x 3
    seeds x 40 rounds): dst-presorted arcs with a self-loop per silo, the
    reference's full-cover reduceat path."""
    import repro_torch.core as P
    from repro_torch.core.schedule import _sweep_inputs

    M, Tc = P.WORKLOADS["inaturalist"]
    gc = P.make_underlay("gaia").connectivity_graph(comp_time_ms=Tc)
    tp = P.TrainingParams(model_size_mbits=M, local_steps=1)
    sched = P.MatchaSchedule(matchings=P.matcha_schedule_from_connectivity(gc).matchings,
                             budget=budget)
    src, dst, w, ids = _sweep_inputs([sched], gc, tp, 40, (0, 1, 2))
    want = ref_sparse.timing_recursion_unique_rounds_sparse(src, dst, w, ids, gc.num_silos)
    got = timing_recursion_ref(*(torch.from_numpy(a) for a in (src, dst, w, ids)), gc.num_silos)
    np.testing.assert_array_equal(got.numpy(), want)


def _keys(x):
    """The kernel's order-preserving uint64 key of a float64 array."""
    b = np.asarray(x, dtype=np.float64).view(np.uint64)
    sign = np.uint64(1 << 63)
    return np.where(b & sign, ~b, b | sign)


def _unkeys(k):
    sign = np.uint64(1 << 63)
    return np.where(k & sign, k & ~sign, ~k).view(np.float64)


def _group_size(n, m):
    """The kernel's lanes a dst: the power of two up to 32 at most the
    CTA's mean arcs a dst (n arcs over m dsts)."""
    G = 1
    while G < 32 and 2 * G * max(m, 1) <= n:
        G *= 2
    return G


def _emulated_kernel(src, dst, w, ids, N, t0, cluster, staged=True):
    """The cluster kernel's fold in numpy.  ``cluster`` CTAs each take a
    contiguous slice of ``ceil(E / cluster)`` arcs (the last ones may be
    short or empty, as :func:`timing_plan` cuts them).  Staged, a CTA
    groups its arcs by dst (a counting sort), a group of G lanes folds each
    dst (lane j takes every G-th arc from the j-th, a running max of keys),
    the group's max by an xor tree, written as the CTA's partial; in place,
    one atomic max of keys an arc.  Each CTA flags the dst of its present
    self-loops.  Then the cross-CTA max of the partials and the OR of the
    flags, with the carry t_v(k) where no CTA flagged v."""
    C, R = ids.shape
    E = src.size
    arcs = -(-E // cluster)
    kneg = _keys(np.array([-np.inf]))[0]
    slices = [(min(E, r * arcs), min(E, r * arcs + arcs)) for r in range(cluster)]
    groups = []  # per CTA: [(v, its arcs)], G
    for lo, hi in slices:
        order = lo + np.argsort(dst[lo:hi], kind="stable")[::-1]  # any order within a dst
        nodes = np.unique(dst[lo:hi])
        groups.append(([(v, order[dst[order] == v]) for v in nodes],
                       _group_size(hi - lo, nodes.size)))
    out = np.empty((C, R + 1, N))
    for c in range(C):
        cur = np.zeros(N) if t0 is None else t0[c].copy()
        out[c, 0] = cur
        for k in range(R):
            row = w[ids[c, k]]
            parts = np.full((cluster, N), kneg, dtype=np.uint64)
            flags = np.zeros((cluster, N), dtype=bool)
            for r, (lo, hi) in enumerate(slices):
                keys = _keys(cur[src[lo:hi]] + row[lo:hi])
                present = (src[lo:hi] == dst[lo:hi]) & (row[lo:hi] > -np.inf)
                flags[r, dst[lo:hi][present]] = True
                if not staged:
                    for i in range(hi - lo):
                        if keys[i] != kneg:
                            parts[r, dst[lo + i]] = max(parts[r, dst[lo + i]], keys[i])
                    continue
                node_arcs, G = groups[r]
                for v, e in node_arcs:
                    lanes = np.full(G, kneg, dtype=np.uint64)
                    for j, ej in enumerate(e):
                        lanes[j % G] = max(lanes[j % G], _keys(cur[src[ej]] + row[ej]))
                    o = 1
                    while o < G:
                        lanes = np.maximum(lanes, lanes[np.arange(G) ^ o])
                        o *= 2
                    parts[r, v] = lanes[0]
            m = parts.max(axis=0)
            carry = ~flags.any(axis=0)
            m[carry] = np.maximum(m[carry], _keys(cur[carry]))
            cur = _unkeys(m)
            out[c, k + 1] = cur
    return out


@pytest.mark.parametrize("staged", [True, False], ids=["grouped", "in_place"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [CASES[2], CASES[4], CASES[6]], ids=["carry", "scatter", "tiny"])
def test_plain_equals_the_kernels_key_fold(case, cluster, staged):
    """Cluster sizes that divide neither E (40, 25 and 1 arcs, plus the
    self-loops) nor N (11, 9, 3), so some CTAs hold few arcs or none; the
    pools' arcs are unsorted, so the counting sort regroups them."""
    N, E, U, C, R, full_cover, drop_self, t0 = case
    rng = np.random.default_rng(200 + sum(case[:5]))
    src, dst, w, ids, start = _pool(rng, N, E, U, C, R, full_cover=full_cover,
                                    drop_self=drop_self, t0=t0)
    want = timing_recursion_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                                torch.from_numpy(ids), N,
                                None if start is None else torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(_emulated_kernel(src, dst, w, ids, N, start, cluster, staged),
                                  want)


def test_kernels_key_fold_on_a_dst_sorted_matcha_pool():
    """Gaia's MATCHA pool, arcs sorted by dst as the engine hands them to
    the card, split over 4 CTAs: dsts cut between two CTAs at a slice's
    edge, groups of several lanes."""
    import repro_torch.core as P
    from repro_torch.core.schedule import _sweep_inputs

    M, Tc = P.WORKLOADS["inaturalist"]
    gc = P.make_underlay("gaia").connectivity_graph(comp_time_ms=Tc)
    tp = P.TrainingParams(model_size_mbits=M, local_steps=1)
    sched = P.MatchaSchedule(matchings=P.matcha_schedule_from_connectivity(gc).matchings,
                             budget=0.5)
    src, dst, w, ids = _sweep_inputs([sched], gc, tp, 12, (0, 1))
    assert (np.diff(dst) >= 0).all()
    want = timing_recursion_ref(*(torch.from_numpy(a) for a in (src, dst, w, ids)), gc.num_silos)
    got = _emulated_kernel(src, dst, w, ids, gc.num_silos, None, 4)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("C,E,N,want", [
    (24, 7569, 87, (4, 1893)),    # Ebone's MATCHA design shape: 96 CTAs
    (64, 590, 64, (2, 295)),      # the engine shape: 4 x 148 arcs is under the floor
    (16, 8 * TIMING_MIN_ARCS_PER_CTA + 1, 87, (8, TIMING_MIN_ARCS_PER_CTA + 1)),
    (64, 2 * TIMING_MIN_ARCS_PER_CTA, 64, (2, TIMING_MIN_ARCS_PER_CTA)),
    (67, 30000, 87, (1, 30000)),  # C past half the SMs: one CTA a chain
    (200, 30000, 87, (1, 30000)),  # C past the SM count
    (3, 1, 2, (1, 1)),            # one arc
    (3, 7, 5, (1, 7)),            # tiny E
    (16, 4097, 2000, (2, 2049)),  # 4 or 8 CTAs' inboxes of 2000 nodes do not fit
])
def test_timing_plan_picks_the_cluster_and_the_split(C, E, N, want):
    plan = timing_plan(C, E, N, 8, num_sms=132, smem_cap=232448)
    assert (plan.cluster, plan.arcs_per_cta) == want
    assert plan.cluster * plan.arcs_per_cta >= E > (plan.cluster - 1) * plan.arcs_per_cta
    assert plan.cluster in (1,) + TIMING_CLUSTERS and C * plan.cluster <= max(132, C)
    assert plan.smem_bytes == timing_smem_bytes(N, plan.arcs_per_cta, plan.stages, 8,
                                                plan.cluster) <= 232448


@pytest.mark.parametrize("elem", [4, 8])
def test_timing_plan_ring_depth_follows_shared_memory(elem):
    """The deepest ring that fits, at least two rounds; else the weights
    are read in place (stages 0), which always fits below the node limit."""
    cap = 232448
    assert timing_plan(24, 7569, 87, elem, num_sms=132, smem_cap=cap).stages == TIMING_MAX_STAGES
    big = timing_plan(1, 12000, 87, elem, num_sms=1, smem_cap=cap)
    assert big.cluster == 1 and big.stages == (2 if elem == 4 else 0)
    limit = (cap - 32) // (3 * elem + 1)
    at_limit = timing_plan(2, 10, limit, elem, num_sms=132, smem_cap=cap)
    assert at_limit.stages == 0 and at_limit.smem_bytes <= cap
    assert timing_smem_bytes(limit + 1, 10, 0, elem) > cap
    for stages in range(2, TIMING_MAX_STAGES + 1):
        tight = timing_smem_bytes(87, 1893, stages, elem, 4)
        assert timing_plan(24, 7569, 87, elem, num_sms=132, smem_cap=tight).stages == stages


def test_wrapper_routes_cpu_tensors_to_plain_and_counts_no_launch():
    rng = np.random.default_rng(11)
    src, dst, w, ids, _ = _pool(rng, 6, 12, 3, 2, 9, full_cover=True, drop_self=True, t0=False)
    args = [torch.from_numpy(a) for a in (src, dst, w, ids)]
    before = dict(LAUNCHES)
    assert torch.equal(timing_recursion(*args, 6), timing_recursion_ref(*args, 6))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        timing_recursion(*[a.to("meta") for a in args], 6)


@pytest.mark.parametrize("case", ["w_int", "w_half", "cpu", "ids_float", "no_arcs", "w_shape",
                                  "ids_1d", "n_zero", "t0_shape", "src_high", "round_high"])
def test_cuda_wrapper_checks_its_inputs(case):
    """Called with CPU tensors, the CUDA wrapper refuses bad types, shapes
    and ids before anything else, and otherwise refuses the CPU itself."""
    src = torch.tensor([0, 1, 1], dtype=torch.int32)
    dst = torch.tensor([0, 1, 0], dtype=torch.int32)
    w = torch.ones((2, 3), dtype=torch.float64)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    t0, n, err, match = None, 2, ValueError, None
    if case == "w_int":
        w, err = w.long(), TypeError
    elif case == "w_half":
        w, err = w.half(), TypeError
    elif case == "cpu":
        match = "CUDA"
    elif case == "ids_float":
        ids, err = ids.float(), TypeError
    elif case == "no_arcs":
        src, dst, w, match = src[:0], dst[:0], w[:, :0], "E = 0"
    elif case == "w_shape":
        w = w[:, :2]
    elif case == "ids_1d":
        ids = ids[0]
    elif case == "n_zero":
        n = 0
    elif case == "t0_shape":
        t0 = torch.zeros((3, 2), dtype=torch.float64)
    elif case == "src_high":
        src = torch.tensor([0, 2, 1], dtype=torch.int32)
    elif case == "round_high":
        ids = ids.clone()
        ids[1, 3] = 2
    # A shape the contract refuses raises its ContractError (a TypeError)
    # with checks on, and the wrapper's own ValueError with them off.
    modes = ((True, ContractError), (False, err)) if case in ("w_shape", "ids_1d", "t0_shape") \
        else ((None, err),)
    for checked, want in modes:
        with _checks(checked):
            with pytest.raises(want, match=match):
                timing_recursion_cuda(src, dst, w, ids, n, t0)
