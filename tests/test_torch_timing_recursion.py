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
kernel in interpret mode.  A numpy emulation of the kernel --
order-preserving integer keys, the atomicMax fold, the carry folded as one
more max and the parity-stamped self-loop flags -- equals the plain
version bit for bit."""

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
    timing_recursion_cuda,
    timing_recursion_ref,
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


def _emulated_kernel(src, dst, w, ids, N, t0):
    """The kernel's per-chain loop in numpy: t as keys, arcs folded by a
    max over keys, the carry as one more max, self-loop stamps by parity."""
    C, R = ids.shape
    kneg = _keys(np.array([-np.inf]))[0]
    out = np.empty((C, R + 1, N))
    for c in range(C):
        cur = _keys(np.zeros(N) if t0 is None else t0[c])
        stamp = np.full((2, N), -1)
        for e in range(src.size):
            if R and src[e] == dst[e] and w[ids[c, 0], e] > -np.inf:
                stamp[0, dst[e]] = 0
        out[c, 0] = _unkeys(cur)
        for k in range(R):
            nxt = np.full(N, kneg, dtype=np.uint64)
            for e in range(src.size):
                x = _unkeys(cur[src[e]:src[e] + 1])[0] + w[ids[c, k], e]
                if x != -np.inf:
                    nxt[dst[e]] = max(nxt[dst[e]], _keys(np.array([x]))[0])
                if (k + 1 < R and src[e] == dst[e]
                        and w[ids[c, k + 1], e] > -np.inf):
                    stamp[(k + 1) & 1, dst[e]] = k + 1
            carry = stamp[k & 1] != k
            nxt[carry] = np.maximum(nxt[carry], cur[carry])
            cur = nxt
            out[c, k + 1] = _unkeys(cur)
    return out


@pytest.mark.parametrize("case", [CASES[2], CASES[4], CASES[6]], ids=["carry", "scatter", "tiny"])
def test_plain_equals_the_kernels_key_fold(case):
    N, E, U, C, R, full_cover, drop_self, t0 = case
    rng = np.random.default_rng(200 + sum(case[:5]))
    src, dst, w, ids, start = _pool(rng, N, E, U, C, R, full_cover=full_cover,
                                    drop_self=drop_self, t0=t0)
    want = timing_recursion_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                                torch.from_numpy(ids), N,
                                None if start is None else torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(_emulated_kernel(src, dst, w, ids, N, start), want)


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
