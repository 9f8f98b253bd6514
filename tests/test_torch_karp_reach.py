"""The persistent K1 recursions' plain versions against the JAX package.

On the card ``karp_cycle_time`` runs every Karp level of a batch of
scores in one launch and ``reach_from_zero`` the climb's forward and
backward reachability in one launch; here, on the CPU, both wrappers take
their plain versions, which this file holds to the reference: the Karp
scatter loop bit for bit against ``batched_cycle_time_sparse_jax`` in
float32 and to rtol 1e-12 against the host engine in float64, and the
reachability loop exactly against the reference climb's reach body
(``src/repro/core/topologies.py``, rebuilt here from ``jax.ops.segment_max``
and ``jnp.take_along_axis``).  A numpy emulation of the kernel's
arithmetic -- each add, subtraction and division rounded once to the
input type -- equals the plain version bit for bit in all four dtypes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core.maxplus_sparse import batched_cycle_time_sparse_jax  # noqa: E402
from repro_torch.core.maxplus_sparse import (  # noqa: E402
    EdgeBatch,
    batched_cycle_time_sparse,
    batched_cycle_time_sparse_torch,
)
from repro_torch.kernels import LAUNCHES, karp_cycle_time, reach_from_zero  # noqa: E402
from repro_torch.kernels.segment_max import (  # noqa: E402
    karp_cycle_time_cuda,
    karp_cycle_time_ref,
    reach_from_zero_cuda,
    reach_from_zero_ref,
)

TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16}
NP_DTYPES = {"float32": np.float32, "float64": np.float64,
             "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


def _arc_lists(rng, B, n, E, p_absent=0.2):
    """``[B, E]`` arcs: a self-loop per node plus random arcs, a share of
    them absent (``-inf``), one row acyclic (a path, no self-loops)."""
    src = rng.integers(0, n, (B, E))
    dst = rng.integers(0, n, (B, E))
    src[:, :n], dst[:, :n] = np.arange(n), np.arange(n)
    w = rng.uniform(0.5, 20.0, (B, E)).astype(np.float32)
    w[rng.random((B, E)) < p_absent] = -np.inf
    if B > 1 and n > 1:  # row 1: the path 0 -> 1 -> ... -> n-1
        w[1] = -np.inf
        src[1, : n - 1], dst[1, : n - 1] = np.arange(n - 1), np.arange(1, n)
        w[1, : n - 1] = 1.0
    return src.astype(np.int32), dst.astype(np.int32), w


@pytest.mark.parametrize("B,n,E,seed", [(1, 1, 1, 0), (3, 5, 15, 1), (4, 24, 72, 2),
                                        (2, 40, 200, 3), (5, 17, 17, 4)])
def test_plain_karp_bit_identical_to_jax_float32(B, n, E, seed):
    src, dst, w = _arc_lists(np.random.default_rng(seed), B, n, E)
    want = np.asarray(batched_cycle_time_sparse_jax(src, dst, w, n, kernel="xla"))
    got = karp_cycle_time_ref(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(w), n)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
    if B > 1 and n > 1:
        assert np.isneginf(got.numpy()[1])  # the acyclic row


@pytest.mark.parametrize("B,n,E,seed", [(3, 5, 15, 5), (4, 24, 96, 6), (2, 61, 183, 7)])
def test_plain_karp_float64_matches_host_engine(B, n, E, seed):
    src, dst, w = _arc_lists(np.random.default_rng(seed), B, n, E)
    w64 = w.astype(np.float64)
    host = batched_cycle_time_sparse(EdgeBatch(src, dst, w64, n))
    got = karp_cycle_time_ref(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(w64), n)
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-12)


def _emulated_karp(src, dst, w, n, np_dt):
    """The kernel's arithmetic in numpy: levels and the final formula with
    every add, subtraction and division computed in float32 (float64 for
    float64) and rounded once to ``np_dt``."""
    wide = np.float64 if np_dt == np.float64 else np.float32

    def rnd(x):
        return np.asarray(x, dtype=wide).astype(np_dt).astype(wide)

    B = src.shape[0]
    wv = rnd(w)
    cur = np.zeros((B, n), dtype=wide)
    levels = [cur]
    for _ in range(n):
        vals = rnd(np.take_along_axis(cur, src, 1) + wv)
        nxt = np.full((B, n), -np.inf, dtype=wide)
        for b in range(B):
            np.maximum.at(nxt[b], dst[b], vals[b])
        cur = nxt
        levels.append(cur)
    dn = levels[-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratios = np.stack([rnd(rnd(dn - levels[k]) / rnd(n - k)) for k in range(n)])
    ratios = np.where(np.isnan(ratios), np.inf, ratios)
    mins = np.where(np.isneginf(dn), -np.inf, ratios.min(axis=0))
    return mins.max(axis=1).astype(np_dt)


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("B,n,E,seed", [(3, 5, 15, 8), (4, 31, 93, 9)])
def test_plain_karp_equals_the_kernels_arithmetic(dtype, B, n, E, seed):
    src, dst, w = _arc_lists(np.random.default_rng(seed), B, n, E)
    t_dt, np_dt = TORCH_DTYPES[dtype], NP_DTYPES[dtype]
    want = _emulated_karp(src, dst, w.astype(np_dt).astype(np.float64), n, np_dt)
    t_w = torch.from_numpy(w).to(t_dt)
    got = karp_cycle_time_ref(torch.from_numpy(src), torch.from_numpy(dst), t_w, n)
    assert got.dtype == t_dt
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_every_cpu_path_of_the_twin_equals_the_plain_karp(dtype):
    """``scatter``, ``padded`` and ``cuda`` (its plain version here) stay
    bit-identical to the persistent kernel's plain version."""
    n, E = 24, 96
    rng = np.random.default_rng(10)
    src, dst, w = _arc_lists(rng, 4, n, E, p_absent=0.3)
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(w).to(TORCH_DTYPES[dtype]))
    want = karp_cycle_time_ref(*args, n)
    deg = int(max(np.bincount(d[np.isfinite(ww)], minlength=n).max()
                  for d, ww in zip(dst, w)))
    for kernel, kw in (("scatter", {}), ("padded", {"max_in_degree": deg}), ("cuda", {}),
                       ("auto", {})):
        got = batched_cycle_time_sparse_torch(*args, n, kernel=kernel, **kw)
        assert torch.equal(got, want), kernel


def _jax_reach(take_idx, seg, present, B, n):
    """The reference climb's reach body (src/repro/core/topologies.py)."""
    r0 = jnp.zeros((B, n), dtype=jnp.float32).at[:, 0].set(1.0)

    def body(_, r):
        vals = jnp.take_along_axis(r, take_idx, axis=1) * present
        hop = jax.ops.segment_max(vals.ravel(), seg, num_segments=B * n).reshape(B, n)
        return jnp.maximum(r, hop)

    return np.asarray(jax.lax.fori_loop(0, max(n - 1, 0), body, r0)) > 0


def _universes(rng, B, n, S):
    """Multi-universe arc slots: row b lives on its first ``m_b`` nodes
    (the rest are padding), vertex ``m_b - 1`` of some rows is isolated,
    and only arcs among live, distinct nodes can be present."""
    m = rng.integers(1, n + 1, B)
    m[0] = n
    src = rng.integers(0, n, (B, S))
    dst = rng.integers(0, n, (B, S))
    live = (src < m[:, None]) & (dst < m[:, None]) & (src != dst)
    present = live & (rng.random((B, S)) < 0.7)
    iso = (m - 1)[:, None]
    present &= ~((rng.random(B) < 0.5)[:, None] & ((src == iso) | (dst == iso)))
    return src, dst, present


@pytest.mark.parametrize("B,n,S,seed", [(1, 1, 2, 0), (4, 6, 12, 1), (6, 16, 24, 2),
                                        (3, 30, 90, 3), (8, 12, 10, 4)])
def test_plain_reach_equals_reference_body(B, n, S, seed):
    src, dst, present = _universes(np.random.default_rng(seed), B, n, S)
    boff = np.arange(B)[:, None] * n
    pf = present.astype(np.float32)
    fwd = _jax_reach(jnp.asarray(src), jnp.asarray((boff + dst).ravel()), pf, B, n)
    bwd = _jax_reach(jnp.asarray(dst), jnp.asarray((boff + src).ravel()), pf, B, n)
    got = reach_from_zero_ref(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(present), n)
    assert got.dtype == torch.bool and got.shape == (2, B, n)
    np.testing.assert_array_equal(got[0].numpy(), fwd)
    np.testing.assert_array_equal(got[1].numpy(), bwd)
    assert bool(got[:, :, 0].all())  # vertex 0 reaches itself


def test_reach_of_a_ring_and_a_broken_ring():
    n = 7
    src = torch.arange(n)[None].repeat(2, 1)
    dst = (src + 1) % n
    present = torch.ones((2, n), dtype=torch.bool)
    present[1, 3] = False  # 3 -> 4 cut: forward stops at 3, backward at 4
    got = reach_from_zero(src, dst, present, n)
    assert bool(got[:, 0].all())
    assert got[0, 1].tolist() == [True] * 4 + [False] * 3
    assert got[1, 1].tolist() == [True] + [False] * 3 + [True] * 3


def test_wrappers_route_cpu_tensors_to_plain_and_count_no_launch():
    rng = np.random.default_rng(11)
    src, dst, w = _arc_lists(rng, 3, 9, 27)
    args = [torch.from_numpy(a) for a in (src, dst, w)]
    before = dict(LAUNCHES)
    assert torch.equal(karp_cycle_time(*args, 9), karp_cycle_time_ref(*args, 9))
    present = torch.from_numpy(np.isfinite(w))
    assert torch.equal(reach_from_zero(args[0], args[1], present, 9),
                       reach_from_zero_ref(args[0], args[1], present, 9))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        karp_cycle_time(*[a.to("meta") for a in args], 9)
    with pytest.raises(ValueError, match="no kernel"):
        reach_from_zero(args[0].to("meta"), args[1].to("meta"), present.to("meta"), 9)


def _good(B=2, E=6, n=4):
    src = torch.zeros((B, E), dtype=torch.int32)
    dst = torch.ones((B, E), dtype=torch.int32)
    return src, dst, torch.ones((B, E)), torch.ones((B, E), dtype=torch.bool), n


@pytest.mark.parametrize("case", ["w_int", "w_half_ok_but_cpu", "ids_float", "ids_bool",
                                  "shape", "not_2d", "n_zero", "src_high", "dst_negative"])
def test_cuda_wrappers_check_their_inputs(case):
    """Called with CPU tensors, the CUDA wrappers refuse bad types, shapes
    and ids before anything else, and otherwise refuse the CPU itself."""
    src, dst, w, present, n = _good()
    err = ValueError
    if case == "w_int":
        w, err = w.long(), TypeError
    elif case == "w_half_ok_but_cpu":
        w = w.half()
    elif case == "ids_float":
        src, err = src.float(), TypeError
    elif case == "ids_bool":
        dst, err = dst.bool(), TypeError
    elif case == "shape":
        dst = dst[:, :-1]
    elif case == "not_2d":
        src, dst, w, present = src[0], dst[0], w[0], present[0]
    elif case == "n_zero":
        n = 0
    elif case == "src_high":
        src = src.clone()
        src[1, 2] = n
    elif case == "dst_negative":
        dst = dst.clone()
        dst[0, 0] = -1
    match = "CUDA" if case == "w_half_ok_but_cpu" else None
    with pytest.raises(err, match=match):
        karp_cycle_time_cuda(src, dst, w, n)
    if case == "w_int":  # reachability takes no weights: a float mask is its type error
        present = present.float()
    with pytest.raises(err, match=match):
        reach_from_zero_cuda(src, dst, present, n)
    if case != "w_half_ok_but_cpu":  # the dispatching wrappers' plain path checks the same
        with pytest.raises(err):
            karp_cycle_time(src, dst, w, n)
        with pytest.raises(err):
            reach_from_zero(src, dst, present, n)
