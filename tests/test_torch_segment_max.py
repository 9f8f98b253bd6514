"""The port's segment max (K1) and its Karp twin against the JAX package.

The plain version -- the CPU path of ``edge_segment_max`` and what the
CUDA kernel is held against on the card -- matches the Pallas kernel it
replaces (run in interpret mode) bit for bit: max is exact and
order-free.  The device Karp twin matches ``batched_cycle_time_sparse_jax``
bit for bit in float32 under every segment-max implementation, and the
host engine to rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

from repro.core.maxplus_sparse import batched_cycle_time_sparse_jax  # noqa: E402
from repro.kernels.segment_max import edge_segment_max_pallas  # noqa: E402
from repro_torch.core.maxplus_sparse import (  # noqa: E402
    EdgeBatch,
    batched_cycle_time_sparse,
    batched_cycle_time_sparse_torch,
)
from repro_torch.kernels import LAUNCHES, edge_segment_max, select_segment_max_impl  # noqa: E402
from repro_torch.kernels.segment_max import edge_segment_max_cuda, edge_segment_max_ref  # noqa: E402

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64),
          "float16": (np.float16, torch.float16), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, B, E, S, dtype=np.float32):
    vals = rng.standard_normal((B, E)).astype(np.float32)
    vals[rng.random((B, E)) < 0.15] = -np.inf
    # ids in [-1, S]: -1 and S are out of range and must be dropped
    ids = rng.integers(-1, S + 1, size=(B, E)).astype(np.int32)
    return vals.astype(dtype), ids


def _pallas(vals, ids, S, **kw):
    return np.asarray(edge_segment_max_pallas(vals, ids, S, interpret=True, **kw))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 90), st.integers(1, 40),
       st.integers(0, 2 ** 31 - 1))
def test_plain_version_bit_identical_to_pallas(B, E, S, seed):
    """-inf entries, out-of-range ids and empty segments included."""
    vals, ids = _inputs(np.random.default_rng(seed), B, E, S)
    want = _pallas(vals, ids, S, block=32, n_block=16)
    got = edge_segment_max(torch.from_numpy(vals), torch.from_numpy(ids), S)
    assert got.dtype == torch.float32 and got.shape == (B, S)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dtypes_match_pallas(dtype):
    np_dt, t_dt = DTYPES[dtype]
    vals, ids = _inputs(np.random.default_rng(7), 3, 261, 87, np_dt)
    want = _pallas(jnp.asarray(vals), ids, 87).astype(np.float32)
    t_vals = torch.from_numpy(vals.astype(np.float32)).to(t_dt)
    got = edge_segment_max(t_vals, torch.from_numpy(ids), 87)
    assert got.dtype == t_dt
    np.testing.assert_array_equal(got.float().numpy(), want)  # exact in float32


def test_all_segments_empty_is_all_neg_inf():
    vals = torch.full((2, 8), float("-inf"))
    out = edge_segment_max(vals, torch.full((2, 8), -1, dtype=torch.int32), 5)
    assert out.shape == (2, 5) and bool(torch.isneginf(out).all())
    out = edge_segment_max(torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32), 5)
    assert out[:, 0].tolist() == [1.0, 1.0] and bool(torch.isneginf(out[:, 1:]).all())


def test_int_dtype_rejected():
    with pytest.raises(TypeError):
        edge_segment_max(torch.ones((1, 4), dtype=torch.int32),
                         torch.zeros((1, 4), dtype=torch.int32), 3)
    with pytest.raises(TypeError):
        edge_segment_max_ref(torch.ones((1, 4), dtype=torch.int64),
                             torch.zeros((1, 4), dtype=torch.int32), 3)


def test_nan_propagates_and_signed_zeros_keep_their_value():
    vals = torch.tensor([[1.0, float("nan"), 2.0, -0.0, 0.0, -0.0]])
    ids = torch.tensor([[0, 0, 1, 2, 2, 3]], dtype=torch.int32)
    out = edge_segment_max(vals, ids, 4)
    assert bool(torch.isnan(out[0, 0])) and out[0, 1] == 2.0
    assert out[0, 2] == 0.0 and out[0, 3] == 0.0  # -0.0 == 0.0: either sign may come back
    assert bool(torch.signbit(out[0, 3]))


def test_cpu_dispatch_counts_no_launch_and_refusals():
    vals, ids = _inputs(np.random.default_rng(1), 2, 50, 9)
    before = LAUNCHES["segment_max"]
    edge_segment_max(torch.from_numpy(vals), torch.from_numpy(ids), 9)
    assert LAUNCHES["segment_max"] == before  # the count moves only on kernel launches
    with pytest.raises(ValueError, match="CUDA"):
        edge_segment_max_cuda(torch.from_numpy(vals), torch.from_numpy(ids), 9)
    with pytest.raises(ValueError, match="no kernel"):
        edge_segment_max(torch.empty(2, 8, device="meta"), torch.zeros(2, 8), 3)


def test_dispatch_policy():
    """auto: the kernel on the card; on the CPU padded when the caller can
    bound the in-degree, scatter otherwise.  Explicit names pass."""
    assert select_segment_max_impl("auto") == "scatter"
    assert select_segment_max_impl("auto", padded=True) == "padded"
    cuda = torch.device("cuda")
    assert select_segment_max_impl("auto", device=cuda) == "cuda"
    assert select_segment_max_impl("auto", padded=True, device=cuda) == "cuda"
    for name in ("scatter", "padded", "cuda"):
        assert select_segment_max_impl(name) == name
        assert select_segment_max_impl(name, padded=True, device=cuda) == name
    with pytest.raises(ValueError):
        select_segment_max_impl("xla")


def _random_edge_batch(rng, B, n, deg):
    """Strongly cyclic sparse batch with in-degree <= deg + 1 (ring +
    chords + self-loops), f32 weights (as tests/test_segment_max_kernel.py)."""
    E = n * (deg + 1)
    src = np.empty((B, E), dtype=np.int32)
    dst = np.empty((B, E), dtype=np.int32)
    w = np.empty((B, E), dtype=np.float32)
    idx = np.arange(n, dtype=np.int32)
    for b in range(B):
        cols = [(idx, np.roll(idx, -1))]
        for off in rng.choice(np.arange(2, n - 1), size=deg - 1, replace=False):
            cols.append((idx, (idx + off) % n))
        cols.append((idx, idx))
        src[b] = np.concatenate([s for (s, _) in cols])
        dst[b] = np.concatenate([d for (_, d) in cols])
        w[b] = rng.uniform(0.5, 20.0, E).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("kernel,kw", [
    ("scatter", {}),
    ("padded", {"max_in_degree": 6}),
    ("cuda", {}),
    ("auto", {"max_in_degree": 6}),
])
@pytest.mark.parametrize("seed", [3, 11])
def test_karp_twin_bit_identical_to_jax(kernel, kw, seed):
    rng = np.random.default_rng(seed)
    src, dst, w = _random_edge_batch(rng, B=3, n=24, deg=4)
    w[0, rng.random(w.shape[1]) < 0.2] = -np.inf  # padded arcs in one graph
    ref = np.asarray(batched_cycle_time_sparse_jax(src, dst, w, 24, kernel="xla"))
    got = batched_cycle_time_sparse_torch(torch.from_numpy(src), torch.from_numpy(dst),
                                          torch.from_numpy(w), 24, kernel=kernel, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    host = batched_cycle_time_sparse(EdgeBatch(src, dst, w.astype(np.float64), 24))
    np.testing.assert_allclose(got.numpy().astype(np.float64), host, rtol=1e-5)


def test_karp_twin_float64_matches_host_engine():
    src, dst, w = _random_edge_batch(np.random.default_rng(5), B=4, n=17, deg=3)
    w64 = w.astype(np.float64)
    host = batched_cycle_time_sparse(EdgeBatch(src, dst, w64, 17))
    for kernel in ("scatter", "padded"):
        got = batched_cycle_time_sparse_torch(torch.from_numpy(src), torch.from_numpy(dst),
                                              torch.from_numpy(w64), 17, kernel=kernel,
                                              max_in_degree=5)
        np.testing.assert_allclose(got.numpy(), host, rtol=1e-12)


def test_karp_twin_acyclic_is_neg_inf_and_padded_needs_bound():
    src = torch.tensor([[0, 1, 2]])
    dst = torch.tensor([[1, 2, 3]])
    w = torch.tensor([[1.0, 2.0, 3.0]])
    out = batched_cycle_time_sparse_torch(src, dst, w, 4)
    assert bool(torch.isneginf(out).all())
    with pytest.raises(ValueError, match="max_in_degree"):
        batched_cycle_time_sparse_torch(src, dst, w, 4, kernel="padded")


def test_padded_layout_drops_absent_arcs_before_ranking():
    """-inf (absent) arcs must not consume degree-table slots and evict
    real arcs sharing the destination."""
    src = np.array([[1, 2, 3, 1, 2, 0, 1, 2, 3]], dtype=np.int32)
    dst = np.array([[0, 0, 0, 0, 0, 1, 2, 3, 1]], dtype=np.int32)
    w = np.array([[-np.inf, -np.inf, -np.inf, 3.0, 4.0, 1.0, 1.0, 1.0, 1.0]], dtype=np.float32)
    ref = np.asarray(batched_cycle_time_sparse_jax(src, dst, w, 4, kernel="xla"))
    got = batched_cycle_time_sparse_torch(torch.from_numpy(src), torch.from_numpy(dst),
                                          torch.from_numpy(w), 4, kernel="padded",
                                          max_in_degree=2)
    np.testing.assert_array_equal(got.numpy(), ref)
