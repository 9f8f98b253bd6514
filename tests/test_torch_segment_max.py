"""The port's segment max (K1) and its Karp twin against the JAX package.

The plain version -- the CPU path of ``edge_segment_max`` and what the
CUDA kernel is held against on the card -- matches the Pallas kernel it
replaces (run in interpret mode) bit for bit: max is exact and
order-free.  The device Karp twin matches ``batched_cycle_time_sparse_jax``
bit for bit in float32 under every segment-max implementation, and the
host engine to rtol 1e-5.  The standalone kernel's layout rule
(``segment_max_plan``) is checked here, and a numpy emulation of its key
fold under every layout is held to the plain version."""

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
from repro_torch.kernels.segment_max import (  # noqa: E402
    SEGMENT_MAX_CLUSTERS,
    SEGMENT_MAX_MIN_WORK_PER_CTA,
    edge_segment_max_cuda,
    edge_segment_max_ref,
    segment_max_layouts,
    segment_max_plan,
)

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


# --- the standalone kernel's layout (segment_max_plan) and its key fold ---

H100_SMS, H100_SMEM = 132, 232448


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 300), st.integers(0, 40000), st.integers(0, 80000),
       st.sampled_from([2, 4, 8]))
def test_segment_max_plan_covers_every_edge_once_within_the_card(B, E, S, elem):
    plan = segment_max_plan(B, E, S, elem, num_sms=H100_SMS, smem_cap=H100_SMEM)
    cs, per = plan.cluster, plan.edges_per_cta
    assert cs in (1,) + SEGMENT_MAX_CLUSTERS
    assert B * cs <= H100_SMS or cs == 1
    assert per % 4 == 0
    # CTA r folds [r * per, min((r + 1) * per, E)): every edge exactly once
    hits = np.zeros(E, dtype=np.int64)
    for r in range(cs):
        hits[min(r * per, E):min((r + 1) * per, E)] += 1
    assert (hits == 1).all()
    key = 8 if elem == 8 else 4
    if S <= E and S * key <= H100_SMEM:
        assert plan.segments == "shared" and plan.smem_bytes == S * key <= H100_SMEM
    else:  # more segments than edges, or past the card's shared memory
        assert plan.segments == "global" and plan.smem_bytes == 0
    if cs > 1:
        work = E + S if plan.segments == "global" else E
        assert -(-work // cs) >= SEGMENT_MAX_MIN_WORK_PER_CTA


@pytest.mark.parametrize("B,E,S,elem,want", [
    (8, 8192, 1024, 4, (8, 1024, "shared")),      # the scoring shape: 64 CTAs
    (16, 261, 87, 4, (1, 264, "shared")),         # the Ebone climb shape: one CTA a row
    (8, 8192, 1024, 8, (8, 1024, "shared")),
    (2, 5000, 20000, 4, (8, 628, "global")),      # 4x more segments than edges
    (2, 5000, 20000, 8, (8, 628, "global")),
    (2, 60000, 58112, 4, (8, 7500, "shared")),    # exactly the card's grant
    (2, 60000, 58113, 4, (8, 7500, "global")),    # one key past it
    (2, 60000, 29056, 8, (8, 7500, "shared")),
    (2, 60000, 29057, 8, (8, 7500, "global")),
    (20, 8192, 1024, 4, (4, 2048, "shared")),     # 8 CTAs a row would pass one wave
    (40, 8192, 1024, 4, (2, 4096, "shared")),
    (67, 8192, 1024, 4, (1, 8192, "shared")),     # B past half the SMs
    (200, 8192, 1024, 4, (1, 8192, "shared")),    # B past the SM count
    (4, 1022, 9, 4, (1, 1024, "shared")),         # two CTAs would keep 511 edges each
    (4, 1023, 9, 4, (2, 512, "shared")),          # 512 and 511
    (4, 1100, 1100, 4, (2, 552, "shared")),       # S == E stays in shared memory
    (4, 1100, 1101, 4, (4, 276, "global")),       # 2201 edges and segments: 4 CTAs
    (2, 10, 100000, 4, (8, 4, "global")),         # few edges, many segments to set
    (1, 0, 5, 4, (1, 0, "global")),               # E = 0
    (1, 1, 5, 4, (1, 4, "global")),               # E = 1
    (3, 9000, 0, 4, (8, 1128, "shared")),         # S = 0: nothing to hold
    (3, 9000, 1, 4, (8, 1128, "shared")),         # S = 1: every edge collides
])
def test_segment_max_plan_picks_the_cluster_split_and_segments(B, E, S, elem, want):
    plan = segment_max_plan(B, E, S, elem, num_sms=H100_SMS, smem_cap=H100_SMEM)
    assert (plan.cluster, plan.edges_per_cta, plan.segments) == want


@pytest.mark.parametrize("E", [0, 1])
@pytest.mark.parametrize("S", [0, 1])
def test_segment_max_plan_tiny_rows_and_many_rows_take_one_cta(E, S):
    for B in (1, 8, H100_SMS // 2 + 1, H100_SMS + 1, 10 * H100_SMS):
        assert segment_max_plan(B, E, S, 4, num_sms=H100_SMS, smem_cap=H100_SMEM).cluster == 1
    assert segment_max_plan(H100_SMS + 1, 10 ** 6, S, 4, num_sms=H100_SMS,
                            smem_cap=H100_SMEM).cluster == 1


@pytest.mark.parametrize("B,E,S,elem,n_layouts", [
    (8, 8192, 1024, 4, 8), (16, 261, 87, 8, 8), (2, 5000, 20000, 4, 8),
    (2, 60000, 58112, 4, 8), (1, 60000, 58113, 4, 4), (2, 60000, 29057, 8, 4), (1, 0, 5, 2, 8),
])
def test_segment_max_layouts_hold_the_planned_one(B, E, S, elem, n_layouts):
    """Every layout at a shape: 1, 2, 4, 8 CTAs a row, each split covering
    the row, shared memory only where the S keys fit the card; the plan's
    pick is one of them."""
    layouts = segment_max_layouts(E, S, elem, H100_SMEM)
    assert len(layouts) == len(set(layouts)) == n_layouts
    assert {p.cluster for p in layouts} == {1, 2, 4, 8}
    for p in layouts:
        assert p.edges_per_cta * p.cluster >= E and p.edges_per_cta % 4 == 0
        assert p.smem_bytes <= H100_SMEM and (p.smem_bytes > 0) == (p.segments == "shared" and S > 0)
    plan = segment_max_plan(B, E, S, elem, num_sms=H100_SMS, smem_cap=H100_SMEM)
    assert plan in layouts


# The kernel's keys, written out as csrc/segment_max.cu computes them: float32
# and float64 by their bits (NaN made the canonical quiet NaN first), the
# 16-bit types by their own 16 bits; the -inf keys are the kernel's constants.
_KEYS = {
    torch.float32: (np.uint32, np.uint32(0x80000000), 0x7FC00000, 0x7F800000, 0x007FFFFF),
    torch.float64: (np.uint64, np.uint64(0x8000000000000000), 0x7FF8000000000000,
                    0x7FF0000000000000, 0x000FFFFFFFFFFFFF),
    torch.float16: (np.uint16, np.uint16(0x8000), 0x7E00, 0x7C00, 0x03FF),
    torch.bfloat16: (np.uint16, np.uint16(0x8000), 0x7FC0, 0x7F80, 0x007F),
}
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _encode(vals: torch.Tensor) -> np.ndarray:
    ut, sign, qnan, inf, _ = _KEYS[vals.dtype]
    b = vals.view(_INT_VIEW[vals.dtype]).numpy().view(ut).copy()
    b[(b & ~sign) > ut(inf)] = ut(qnan)
    return np.where(b & sign, ~b, b | sign).astype(ut)


def _decode(keys: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    ut, sign = _KEYS[dtype][:2]
    b = np.where(keys & sign, keys & ~sign, ~keys).astype(ut)
    return torch.from_numpy(b.view(np.dtype(b.dtype.str.replace("u", "i")))).view(dtype)


def _emulate(vals: torch.Tensor, ids: torch.Tensor, S: int, cluster: int, per: int,
             where: str) -> torch.Tensor:
    """The kernel's fold under a layout: CTA r of a row folds its slice into
    its own keys (``"shared"``) or into the row's one set (``"global"``);
    the shared copies are then reduced segment by segment."""
    ut, kneg = _KEYS[vals.dtype][0], _KEYS[vals.dtype][4]
    keys, ids = _encode(vals), ids.numpy().astype(np.int64)
    B, E = ids.shape
    out = np.empty((B, S), dtype=ut)
    for b in range(B):
        copies = []
        row = np.full(S, kneg, dtype=ut)
        for r in range(cluster):
            lo, hi = min(r * per, E), min((r + 1) * per, E)
            mine = np.full(S, kneg, dtype=ut) if where == "shared" else row
            take = (ids[b, lo:hi] >= 0) & (ids[b, lo:hi] < S)
            np.maximum.at(mine, ids[b, lo:hi][take], keys[b, lo:hi][take])
            copies.append(mine)
        out[b] = np.max(copies, axis=0) if where == "shared" else row
    return _decode(out, vals.dtype)


def _same(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Equal values, NaN where the plain version has NaN (a signed zero
    compares equal to its opposite)."""
    got, ref = got.double(), ref.double()
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)) and bool((got[~nan] == ref[~nan]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,E,S", [(3, 7, 5), (2, 2100, 1), (2, 2100, 87), (1, 1500, 3000)])
def test_kernel_key_fold_equals_plain_under_every_layout(B, E, S, dtype):
    rng = np.random.default_rng(B * E + S)
    vals, ids = _inputs(rng, B, E, S)
    vals[0, :4] = [np.nan, -0.0, 0.0, np.inf]
    vals[-1, -3:] = [-0.0, -np.inf, np.nan]
    t_vals = torch.from_numpy(vals).to(dtype)
    t_ids = torch.from_numpy(ids)
    ref = edge_segment_max_ref(t_vals, t_ids, S)
    layouts = segment_max_layouts(E, S, t_vals.element_size(), H100_SMEM)
    assert len(layouts) == 8
    for plan in layouts:
        got = _emulate(t_vals, t_ids, S, plan.cluster, plan.edges_per_cta, plan.segments)
        assert got.dtype == dtype and _same(got, ref), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
def test_kernel_keys_order_like_the_values(dtype):
    """key(a) < key(b) iff a < b, -0.0 just below +0.0, NaN above +inf,
    and the -inf key is the kernel's constant."""
    ut, _, _, _, kneg = _KEYS[dtype]
    x = torch.tensor([-np.inf, -3.5, -1.0, -0.0, 0.0, 1e-3, 2.0, np.inf, np.nan],
                     dtype=torch.float64).to(dtype)
    k = _encode(x)
    assert (np.diff(k.astype(np.uint64)) > 0).all()
    assert k[0] == ut(kneg)
    assert torch.equal(_decode(k[:-1], dtype).view(_INT_VIEW[dtype]),
                       x[:-1].view(_INT_VIEW[dtype]))
