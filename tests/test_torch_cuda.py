"""The hand-written CUDA kernels on the card, against their plain
versions.  This file imports no JAX so it also runs where only PyTorch
is installed; run it on a machine with an NVIDIA Hopper GPU with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Without a card the tests skip."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    LAUNCHES,
    edge_segment_max,
    flash_attention,
    gossip_mix,
    mlstm_scan,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_ref,
)
from repro_torch.kernels.gossip_mix import (  # noqa: E402
    gossip_mix_cuda,
    gossip_mix_ref,
)
from repro_torch.kernels.mlstm_scan import (  # noqa: E402
    mlstm_chunked_ref,
    mlstm_scan_cuda,
    scratch_shapes,
)
from repro_torch.kernels.segment_max import edge_segment_max_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(1, 1), (1, 1003), (2, 4096), (3, 1001), (5, 65539)])
def test_gossip_mix_kernel_matches_plain(cuda, K, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(K * N)
    blocks = torch.randn((K, N), generator=gen, device=cuda).to(dtype)
    w = torch.softmax(torch.randn(K, generator=gen, device=cuda), 0)
    before = LAUNCHES["gossip_mix"]
    got = gossip_mix(blocks, w)
    torch.cuda.synchronize()
    assert LAUNCHES["gossip_mix"] == before + 1
    expect = gossip_mix_ref(blocks, w)
    torch.testing.assert_close(got.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_gossip_mix_kernel_preserves_constants(cuda):
    K, N = 4, 5000
    blocks = torch.arange(N, dtype=torch.float32, device=cuda).expand(K, N).contiguous()
    out = gossip_mix(blocks, torch.full((K,), 0.25, device=cuda))
    np.testing.assert_allclose(out.cpu().numpy(), np.arange(N), rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("N,offset", [(1, 0), (7, 0), (4096, 0), (65539, 0), (1 << 20, 0),
                                      (1 << 20, 1), (4099, 3)])
def test_gossip_mix_streaming_kernel_bit_identical_to_grid_stride(cuda, K, N, offset, dtype):
    """The streaming kernel (K fixed at compile time at 2, a run-time loop otherwise)
    against the earlier grid-stride kernel: the same fmaf order from k = 0,
    so the same bits, for ragged N and rows off 16-byte alignment."""
    gen = torch.Generator(device=cuda).manual_seed(K * N + offset)
    base = torch.randn(K * N + offset, generator=gen, device=cuda).to(dtype)
    blocks = base[offset:].view(K, N)
    w = torch.softmax(torch.randn(K, generator=gen, device=cuda), 0)
    before = dict(LAUNCHES)
    got = gossip_mix_cuda(blocks, w)
    ref = gossip_mix_cuda(blocks, w, grid_stride=True)
    torch.cuda.synchronize()
    assert LAUNCHES == before  # the count is the dispatcher's
    assert torch.equal(got, ref)
    torch.testing.assert_close(got.float(), gossip_mix_ref(blocks, w).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _same(got, ref):
    """Equal values with NaN where the plain version has NaN (a signed
    zero compares equal to its opposite)."""
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)) and bool((got[~nan] == ref[~nan]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,E,S", [(1, 1, 1), (3, 7, 5), (16, 261, 87), (64, 8192, 1024),
                                   (2, 5000, 20000)])
def test_segment_max_kernel_matches_plain(cuda, B, E, S, dtype):
    gen = torch.Generator(device=cuda).manual_seed(B * E + S)
    vals = torch.randn((B, E), generator=gen, device=cuda)
    vals[torch.rand((B, E), generator=gen, device=cuda) < 0.15] = float("-inf")
    vals = vals.to(dtype)
    # ids in [-1, S]: -1 and S are dropped; many segments stay empty
    ids = torch.randint(-1, S + 1, (B, E), generator=gen, device=cuda, dtype=torch.int32)
    before = LAUNCHES["segment_max"]
    got = edge_segment_max(vals, ids, S)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_max"] == before + 1
    assert got.dtype == dtype and got.shape == (B, S)
    assert _same(got.float(), edge_segment_max_ref(vals, ids, S).float())


@pytest.mark.gpu
def test_segment_max_kernel_nan_and_signed_zero(cuda):
    vals = torch.tensor([[1.0, float("nan"), 2.0, -0.0, 0.0, -0.0, float("-inf")]], device=cuda)
    ids = torch.tensor([[0, 0, 1, 2, 2, 3, 4]], dtype=torch.int32, device=cuda)
    got = edge_segment_max(vals, ids, 6).cpu()
    assert bool(torch.isnan(got[0, 0])) and got[0, 1] == 2.0
    assert got[0, 2] == 0.0 and got[0, 3] == 0.0 and bool(torch.signbit(got[0, 3]))
    assert bool(torch.isneginf(got[0, 4:]).all())


def _segmax_case(gen, dev, B, E, S, dtype, offset=0):
    """Values with -inf, NaN, -0.0 and +0.0 entries and ids in [-1, S] (-1
    and S dropped), ``offset`` elements into their buffers (so off 16-byte
    alignment when it is not a multiple of 4).  The values are drawn in
    float64, so a float64 kernel that kept less precision would differ."""
    vals = torch.randn((B * E + offset,), generator=gen, device=dev, dtype=torch.float64)
    vals[torch.rand(vals.shape, generator=gen, device=dev) < 0.15] = float("-inf")
    vals[torch.rand(vals.shape, generator=gen, device=dev) < 0.01] = -0.0
    vals[torch.rand(vals.shape, generator=gen, device=dev) < 0.01] = 0.0
    vals[torch.rand(vals.shape, generator=gen, device=dev) < 0.002] = float("nan")
    ids = torch.randint(-1, S + 1, (B * E + offset,), generator=gen, device=dev,
                        dtype=torch.int32)
    return vals.to(dtype)[offset:].view(B, E), ids[offset:].view(B, E)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,E,S,offset", [(3, 7, 5, 0), (2, 3001, 1, 0), (16, 261, 87, 1),
                                          (8, 8192, 1024, 0), (2, 5000, 20000, 3),
                                          (1, 4099, 2, 2)])
def test_segment_max_every_layout_bit_for_bit(cuda, B, E, S, offset, dtype):
    """Every layout the plan can take (1, 2, 4, 8 CTAs a row x the maxima in
    shared memory or in the output), forced through the launcher, on
    aligned and misaligned rows: S = 1 (every edge collides), S = 20,000,
    ids -1 and S, NaN and signed zeros."""
    from repro_torch.kernels.segment_max import (_launch_segment_max, _smem_cap,
                                                 segment_max_layouts)

    gen = torch.Generator(device=cuda).manual_seed(B * E + S + offset)
    vals, ids = _segmax_case(gen, cuda, B, E, S, dtype, offset)
    want = edge_segment_max_ref(vals, ids, S)
    layouts = segment_max_layouts(E, S, vals.element_size(), _smem_cap(torch.cuda.current_device()))
    assert len(layouts) == 8
    before = dict(LAUNCHES)
    for plan in layouts:
        got = _launch_segment_max(vals, ids, S, plan)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, S)
        assert _same(got, want), plan
    assert LAUNCHES == before  # the count is the dispatcher's


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,E,S", [(8, 8192, 1024), (2, 5000, 70000), (200, 600, 40),
                                   (4, 0, 3), (4, 1, 1)])
def test_segment_max_planned_layout_counts_one_launch_a_call(cuda, B, E, S, dtype):
    """The wrapper's own layout, the C entry's plan equal to
    segment_max_plan's (more segments than edges, or S = 70,000 keys past
    the card's shared memory in every dtype: the maxima go to the output),
    one launch a call."""
    from repro_torch.kernels.segment_max import _segment_max_plan_in_c, segment_max_plan_on_card

    plan = segment_max_plan_on_card(B, E, S, dtype, cuda)
    assert _segment_max_plan_in_c(B, E, S, dtype, cuda) == (
        plan.cluster, plan.edges_per_cta, int(plan.segments == "global"))
    assert plan.segments == ("global" if S > E else "shared")
    gen = torch.Generator(device=cuda).manual_seed(B + E + S)
    vals, ids = _segmax_case(gen, cuda, B, E, S, dtype)
    before = LAUNCHES["segment_max"]
    got = edge_segment_max(vals, ids, S)
    got2 = edge_segment_max(vals, ids, S)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_max"] == before + 2
    want = edge_segment_max_ref(vals, ids, S)
    assert _same(got, want) and _same(got2, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
def test_segment_max_keys_past_shared_memory_with_fewer_segments_than_edges(cuda, dtype):
    """S <= E but S keys one past the card's shared memory: the plan puts
    the maxima in the output for the grant alone, and the wrapper's launch
    equals plain."""
    from repro_torch.kernels.segment_max import (_segment_max_plan_in_c, _smem_cap,
                                                 segment_max_plan_on_card)

    S = _smem_cap(torch.cuda.current_device()) // 4 + 1
    E = S + 1887
    plan = segment_max_plan_on_card(1, E, S, dtype, cuda)
    assert plan.segments == "global" and S <= E
    assert _segment_max_plan_in_c(1, E, S, dtype, cuda) == (plan.cluster, plan.edges_per_cta, 1)
    gen = torch.Generator(device=cuda).manual_seed(S)
    vals, ids = _segmax_case(gen, cuda, 1, E, S, dtype)
    before = LAUNCHES["segment_max"]
    got = edge_segment_max(vals, ids, S)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_max"] == before + 1
    assert got.dtype == dtype and _same(got, edge_segment_max_ref(vals, ids, S))


@pytest.mark.gpu
def test_segment_max_refused_layouts_raise(cuda):
    """A layout the card cannot take raises and launches nothing: a cluster
    size the kernel does not take, a split that leaves edges out, keys past
    the card's shared memory.  Nothing falls back to another layout."""
    from repro_torch.kernels.segment_max import SegmentMaxPlan, _launch_segment_max, _smem_cap

    cap = _smem_cap(torch.cuda.current_device())
    gen = torch.Generator(device=cuda).manual_seed(4000)
    vals = torch.randn((2, 4000), generator=gen, device=cuda)
    ids = torch.randint(0, 5, (2, 4000), generator=gen, device=cuda, dtype=torch.int32)
    big = cap // 4 + 1
    before = dict(LAUNCHES)
    for S, plan in ((5, SegmentMaxPlan(16, 252, "shared", 20)),
                    (5, SegmentMaxPlan(3, 1336, "shared", 20)),
                    (5, SegmentMaxPlan(2, 1996, "shared", 20)),
                    (big, SegmentMaxPlan(1, 4000, "shared", big * 4))):
        with pytest.raises(RuntimeError, match="segment_max kernel launch failed"):
            _launch_segment_max(vals, ids, S, plan)
    torch.cuda.synchronize()
    assert LAUNCHES == before
    got = _launch_segment_max(vals, ids, big, SegmentMaxPlan(1, 4000, "global", 0))
    assert _same(got, edge_segment_max_ref(vals, ids, big))


@pytest.mark.gpu
def test_segment_max_misaligned_view_and_int64_ids(cuda):
    """Rows viewed at a storage offset (off 16-byte alignment: one edge a
    lane) and int64 ids through the public wrapper: converted, launched
    once, equal to plain."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    vals, ids = _segmax_case(gen, cuda, 5, 2001, 300, torch.float32, 1)
    before = LAUNCHES["segment_max"]
    got = edge_segment_max(vals, ids.long(), 300)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_max"] == before + 1
    assert _same(got, edge_segment_max_ref(vals, ids, 300))


@pytest.mark.gpu
def test_karp_twin_on_card_bit_identical_to_cpu(cuda):
    from repro_torch.core.maxplus_sparse import batched_cycle_time_sparse_torch

    rng = np.random.default_rng(0)
    B, n, E = 8, 40, 160
    src = rng.integers(0, n, (B, E))
    dst = np.concatenate([np.arange(n)[None].repeat(B, 0), rng.integers(0, n, (B, E - n))], 1)
    w = rng.uniform(0.5, 20.0, (B, E)).astype(np.float32)
    w[rng.random((B, E)) < 0.2] = -np.inf
    args = [torch.from_numpy(a) for a in (src, dst, w)]
    cpu = batched_cycle_time_sparse_torch(*args, n, kernel="scatter")
    before = dict(LAUNCHES)
    card = batched_cycle_time_sparse_torch(*[a.to(cuda) for a in args], n)
    assert LAUNCHES["karp"] == before["karp"] + 1  # all n levels in one launch
    assert LAUNCHES["segment_max"] == before["segment_max"]
    assert torch.equal(card.cpu(), cpu)


def _karp_inputs(gen, dev, B, N, E, dtype):
    """Arc lists with a self-loop per node, -inf arcs, row 0 acyclic (a
    path) and, where N > 2, node N - 1 unreachable in every row."""
    src = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    k = min(N, E)
    src[:, :k] = torch.arange(k, dtype=torch.int32, device=dev)
    dst[:, :k] = src[:, :k]
    w = torch.rand((B, E), generator=gen, device=dev) * 19.5 + 0.5
    w[torch.rand((B, E), generator=gen, device=dev) < 0.2] = float("-inf")
    if N > 2:
        w[(src == N - 1) | (dst == N - 1)] = float("-inf")
    w[0] = float("-inf")
    if N > 1:
        m = min(N - 1, E)
        src[0, :m] = torch.arange(m, dtype=torch.int32, device=dev)
        dst[0, :m] = src[0, :m] + 1
        w[0, :m] = 1.0
    return src, dst, w.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,N,E", [(1, 1, 1), (3, 5, 15), (16, 87, 261), (4, 383, 1149),
                                   (2, 1024, 8192), (2, 300, 20000)])
def test_karp_kernel_matches_plain_bit_for_bit(cuda, B, N, E, dtype):
    from repro_torch.kernels import karp_cycle_time
    from repro_torch.kernels.segment_max import karp_cycle_time_ref

    gen = torch.Generator(device=cuda).manual_seed(B * N + E)
    src, dst, w = _karp_inputs(gen, cuda, B, N, E, dtype)
    before = LAUNCHES["karp"]
    got = karp_cycle_time(src, dst, w, N)
    torch.cuda.synchronize()
    assert LAUNCHES["karp"] == before + 1
    assert got.dtype == dtype and got.shape == (B,)
    assert torch.equal(got, karp_cycle_time_ref(src, dst, w, N))
    if N > 1:
        assert bool(torch.isneginf(got[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,S", [(1, 1, 2), (3, 5, 10), (16, 87, 174), (4, 383, 766),
                                   (2, 1024, 8192), (2, 300, 30000)])
def test_reach_kernel_matches_plain(cuda, B, N, S):
    from repro_torch.kernels import reach_from_zero
    from repro_torch.kernels.segment_max import reach_from_zero_ref

    gen = torch.Generator(device=cuda).manual_seed(B * N + S)
    src = torch.randint(0, N, (B, S), generator=gen, device=cuda)
    dst = torch.randint(0, N, (B, S), generator=gen, device=cuda)
    present = (torch.rand((B, S), generator=gen, device=cuda) < 0.6) & (src != dst)
    present[:, : S // 2] &= (src[:, : S // 2] < N // 2) & (dst[:, : S // 2] < N // 2)
    before = LAUNCHES["reach"]
    got = reach_from_zero(src, dst, present, N)
    torch.cuda.synchronize()
    assert LAUNCHES["reach"] == before + 1
    assert got.dtype == torch.bool and got.shape == (2, B, N)
    assert torch.equal(got, reach_from_zero_ref(src, dst, present, N))


def _reach_graph(gen, dev, kind, B, N, E):
    """``[B, E]`` arcs of one kind: ``random`` or ``empty`` (E = 0; the
    first half among the first N // 2 nodes, a share absent), ``path`` 0 -> 1 -> .. -> N-1 with
    its arcs listed in order or (``reversed_path``) in reverse, ``ring``,
    ``star`` (0 -> i, and i -> 0 for even i), ``padded`` (row b lives on
    its first m_b nodes, the rest absent: a multi-universe pack)."""
    src = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    present = (torch.rand((B, E), generator=gen, device=dev) < 0.6) & (src != dst)
    if kind in ("random", "empty"):
        h = E // 2
        present[:, :h] &= (src[:, :h] < N // 2) & (dst[:, :h] < N // 2)
    elif kind == "padded":
        m = torch.randint(1, N + 1, (B, 1), generator=gen, device=dev)
        m[0] = N
        present &= (src < m) & (dst < m)
    else:
        i = torch.arange(E, device=dev, dtype=torch.int32)
        if kind in ("path", "reversed_path"):  # E = N - 1
            a = i if kind == "path" else (E - 1) - i
            s, d = a, a + 1
        elif kind == "ring":  # E = N
            s, d = i, (i + 1) % N
        else:  # star, E = N - 1 + (N - 1) // 2
            leaves = torch.arange(1, N, device=dev, dtype=torch.int32)
            back = leaves[leaves % 2 == 0]
            s = torch.cat([torch.zeros_like(leaves), back])
            d = torch.cat([leaves, torch.zeros_like(back)])
        src, dst = s.expand(B, E).contiguous(), d.expand(B, E).contiguous()
        present = torch.ones((B, E), dtype=torch.bool, device=dev)
        present[1:, ::7] = False  # the rows past the first lose every seventh arc
    return src, dst, present


def _reach_arcs(kind, N):
    return {"path": N - 1, "reversed_path": N - 1, "ring": N,
            "star": N - 1 + (N - 1) // 2}.get(kind, 3 * N)


REACH_CASES = ([(kind, N) for kind in ("random", "path", "reversed_path", "ring", "star",
                                       "padded")
                for N in (1, 31, 32, 33, 87, 1023, 1024) if N > 1 or kind == "random"]
               + [("empty", 87), ("empty", 1024)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,N", REACH_CASES)
def test_reach_every_layout_bit_for_bit(cuda, kind, N):
    """Every layout reachability can take (the bitsets at one and two
    traversals a CTA, the hops over staged arcs, the hops over arcs in
    global memory),
    forced through the launcher, on paths listed forward and in reverse,
    rings, stars, E = 0 and padded multi-universe rows: equal to plain."""
    from repro_torch.kernels.segment_max import (_launch_reach, _smem_cap, reach_from_zero_ref,
                                                 reach_layouts)

    B = 5
    E = 0 if kind == "empty" else _reach_arcs(kind, N)
    gen = torch.Generator(device=cuda).manual_seed(N * 7 + len(kind))
    src, dst, present = _reach_graph(gen, cuda, kind, B, N, E)
    want = reach_from_zero_ref(src, dst, present, N)
    layouts = reach_layouts(E, N, _smem_cap(torch.cuda.current_device()))
    assert [p.layout for p in layouts].count("bitset") >= 1
    before = dict(LAUNCHES)
    for plan in layouts:
        got = _launch_reach(src, dst, present, N, plan)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and got.shape == (2, B, N)
        assert torch.equal(got, want), plan
    assert LAUNCHES == before  # the count is the dispatcher's
    if kind in ("path", "reversed_path", "ring", "star"):
        assert bool(want[0, 0].all())  # row 0 keeps every arc


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,E,layout", [(16, 87, 261, "bitset"), (8, 1024, 8192, "bitset"),
                                          (200, 87, 600, "bitset"), (64, 1024, 8192, "bitset"),
                                          (3, 1025, 4000, "hop"), (2, 2048, 6000, "hop"),
                                          (2, 1025, 40000, "hop_global"),
                                          (2, 300, 60000, "bitset"), (4, 5, 0, "bitset"),
                                          (1, 87, 261, "bitset"), (7, 33, 99, "bitset")])
def test_reach_planned_layout_counts_one_launch_a_call(cuda, B, N, E, layout):
    """The wrapper's own layout, the C entry's plan equal to reach_plan's,
    one launch a call, equal to plain; past 1024 nodes the hop kernel, its
    arcs staged or, past shared memory, read in place."""
    from repro_torch.kernels import reach_from_zero
    from repro_torch.kernels.segment_max import (_reach_plan_in_c, reach_from_zero_ref,
                                                 reach_plan_on_card)

    plan = reach_plan_on_card(E, N, cuda)
    assert plan.layout == layout
    assert _reach_plan_in_c(E, N, cuda) == plan
    gen = torch.Generator(device=cuda).manual_seed(B + N + E)
    src, dst, present = _reach_graph(gen, cuda, "random", B, N, E)
    before = LAUNCHES["reach"]
    got = reach_from_zero(src, dst, present, N)
    got2 = reach_from_zero(src.long(), dst.long(), present, N)
    torch.cuda.synchronize()
    assert LAUNCHES["reach"] == before + (2 if B else 0)
    want = reach_from_zero_ref(src, dst, present, N)
    assert torch.equal(got, want) and torch.equal(got2, want)


@pytest.mark.gpu
def test_reach_other_layout_with_arcs_past_shared_memory(cuda):
    """E = 60,000 at N = 300: the plan takes the bitsets (arcs are not
    staged); the hop kernel, forced, reads the arcs in place, and both
    equal plain."""
    from repro_torch.kernels.segment_max import (ReachPlan, _launch_reach, reach_from_zero_ref,
                                                 reach_plan_on_card)

    gen = torch.Generator(device=cuda).manual_seed(60000)
    src, dst, present = _reach_graph(gen, cuda, "padded", 3, 300, 60000)
    want = reach_from_zero_ref(src, dst, present, 300)
    assert reach_plan_on_card(60000, 300, cuda).layout == "bitset"
    for plan in (ReachPlan("hop_global", 1, 300), reach_plan_on_card(60000, 300, cuda)):
        assert torch.equal(_launch_reach(src, dst, present, 300, plan), want), plan


@pytest.mark.gpu
def test_reach_plan_equals_the_c_plan(cuda):
    from repro_torch.kernels.segment_max import _reach_plan_in_c, reach_plan_on_card

    for N in (1, 11, 87, 383, 1023, 1024, 1025, 2048, 100000):
        for E in (0, 261, 8192, 29000, 60000):
            assert _reach_plan_in_c(E, N, cuda) == reach_plan_on_card(E, N, cuda)


@pytest.mark.gpu
def test_reach_refused_layouts_raise(cuda):
    """A layout the card cannot take raises and launches nothing: bitsets
    past 1024 nodes or past shared memory, rows other than 1 or 2 for the
    bitsets or 1 for the hops, staged arcs past shared memory.  Nothing
    falls back."""
    from repro_torch.kernels.segment_max import (ReachPlan, _launch_reach, _smem_cap,
                                                 reach_from_zero_ref)

    cap = _smem_cap(torch.cuda.current_device())
    gen = torch.Generator(device=cuda).manual_seed(5)
    cases = [(2048, 100, ReachPlan("bitset", 1, 0)), (1024, 100, ReachPlan("bitset", 2, 0)),
             (87, 100, ReachPlan("bitset", 0, 0)), (87, 100, ReachPlan("bitset", 4, 0)),
             (87, cap // 8, ReachPlan("hop", 1, 0)), (87, 100, ReachPlan("hop", 2, 0))]
    before = dict(LAUNCHES)
    for N, E, plan in cases:
        src, dst, present = _reach_graph(gen, cuda, "random", 2, N, E)
        with pytest.raises(RuntimeError, match="reach kernel launch failed"):
            _launch_reach(src, dst, present, N, plan)
    torch.cuda.synchronize()
    assert LAUNCHES == before
    src, dst, present = _reach_graph(gen, cuda, "random", 2, 87, 100)
    assert torch.equal(_launch_reach(src, dst, present, 87, ReachPlan("bitset", 2, 0)),
                       reach_from_zero_ref(src, dst, present, 87))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bitset", "hop", "hop_global"])
def test_reach_out_of_range_ids_give_a_cuda_error(cuda, layout):
    """Every layout stops at an id outside [0, N), on an absent arc too;
    the fault kills the CUDA context, so it is provoked in a subprocess."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from repro_torch.kernels.segment_max import ReachPlan, _launch_reach\n"
        "d = torch.device('cuda')\n"
        "src = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=d)\n"
        "dst = torch.tensor([[1, 2, 5]], dtype=torch.int32, device=d)\n"
        "present = torch.tensor([[True, True, False]], device=d)\n"
        f"_launch_reach(src, dst, present, 3, ReachPlan({layout!r}, 1, 0))\n"
        "torch.cuda.synchronize()\n"
    )
    src_dir = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src_dir))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr


@pytest.mark.gpu
def test_climb_launches_one_kernel_per_karp_level(cuda):
    """Now one persistent Karp launch and one reachability launch per
    scored step (the seeds' score and n_steps proposals)."""
    import repro_torch.core as P

    gc = P.make_underlay("gaia").connectivity_graph(comp_time_ms=25.4)
    tp = P.TrainingParams(model_size_mbits=42.88, local_steps=1)
    before = dict(LAUNCHES)
    ov = P.search_overlays_jit(gc, tp, n_restarts=4, n_steps=5, device=cuda)
    assert LAUNCHES["karp"] - before["karp"] == 5 + 1
    assert LAUNCHES["reach"] - before["reach"] == 5 + 1
    assert LAUNCHES["segment_max"] == before["segment_max"]
    assert ov.cycle_time_ms <= P.ring_overlay(gc, tp).cycle_time_ms


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K,G,hd,window", [
    (1, 128, 1, 1, 32, None), (2, 256, 2, 2, 64, None), (1, 256, 4, 1, 128, 64),
    (2, 128, 1, 4, 32, 32), (1, 1024, 2, 4, 80, 100), (2, 256, 8, 4, 80, 4096),
    (1, 256, 2, 3, 64, 100),   # G = 3: ragged query tiles (21 positions a block)
    (1, 256, 2, 3, 80, 100),   # G = 3 at danube's head_dim
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, K, G, hd, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S * hd + G)
    q = torch.randn((B, S, K, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device=cuda).to(dtype)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    expect = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 0, 64])
def test_flash_attention_kernel_non_causal_and_empty_window(cuda, window):
    """Non-causal attention, and a window of 0 with causal masking (every
    key masked: the reference's weights of 1 over all keys)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 256, 2, 2, 64), generator=gen, device=cuda)
    k = torch.randn((1, 256, 2, 64), generator=gen, device=cuda)
    v = torch.randn((1, 256, 2, 64), generator=gen, device=cuda)
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal, window=window)
        expect = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, expect, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,G,window", [(128, 384, 2, None), (256, 1024, 4, 300)])
def test_flash_attention_kernel_more_keys_than_queries_hd128(cuda, S, T, G, window, dtype):
    """hd 128 (32-key tiles) with T > S: queries at 0..S-1 against keys at
    0..T-1, as the reference defines them."""
    gen = torch.Generator(device=cuda).manual_seed(S + T)
    q = torch.randn((2, S, 2, G, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, T, 2, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, T, 2, 128), generator=gen, device=cuda).to(dtype)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal, window=window)
        expect = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K,G,hd,window", [
    (1, 256, 2, 1, 32, None), (2, 512, 2, 4, 80, 100), (1, 512, 2, 2, 128, None),
    (1, 256, 1, 3, 64, 64),
])
def test_flash_attention_tensor_cores_match_cuda_core_entry(cuda, B, S, K, G, hd, window,
                                                            dtype):
    """The tensor-core kernel against the CUDA-core kernel kept in the same
    source, within the reference's tolerance; neither counts a launch (the
    count is the dispatcher's)."""
    gen = torch.Generator(device=cuda).manual_seed(hd + G)
    q = torch.randn((B, S, K, G, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device=cuda).to(dtype)
    before = LAUNCHES["flash_attention"]
    tc = flash_attention_cuda(q, k, v, causal=True, window=window)
    simt = flash_attention_cuda(q, k, v, causal=True, window=window, simt=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before
    torch.testing.assert_close(tc.float(), simt.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_takes_misaligned_inputs(cuda):
    """Inputs whose storage starts off a 16-byte boundary are copied before
    the kernel's 16-byte loads and tensor copies."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((1, 128, 2, 2, 64), generator=gen, device=cuda)
    kv = torch.randn((1 + 2 * 128 * 2 * 64,), generator=gen, device=cuda)
    k = kv[1:1 + 128 * 2 * 64].view(1, 128, 2, 64)
    v = kv[1 + 128 * 2 * 64:].view(1, 128, 2, 64)
    assert k.data_ptr() % 16 != 0 and k.is_contiguous()
    got = flash_attention(q, k, v, causal=True, window=None)
    expect = flash_attention_ref(q, k, v, causal=True, window=None)
    torch.testing.assert_close(got, expect, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_flash_attention_kernel_checks_inputs(cuda):
    q = torch.randn((1, 128, 1, 1, 48), device=cuda)
    k = torch.randn((1, 128, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, k)
    q = torch.randn((1, 128, 2, 2, 64), device=cuda)
    k = torch.randn((1, 128, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention(q[:, :64], k, k)


@pytest.mark.gpu
def test_serving_prefill_through_kernel_matches_cpu(cuda):
    """The reduced danube prefill at S=128: kernel on the card against the
    plain version on the CPU, from the same weights; one launch per layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), use_flash_kernel=True)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)))
    with torch.no_grad():
        ref, _ = T.prefill(params, cfg, tokens, 160, cache_dtype=torch.float32)
        before = LAUNCHES["flash_attention"]
        got, _ = T.prefill(tree_map(lambda t: t.to(cuda), params), cfg, tokens.to(cuda), 160,
                           cache_dtype=torch.float32)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [128, 1024])
@pytest.mark.parametrize("K,G", [(4, 8), (1, 48), (8, 12)],
                         ids=["qwen3-gqa", "granite-mqa", "mistral-gqa"])
def test_flash_attention_kernel_at_moe_and_large_dense_shapes(cuda, K, G, S):
    """hd 128 at the query groups of qwen3-moe-30b-a3b (G = 8),
    granite-20b's MQA (one kv head, G = 48: a block's 128 query rows hold
    under 3 positions) and mistral-large-123b (G = 12), float32."""
    gen = torch.Generator(device=cuda).manual_seed(S + G)
    q = torch.randn((2, S, K, G, 128), generator=gen, device=cuda)
    k = torch.randn((2, S, K, 128), generator=gen, device=cuda)
    v = torch.randn((2, S, K, 128), generator=gen, device=cuda)
    got = flash_attention(q, k, v, causal=True, window=None)
    expect = flash_attention_ref(q, k, v, causal=True, window=None)
    torch.testing.assert_close(got, expect, atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
def test_moe_prefill_on_card_matches_cpu(cuda, arch):
    """The reduced attn_moe / mla_moe prefill at S=128 with the kernel
    switch on: the card (K3 for each attn_moe layer, none for MLA) against
    the CPU from the same weights, and one decode step after it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
    n_attn = sum(kind in ("attn", "attn_moe") for kind in cfg.block_pattern)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)))
    with torch.no_grad():
        ref, ref_cache = T.prefill(params, cfg, tokens, 136, cache_dtype=torch.float32)
        before = LAUNCHES["flash_attention"]
        got, cache = T.prefill(tree_map(lambda t: t.to(cuda), params), cfg, tokens.to(cuda),
                               136, cache_dtype=torch.float32)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + n_attn
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
        tok = ref.argmax(-1)
        ref_next, _ = T.decode_step(params, cfg, tok, ref_cache, 128)
        got_next, _ = T.decode_step(tree_map(lambda t: t.to(cuda), params), cfg, tok.to(cuda),
                                    cache, 128)
        torch.testing.assert_close(got_next.cpu(), ref_next, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,hd,window", [(1, 2048, 5, 5, 64, 1024),
                                               (2, 1280, 8, 8, 128, None)],
                         ids=["hymba-window", "internvl2-causal"])
def test_flash_attention_kernel_at_hybrid_and_vlm_shapes(cuda, B, S, K, G, hd, window):
    """hymba-1.5b's query groups (G = 5: a block's 128 query rows hold 25
    positions, 125 rows live) under its 1024-token window, and
    internvl2-76b's (G = 8, hd 128) over a 256-patch prefix plus a
    1024-token prompt, float32."""
    gen = torch.Generator(device=cuda).manual_seed(S + G)
    q = torch.randn((B, S, K, G, hd), generator=gen, device=cuda)
    k = torch.randn((B, S, K, hd), generator=gen, device=cuda)
    v = torch.randn((B, S, K, hd), generator=gen, device=cuda)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=window)
    assert LAUNCHES["flash_attention"] == before + 1
    expect = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, expect, atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.gpu
def test_chunked_mamba_scan_matches_loop_at_hymba_width(cuda):
    """One full-width hymba-1.5b Mamba head (Di 1600, state 16) on the
    card, batch 1 x 1024 tokens: the chunked scan's output and final state
    within 2e-3 of the per-token loop on the same inputs, and the head's
    output within 2e-3 of the CPU's from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid as HY
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import ssm as SSM
    from repro_torch.models.params import tree_map

    cfg = get_config("hymba-1.5b", n_layers=1)
    di = HY.hymba_d_inner(cfg)
    p_cpu = init_params(model_specs(cfg), seed=0, device="cpu")["layers"][0]["hymba"]["mamba"]
    p = tree_map(lambda t: t.to(cuda), p_cpu)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1024, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        u, z, C, dA, dBu = SSM._mamba_scan_inputs(p, x.to(cuda), di, 16)
        y, h = SSM.mamba_scan_chunked(dA, dBu, C)
        y_ref, h_ref = SSM.mamba_scan_loop(dA, dBu, C)
        torch.testing.assert_close(y, y_ref, atol=2e-3, rtol=2e-3)
        torch.testing.assert_close(h, h_ref, atol=2e-3, rtol=2e-3)
        got = SSM.mamba_forward(p, cfg, x.to(cuda), di)
        ref = SSM.mamba_forward(p_cpu, cfg, x, di)
    torch.testing.assert_close(got.cpu(), ref, atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "internvl2-76b"])
def test_hybrid_and_vlm_prefill_on_card_matches_cpu(cuda, arch):
    """The reduced hymba / internvl2 prefill with the kernel switch on (one
    K3 launch a layer; internvl2's 8-patch prefix plus 120 tokens) and a
    decode step after it: the card against the CPU from the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
    P = cfg.vision_prefix_len
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128 - P)))
    embeds = torch.from_numpy(rng.standard_normal((2, P, 1024)).astype(np.float32)) if P else None
    card = tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        ref, ref_cache = T.prefill(params, cfg, tokens, 136, cache_dtype=torch.float32,
                                   vision_embeds=embeds)
        before = LAUNCHES["flash_attention"]
        got, cache = T.prefill(card, cfg, tokens.to(cuda), 136, cache_dtype=torch.float32,
                               vision_embeds=None if embeds is None else embeds.to(cuda))
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + cfg.n_layers
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
        tok = ref.argmax(-1)
        ref_next, _ = T.decode_step(params, cfg, tok, ref_cache, 128)
        got_next, _ = T.decode_step(card, cfg, tok.to(cuda), cache, 128)
        assert LAUNCHES["flash_attention"] == before + cfg.n_layers
        torch.testing.assert_close(got_next.cpu(), ref_next, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [128, 384])
def test_flash_attention_kernel_at_whisper_decoder_shape(cuda, S):
    """whisper-large-v3's decoder self-attention: plain MHA (G = 1, so a
    block's 128 query rows are 128 positions of one head), 20 kv heads on
    the grid, hd 64, causal, float32; batch 4 at the serving prompt (384)
    and one block (128)."""
    gen = torch.Generator(device=cuda).manual_seed(S + 20)
    q = torch.randn((4, S, 20, 1, 64), generator=gen, device=cuda)
    k = torch.randn((4, S, 20, 64), generator=gen, device=cuda)
    v = torch.randn((4, S, 20, 64), generator=gen, device=cuda)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=None)
    assert LAUNCHES["flash_attention"] == before + 1
    expect = flash_attention_ref(q, k, v, causal=True, window=None)
    torch.testing.assert_close(got, expect, atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.gpu
def test_whisper_prefill_and_decode_on_card_match_cpu(cuda):
    """The reduced whisper prefill with the kernel switch on (128 prompt
    tokens, 64 seeded frames): one K3 launch a decoder layer and none for
    the bidirectional encoder and cross-attention; then a decode step,
    which launches none; the card against the CPU from the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(), use_flash_kernel=True)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.encoder.seq_len, 128))
                              .astype(np.float32))
    card = tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        ref, ref_cache = T.prefill(params, cfg, tokens, 136, cache_dtype=torch.float32,
                                   enc_frames=frames)
        before = LAUNCHES["flash_attention"]
        got, cache = T.prefill(card, cfg, tokens.to(cuda), 136, cache_dtype=torch.float32,
                               enc_frames=frames.to(cuda))
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + cfg.n_layers
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
        for c, r in zip(cache, ref_cache):
            for got_t, ref_t in ((c["xk"], r["xk"]), (c["xv"], r["xv"]),
                                 (c["kv"]["k"], r["kv"]["k"]), (c["kv"]["v"], r["kv"]["v"])):
                torch.testing.assert_close(got_t.cpu(), ref_t, atol=1e-4, rtol=1e-4)
        tok = ref.argmax(-1)
        ref_next, _ = T.decode_step(params, cfg, tok, ref_cache, 128)
        got_next, _ = T.decode_step(card, cfg, tok.to(cuda), cache, 128)
        assert LAUNCHES["flash_attention"] == before + cfg.n_layers
        torch.testing.assert_close(got_next.cpu(), ref_next, atol=1e-4, rtol=1e-4)


def _mlstm_inputs(gen, B, S, H, hd, forget_bias, device):
    """q, k, v at 0.5 N(0, 1); log-sigmoid gates, the forget gate biased
    by ``forget_bias`` (2: the reference's tests; 0: the model's
    initialisation, whose in-chunk spans pass float32's exp limit)."""
    q, k, v = (0.5 * torch.randn((B, S, H, hd), generator=gen, device=device)
               for _ in range(3))
    li = torch.nn.functional.logsigmoid(torch.randn((B, S, H), generator=gen, device=device))
    lf = torch.nn.functional.logsigmoid(
        torch.randn((B, S, H), generator=gen, device=device) + forget_bias)
    return q, k, v, li, lf


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", [2.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 128, 2, 32, 32), (2, 256, 2, 64, 64), (1, 256, 4, 32, 128),
    (2, 128, 4, 128, 128), (1, 256, 2, 512, 128), (1, 96, 1, 96, 32),  # a ragged last chunk
    (2, 2048, 4, 512, 128),    # xlstm-350m's forward shape at batch 2
])
def test_mlstm_scan_kernel_matches_plain(cuda, B, S, H, hd, chunk, dtype, forget_bias):
    """The reference's K4 tolerance (atol 2e-4 / rtol 2e-3) in float32,
    2e-2 in bfloat16; finite for both gate draws."""
    gen = torch.Generator(device=cuda).manual_seed(S * hd + H)
    q, k, v, li, lf = _mlstm_inputs(gen, B, S, H, hd, forget_bias, cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = LAUNCHES["mlstm_scan"]
    got = mlstm_scan(q, k, v, li, lf, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm_scan"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    expect = mlstm_chunked_ref(q, k, v, li, lf, chunk=chunk)
    tol = 2e-2 if dtype == torch.bfloat16 else None
    torch.testing.assert_close(got.float(), expect.float(), atol=tol or 2e-4, rtol=tol or 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", [2.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 128, 2, 32, 32), (2, 256, 2, 64, 64), (1, 256, 4, 32, 128),
    (2, 128, 4, 128, 128), (1, 256, 2, 512, 128), (1, 96, 1, 96, 32),
    (2, 2048, 4, 512, 128),
])
def test_mlstm_scan_simt_entry_matches_plain(cuda, B, S, H, hd, chunk, dtype, forget_bias):
    """The CUDA-core kernel kept for timing, at the same tolerances; it
    counts no launch (the count is the dispatcher's)."""
    gen = torch.Generator(device=cuda).manual_seed(S * hd + H)
    q, k, v, li, lf = _mlstm_inputs(gen, B, S, H, hd, forget_bias, cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = LAUNCHES["mlstm_scan"]
    got = mlstm_scan_cuda(q, k, v, li, lf, simt=True)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm_scan"] == before
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    expect = mlstm_chunked_ref(q, k, v, li, lf, chunk=chunk)
    tol = 2e-2 if dtype == torch.bfloat16 else None
    torch.testing.assert_close(got.float(), expect.float(), atol=tol or 2e-4, rtol=tol or 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [200, 300, 1000])
def test_mlstm_scan_kernel_ragged_last_chunk(cuda, S):
    """S not a multiple of the kernel's 128-token chunk: the last chunk is
    padded with zeros and its rows past S are not written."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, li, lf = _mlstm_inputs(gen, 2, S, 2, 96, 0.0, cuda)
    got = mlstm_scan(q, k, v, li, lf, chunk=S // 4 if S % 4 == 0 else S)
    expect = mlstm_chunked_ref(q, k, v, li, lf, chunk=S)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, expect, atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_mlstm_scan_kernel_at_forward_shape(cuda):
    """xlstm-350m's forward shape (B=4, S=2048, H=4, hd=512) with unbiased
    gates: the scratches the wrapper allocates for it (240 MiB of chunk
    states, 16 MiB of scores), finite and within the reference's tolerance."""
    B, S, H, hd = 4, 2048, 4, 512
    states, scores = scratch_shapes(B, S, H, hd)
    assert states == (4, 4, 15, 512, 512) and scores == (4, 4, 16, 128, 128)
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, li, lf = _mlstm_inputs(gen, B, S, H, hd, 0.0, cuda)
    got = mlstm_scan(q, k, v, li, lf)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, mlstm_chunked_ref(q, k, v, li, lf), atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_mlstm_scan_kernel_takes_misaligned_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, _, v, li, lf = _mlstm_inputs(gen, 1, 256, 2, 64, 2.0, cuda)
    flat = torch.randn(1 + q.numel(), generator=gen, device=cuda)
    k = flat[1:].view(q.shape)
    assert k.data_ptr() % 16 != 0
    torch.testing.assert_close(mlstm_scan(q, k, v, li, lf), mlstm_chunked_ref(q, k, v, li, lf),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_xlstm_350m_forward_launches_mlstm_scan_once_per_mlstm_layer(cuda):
    """The full xlstm-350m (24 layers, 20 mLSTM) at 256 tokens: 20 launches
    of the scan per forward, none in the prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("xlstm-350m"), use_flash_kernel=True, remat=False)
    assert cfg.block_pattern.count("mlstm") == 20
    params = init_params(model_specs(cfg), seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 256)))
    with torch.no_grad():
        before = LAUNCHES["mlstm_scan"]
        logits = T.forward(params, cfg, tokens.to(cuda))
        torch.cuda.synchronize()
        assert LAUNCHES["mlstm_scan"] == before + 20
        assert bool(torch.isfinite(logits).all())
        before = LAUNCHES["mlstm_scan"]
        T.prefill(params, cfg, tokens.to(cuda), 260, cache_dtype=torch.float32)
        assert LAUNCHES["mlstm_scan"] == before


@pytest.mark.gpu
def test_mlstm_scan_kernel_checks_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, li, lf = _mlstm_inputs(gen, 1, 128, 2, 48, 2.0, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        mlstm_scan(q, k, v, li, lf, chunk=128)
    q, k, v, li, lf = _mlstm_inputs(gen, 1, 128, 2, 64, 2.0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mlstm_scan(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, li, lf)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mlstm_scan(q[:, :96], k[:, :96], v[:, :96], li[:, :96], lf[:, :96])
    with pytest.raises(ValueError, match="head_dim"):
        mlstm_scan_cuda(*_mlstm_inputs(gen, 1, 64, 1, 544, 2.0, cuda))


@pytest.mark.gpu
def test_xlstm_forward_through_kernel_matches_cpu(cuda):
    """Reduced xlstm-350m's forward with ``use_flash_kernel`` at S=128:
    the kernel on the card against the plain version on the CPU, from the
    same weights; one launch per mLSTM layer, none in the prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(), use_flash_kernel=True,
                              remat=False)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)))
    with torch.no_grad():
        ref = T.forward(params, cfg, tokens)
        before = LAUNCHES["mlstm_scan"]
        got = T.forward(card, cfg, tokens.to(cuda))
        torch.cuda.synchronize()
        assert LAUNCHES["mlstm_scan"] == before + cfg.block_pattern.count("mlstm")
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
        ref_pre, _ = T.prefill(params, cfg, tokens, 160, cache_dtype=torch.float32)
        before = LAUNCHES["mlstm_scan"]
        got_pre, _ = T.prefill(card, cfg, tokens.to(cuda), 160, cache_dtype=torch.float32)
        assert LAUNCHES["mlstm_scan"] == before
    torch.testing.assert_close(got_pre.cpu(), ref_pre, atol=1e-4, rtol=1e-4)


def _timing_inputs(gen, dev, C, R, U, E, N, dtype, carry, with_t0):
    """A MATCHA-like arc pool: a self-loop per node first (with ``carry``
    some rows drop some of them, and one row is all -inf), then random
    arcs whose dst covers only the lower half of the nodes in half the
    cases; random round ids and, with ``with_t0``, random start times."""
    k = min(N, E)
    src = torch.randint(0, N, (E,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, max(N // 2, 1), (E,), generator=gen, device=dev, dtype=torch.int32)
    src[:k] = torch.arange(k, dtype=torch.int32, device=dev)
    dst[:k] = src[:k]
    w = torch.rand((U, E), generator=gen, device=dev, dtype=torch.float64) * 50 + 1
    w[:, k:][torch.rand((U, E - k), generator=gen, device=dev) < 0.4] = float("-inf")
    if carry:
        w[:, :k][torch.rand((U, k), generator=gen, device=dev) < 0.3] = float("-inf")
        w[U - 1] = float("-inf")
    ids = torch.randint(0, U, (C, R), generator=gen, device=dev, dtype=torch.int32)
    t0 = (torch.rand((C, N), generator=gen, device=dev, dtype=torch.float64) * 10
          if with_t0 else None)
    return src, dst, w.to(dtype), ids, None if t0 is None else t0.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,R,U,E,N,carry,with_t0", [
    (1, 1, 1, 1, 2, False, False), (3, 17, 5, 40, 11, True, True),
    (24, 150, 24, 261, 87, False, False), (64, 300, 64, 576, 64, True, False),
    (8, 40, 9, 2048, 512, True, True), (2, 5, 3, 30000, 300, True, True)])
def test_timing_kernel_matches_plain_bit_for_bit(cuda, C, R, U, E, N, carry, with_t0, dtype):
    from repro_torch.kernels import timing_recursion
    from repro_torch.kernels.segment_max import timing_recursion_ref

    gen = torch.Generator(device=cuda).manual_seed(C * R + E)
    args = _timing_inputs(gen, cuda, C, R, U, E, N, dtype, carry, with_t0)
    before = LAUNCHES["timing"]
    got = timing_recursion(*args[:4], N, args[4])
    torch.cuda.synchronize()
    assert LAUNCHES["timing"] == before + 1
    assert got.dtype == dtype and got.shape == (C, R + 1, N)
    assert torch.equal(got, timing_recursion_ref(*args[:4], N, args[4]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", [8, 4, 2, 1])
def test_timing_kernel_each_cluster_size_bit_for_bit(cuda, cluster, dtype):
    """C chosen so that the plan spreads a chain over ``cluster`` CTAs; E
    odd (float64 rows 8 bytes off a 16-byte boundary), N not a multiple of
    the cluster, the last row of w (all -inf) in every chain's last round."""
    from repro_torch.kernels import timing_recursion
    from repro_torch.kernels.segment_max import (TIMING_MIN_ARCS_PER_CTA, timing_plan_on_card,
                                                 timing_recursion_ref)

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    C = sms // cluster if cluster > 1 else sms // 2 + 1
    E, N, R, U = 8 * TIMING_MIN_ARCS_PER_CTA + 1, 87, 23, 9
    plan = timing_plan_on_card(C, E, N, dtype, cuda)
    assert plan.cluster == cluster and plan.stages >= 2
    gen = torch.Generator(device=cuda).manual_seed(cluster)
    src, dst, w, ids, t0 = _timing_inputs(gen, cuda, C, R, U, E, N, dtype, True, cluster % 4 == 0)
    ids[:, -1] = U - 1
    assert bool(torch.isneginf(w[U - 1]).all())
    before = LAUNCHES["timing"]
    got = timing_recursion(src, dst, w, ids, N, t0)
    torch.cuda.synchronize()
    assert LAUNCHES["timing"] == before + 1
    assert torch.equal(got, timing_recursion_ref(src, dst, w, ids, N, t0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_timing_kernel_every_plan_bit_for_bit(cuda, dtype):
    """Every cluster size with the ring at each depth and with arcs and
    weights read in place, through the launcher, on one pool."""
    from repro_torch.kernels.segment_max import (TimingPlan, _launch_timing, timing_smem_bytes,
                                                 timing_recursion_ref)

    C, R, U, E, N = 5, 31, 7, 1001, 45
    gen = torch.Generator(device=cuda).manual_seed(7)
    src, dst, w, ids, t0 = _timing_inputs(gen, cuda, C, R, U, E, N, dtype, True, True)
    ids[0, -1] = U - 1
    want = timing_recursion_ref(src, dst, w, ids, N, t0)
    size = w.element_size()
    for cluster in (1, 2, 4, 8):
        arcs = -(-E // cluster)
        for stages in (0, 2, 3, 4):
            plan = TimingPlan(cluster, arcs, stages,
                              timing_smem_bytes(N, arcs, stages, size, cluster))
            got = _launch_timing(src, dst, w, ids, N, t0, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_timing_kernel_at_the_node_limit_and_refused_past_it(cuda, dtype):
    from repro_torch.kernels import timing_recursion
    from repro_torch.kernels.segment_max import (_library, timing_plan_on_card,
                                                 timing_recursion_ref)

    lib = _library()
    limit = int(lib.timing_max_nodes({torch.float32: 0, torch.float64: 1}[dtype]))
    C, R, U, E = 2, 3, 2, 2 * limit
    plan = timing_plan_on_card(C, E, limit, dtype, cuda)
    assert plan.stages == 0 and plan.smem_bytes <= int(lib.smem_cap())
    assert plan.cluster == 1 and plan.smem_bytes == int(lib.timing_smem_bytes(
        limit, plan.arcs_per_cta, 0, 1, dtype == torch.float64))
    gen = torch.Generator(device=cuda).manual_seed(limit)
    src, dst, w, ids, _ = _timing_inputs(gen, cuda, C, R, U, E, limit, dtype, True, False)
    got = timing_recursion(src, dst, w, ids, limit)
    torch.cuda.synchronize()
    assert torch.equal(got, timing_recursion_ref(src, dst, w, ids, limit))
    before = LAUNCHES["timing"]
    with pytest.raises(ValueError, match="limit"):
        timing_recursion(src, dst, w, ids, limit + 1)
    assert LAUNCHES["timing"] == before


@pytest.mark.gpu
def test_timing_kernel_refused_plans_raise(cuda):
    """A plan the card cannot take raises and launches nothing: shared
    memory past the card's grant, a cluster size the kernel does not take,
    a split that leaves arcs out."""
    from repro_torch.kernels.segment_max import TimingPlan, _launch_timing, _smem_cap

    gen = torch.Generator(device=cuda).manual_seed(5)
    src, dst, w, ids, _ = _timing_inputs(gen, cuda, 2, 4, 3, 40000, 11, torch.float64, False,
                                         False)
    cap = _smem_cap(torch.cuda.current_device())
    for plan in (TimingPlan(1, 40000, 4, cap + 1), TimingPlan(16, 2500, 2, 0),
                 TimingPlan(2, 10000, 2, 0)):
        with pytest.raises(RuntimeError, match="timing_recursion kernel launch failed"):
            _launch_timing(src, dst, w, ids, 11, None, plan)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_timing_launches_count_one_per_call_and_none_when_empty(cuda):
    from repro_torch.kernels import timing_recursion

    gen = torch.Generator(device=cuda).manual_seed(3)
    src, dst, w, ids, _ = _timing_inputs(gen, cuda, 4, 10, 3, 20, 6, torch.float64, True, False)
    before = LAUNCHES["timing"]
    timing_recursion(src, dst, w, ids, 6)
    timing_recursion(src, dst, w, ids, 6)
    assert LAUNCHES["timing"] == before + 2
    empty = timing_recursion(src, dst, w, ids[:0], 6)
    assert empty.shape == (0, 11, 6) and LAUNCHES["timing"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_timing_kernel_refuses_more_nodes_than_shared_memory_holds(cuda, dtype):
    from repro_torch.kernels import timing_recursion

    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    w = torch.ones((1, 1), dtype=dtype, device=cuda)
    ids = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    before = LAUNCHES["timing"]
    with pytest.raises(ValueError, match="limit"):
        timing_recursion(one, one, w, ids, 1 << 20)
    assert LAUNCHES["timing"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["src", "dst", "round_id"])
def test_timing_kernel_out_of_range_ids_give_a_cuda_error(cuda, bad):
    """The kernel stops at an id outside its range; the fault kills the
    CUDA context, so it is provoked in a subprocess."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from repro_torch.kernels.segment_max import timing_recursion_cuda\n"
        "d = torch.device('cuda')\n"
        "src = torch.tensor([0, 1, 1], dtype=torch.int32, device=d)\n"
        "dst = torch.tensor([0, 1, 0], dtype=torch.int32, device=d)\n"
        "ids = torch.zeros((2, 4), dtype=torch.int32, device=d)\n"
        f"bad = {bad!r}\n"
        "if bad == 'src': src[2] = 7\n"
        "if bad == 'dst': dst[2] = -1\n"
        "if bad == 'round_id': ids[1, 3] = 2\n"
        "w = torch.ones((2, 3), dtype=torch.float64, device=d)\n"
        "timing_recursion_cuda(src, dst, w, ids, 2)\n"
        "torch.cuda.synchronize()\n"
    )
    src_dir = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src_dir))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr


@pytest.mark.gpu
def test_matcha_design_on_card_equals_cpu(cuda):
    """Gaia's MATCHA budget sweep at the reference's defaults: one timing
    launch, every chain's tau and the chosen budget as on the CPU."""
    import repro_torch.core as P

    M, Tc = P.WORKLOADS["inaturalist"]
    gc = P.make_underlay("gaia").connectivity_graph(comp_time_ms=Tc)
    tp = P.TrainingParams(model_size_mbits=M, local_steps=1)
    matchings = P.matcha_schedule_from_connectivity(gc).matchings
    cands = [P.MatchaSchedule(matchings=matchings, budget=b) for b in P.DEFAULT_MATCHA_BUDGETS]
    before = LAUNCHES["timing"]
    card = P.average_cycle_times_batched(cands, gc, tp, rounds=150, seeds=(0, 1, 2), device=cuda)
    assert LAUNCHES["timing"] == before + 1
    cpu = P.average_cycle_times_batched(cands, gc, tp, rounds=150, seeds=(0, 1, 2), device="cpu")
    np.testing.assert_array_equal(card, cpu)
    s_card = P.design_schedule("matcha", gc, tp, device=cuda)
    s_cpu = P.design_schedule("matcha", gc, tp, device="cpu")
    assert s_card == s_cpu


@pytest.mark.gpu
def test_migration_on_card_equals_cpu(cuda):
    """11 -> 10 -> 11 silos, float32 rows of a P that is not a multiple of
    4: survivors gathered and joiners averaged in float64 on the card give
    the CPU's bits."""
    from repro_torch.fed import migrate_silo_state

    P = 1_000_003
    gen = torch.Generator().manual_seed(11)
    state = {"params": torch.randn((11, P), generator=gen),
             "opt_state": torch.randn((11, P), generator=gen), "step": 6}
    full, less = tuple(range(11)), tuple(v for v in range(11) if v != 5)
    cpu, card = state, {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                        for k, v in state.items()}
    for old, new in ((full, less), (less, full)):
        cpu, *moved_cpu = migrate_silo_state(cpu, old, new)
        card, *moved_card = migrate_silo_state(card, old, new)
        assert moved_card == moved_cpu
        assert card["params"].is_cuda and card["params"].shape == (len(new), P)
        for k in ("params", "opt_state"):
            assert torch.equal(card[k].cpu(), cpu[k])
    assert not torch.equal(cpu["params"][5], state["params"][5])  # silo 5 re-entered at the mean


def _linkfail_loop(device):
    """The reference test's Gaia link-failure loop, ring incumbent,
    rewire climb off: the re-design records (wall time aside)."""
    import repro_torch.core as C
    import repro_torch.dynamics as D
    from repro_torch.fed import PlanSlot, plan_from_overlay

    M, Tc = C.WORKLOADS["inaturalist"]
    u = C.make_underlay("gaia")
    gc = u.connectivity_graph(comp_time_ms=Tc)
    tp = C.TrainingParams(model_size_mbits=M, local_steps=1)
    ring = C.ring_overlay(gc, tp)
    deadline = 400 * ring.cycle_time_ms
    tl = D.DynamicTimeline(D.link_failure_scenario(u, Tc, t_fail_ms=deadline / 3,
                                                   overlay_edges=ring.edges,
                                                   horizon_ms=deadline), tp)
    tl.set_overlay(ring.edges)
    slot = PlanSlot(plan_from_overlay(ring, gc.num_silos))

    def provider():
        ep = tl.current_epoch()
        return D.active_subgraph(ep.gc, ep.active)

    ctl = D.OnlineTopologyController(gc, tp, ring, plan_slot=slot, device=device,
                                     config=D.ControllerConfig(seed=0, rewire_restarts=0),
                                     connectivity_provider=provider)
    while tl.now_ms < deadline:
        rd = ctl.observe_round(tl.step())
        if rd is not None:
            tl.set_schedule(rd.schedule)
    return [(rd.round_idx, rd.overlay.edges, rd.predicted_tau_ms, rd.measured_ms,
             rd.n_candidates, rd.bottleneck, rd.expected_window_ms, rd.drift)
            for rd in ctl.redesigns], slot.version


@pytest.mark.gpu
def test_controller_linkfail_on_card_equals_cpu(cuda):
    before = LAUNCHES["timing"]
    card = _linkfail_loop(cuda)
    assert LAUNCHES["timing"] == before + 1 + len(card[0])  # one calibration each
    assert card == _linkfail_loop("cpu")
    assert len(card[0]) >= 1 and card[1] >= 2


# the zoo's training side: flash_attention_vjp, AdamW, launch/steps.py


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,T", [(True, None, 1024), (True, 300, 1024),
                                             (False, None, 1000)])
def test_flash_vjp_on_card_matches_chunked_autograd(cuda, causal, window, T):
    """B=1, S=1024 queries, K=8, G=2, hd=128 (internlm2's attention
    layers), 1024-key blocks (T = 1000 leaves a padded block): output 2e-5,
    gradients 2e-4 of autograd through the chunked path."""
    from repro_torch.models.attention import chunked_attention, flash_attention_vjp

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(T + (window or 0))
    q = torch.randn((1, 1024, 8, 2, 128), generator=gen, device=cuda)
    k, v = (torch.randn((1, T, 8, 128), generator=gen, device=cuda) for _ in range(2))
    w = torch.randn(q.shape, generator=gen, device=cuda)
    q_pos, kv_pos = torch.arange(T - 1024, T, device=cuda), torch.arange(T, device=cuda)
    results = []
    for f in (lambda *a: flash_attention_vjp(*a, q_pos, kv_pos, causal, window, 1024),
              lambda *a: chunked_attention(*a, q_pos, kv_pos, causal=causal, window=window)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = f(*ts)
        (out * w).sum().backward()
        results.append((out.detach(), [t.grad for t in ts]))
    (o1, g1), (o2, g2) = results
    torch.testing.assert_close(o1, o2, atol=2e-5, rtol=2e-5)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def _adamw_rounds(device, state, rounds=2):
    from repro_torch.configs import get_config
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import batch_to_device

    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=2, flash_vjp=True)
    step = build_train_step(cfg, gossip_impl="pallas")
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, 32, n_silos=2), 1, 2)
    losses = []
    for r in range(rounds):
        state, metrics = step(state, batch_to_device(batcher.batch(r), torch.device(device)))
        losses.append(float(metrics["loss"]))
    return losses, state


@pytest.mark.gpu
def test_adamw_rounds_on_card_match_cpu(cuda):
    """Two reduced internlm2 rounds (2 silos on a ring, AdamW at 1e-4,
    flash_vjp, K2 mix) on the card and on the CPU from the same state:
    loss trajectories within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.fed import init_state
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=2)
    state = init_state(cfg, adamw(1e-4), seed=0, device="cpu")

    def to(dev):
        return {"params": state["params"].to(dev), "step": state["step"],
                "opt_state": {k: v.to(dev) for k, v in state["opt_state"].items()}}

    before = LAUNCHES["gossip_mix"]
    card, card_state = _adamw_rounds(cuda, to(cuda))
    assert LAUNCHES["gossip_mix"] == before + 2
    cpu, cpu_state = _adamw_rounds("cpu", to("cpu"))
    np.testing.assert_allclose(card, cpu, atol=1e-5)
    assert card_state["step"] == cpu_state["step"] == 2
    assert float((card_state["params"].cpu() - cpu_state["params"]).abs().max()) <= 2 * 1e-4 * 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "xlstm-350m", "internvl2-76b",
                                  "internlm2-1.8b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                                  "granite-20b", "mistral-large-123b", "whisper-large-v3",
                                  "hymba-1.5b"])
def test_reduced_train_step_on_card(cuda, arch):
    """One ``build_train_step`` round (two local AdamW steps, flash_vjp) of
    each reduced arch on the card: finite, and the loss on the round's
    first batch falls; no kernel launches but K2's (one silo: none)."""
    from repro_torch.configs import get_config
    from repro_torch.fed import init_state
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import ParamLayout, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), flash_vjp=True)
    opt = adamw(3e-3)
    state = init_state(cfg, opt, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 16), generator=gen, device=cuda)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, 2, cfg.encoder.seq_len, 128), generator=gen,
                                          device=cuda)
    if cfg.vision_prefix_len:
        batch["vision_embeds"] = torch.randn((2, 2, cfg.vision_prefix_len, 1024), generator=gen,
                                             device=cuda)
    first = {k: v[0] for k, v in batch.items()}
    layout = ParamLayout(model_specs(cfg))
    with torch.no_grad():
        l0 = float(T.loss_fn(layout.views(state["params"]), cfg, first))
    before = dict(LAUNCHES)
    state, metrics = build_train_step(cfg, optimizer=opt, local_steps=2)(state, batch)
    with torch.no_grad():
        l1 = float(T.loss_fn(layout.views(state["params"]), cfg, first))
    assert LAUNCHES == before
    assert np.isfinite(float(metrics["loss"])) and l1 < l0


@pytest.mark.gpu
def test_kernels_refuse_gradients_on_card(cuda):
    """K3 and K4 have no backward: on CUDA tensors that require grad the
    wrappers raise before launching; under ``no_grad`` they launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 128, 2, 2, 32), generator=gen, device=cuda)
    k, v = (torch.randn((1, 128, 2, 32), generator=gen, device=cuda) for _ in range(2))
    gates = [torch.randn((1, 128, 2), generator=gen, device=cuda) for _ in range(2)]
    for name, call, args in (("flash_attention", flash_attention, (q, k, v)),
                             ("mlstm_scan", mlstm_scan, (q[:, :, :, 0].contiguous(), k, v, *gates))):
        before = LAUNCHES[name]
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(*[a.clone().requires_grad_(i == 0) for i, a in enumerate(args)])
        assert LAUNCHES[name] == before
        with torch.no_grad():
            call(*[a.clone().requires_grad_() for a in args])
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1


@pytest.mark.gpu
def test_trace_payloads_refuse_cuda_tensors(cuda, tmp_path):
    """A CUDA tensor in a flight-recorder payload raises instead of
    synchronising inside ``emit``; its host copy serialises, and the run
    metadata names the card once CUDA is initialised."""
    from repro_torch.obs import events

    t = torch.arange(3, device=cuda)
    with pytest.raises(TypeError, match="CUDA tensor"):
        events._jsonable(t)
    path = tmp_path / "t.jsonl"
    rec = events.FlightRecorder(str(path))
    assert rec.silo_names is None
    with pytest.raises(TypeError, match="CUDA tensor"):
        rec.emit("epoch", index=0, t_start_ms=0.0, active=t)
    rec.emit("epoch", index=0, t_start_ms=0.0, active=t.cpu())
    rec.close()
    records, problems = events.validate_trace(str(path))
    assert problems == [] and records[1]["active"] == [0, 1, 2]
    assert events.run_metadata()["device_kind"] == torch.cuda.get_device_name()


# ---------------------------------------------------------------------------
# One silo per process on the card (repro_torch.launch.mesh)

def _mix_rank_on_card(rank, world, init, backend, device, rows):
    """A rank of the two-rank checks: its row of a 2-silo ring's ``pallas``
    mix over ``backend`` on ``device``, with its K2 launches and the bytes
    it staged."""
    from repro_torch.fed import plan_for_n_silos
    from repro_torch.fed.gossip import mix_rank
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import init_silo_mesh

    mesh = init_silo_mesh(rank, world, init, backend=backend, device=device,
                          log=lambda line: None)
    reset_launch_counts()
    row = rows[rank].to(mesh.device)
    got = mix_rank(row, plan_for_n_silos("ring", world), "pallas", mesh, out=row)
    torch.cuda.synchronize(mesh.device)
    return {"row": got.cpu(), "launches": LAUNCHES["gossip_mix"], "staged": mesh.staged_bytes,
            "recv": mesh.recv_bytes}


def _two_rows(n):
    gen = torch.Generator().manual_seed(n)
    return torch.randn((2, n), generator=gen)


def _stacked_mix(cuda, rows):
    from repro_torch.fed import plan_for_n_silos
    from repro_torch.fed.gossip import gossip_fused

    return gossip_fused(rows.to(cuda), plan_for_n_silos("ring", 2)).cpu()


@pytest.mark.gpu
def test_two_ranks_on_one_card_over_staged_gloo_mix_bit_identical(cuda):
    """Two ranks share cuda:0 over gloo: each transfer is staged through
    pinned host memory in chunks (here three), and each rank's K2 output is
    row r of the stacked ``gossip_fused``, bit for bit."""
    from repro_torch.launch.mesh import CHUNK_BYTES, spawn

    n = 2 * (CHUNK_BYTES // 4) + 12345
    rows = _two_rows(n)
    ranks = spawn(_mix_rank_on_card, 2, "gloo", "cuda:0", rows)
    expect = _stacked_mix(cuda, rows)
    for rank, r in enumerate(ranks):
        assert torch.equal(r["row"], expect[rank])
        assert r["launches"] == 1 and r["recv"] == n * 4
        assert r["staged"] == 2 * n * 4  # its row out, its neighbour's in


@pytest.mark.gpu
def test_nccl_with_two_ranks_on_one_device_raises(cuda):
    from repro_torch.launch.mesh import spawn

    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="nccl needs one device per rank"):
        spawn(_mix_rank_on_card, 2, "nccl", "cuda:0", _two_rows(1024))


@pytest.mark.gpu
def test_nccl_on_two_cards_mix_bit_identical(cuda):
    """One rank per card over NCCL: the device rows go as they are (nothing
    staged), each rank's K2 output bit-identical to the stacked mix."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.launch.mesh import spawn

    rows = _two_rows((1 << 24) + 7)
    ranks = spawn(_mix_rank_on_card, 2, "nccl", "cuda", rows)
    expect = _stacked_mix(cuda, rows)
    for rank, r in enumerate(ranks):
        assert torch.equal(r["row"], expect[rank])
        assert r["launches"] == 1 and r["staged"] == 0


@pytest.mark.gpu
def test_flash_attention_at_the_32k_prefill_shape_matches_plain(cuda):
    """K3 at h2o-danube-1.8b's prefill_32k shape (B=1, S=T=32768, K=8, G=4,
    hd=80, window 4096); the plain version chunks its queries."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn((1, 32768, 8, 4, 80), generator=gen, device=cuda)
    k = torch.randn((1, 32768, 8, 80), generator=gen, device=cuda)
    v = torch.randn((1, 32768, 8, 80), generator=gen, device=cuda)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=4096)
    assert LAUNCHES["flash_attention"] == before + 1
    expect = flash_attention_ref(q, k, v, causal=True, window=4096)
    torch.testing.assert_close(got, expect, atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.gpu
def test_dryrun_halves_the_batch_until_the_decode_cache_fits(cuda):
    """internlm2-1.8b decode_32k from the reference's batch 128: its bf16
    cache is 3.2 GB a sequence, so the first batches run out of memory and
    the record keeps them, each half of the one before."""
    from repro_torch.launch.dryrun import dryrun_one

    r = dryrun_one("internlm2-1.8b", "decode_32k", device=cuda, reps=1, profile=False)
    assert r["status"] == "ok", r.get("traceback", r.get("error"))
    failed = r["failed_batches"]
    assert failed and failed == [128 >> i for i in range(len(failed))]
    assert r["batch"] == 128 >> len(failed) and r["finite"]
    assert all("out of memory" in f["error"].lower() for f in r["oom"])
    assert 0 < r["roofline"]["share"] <= 1.0
    assert r["peak_bytes"] <= torch.cuda.get_device_properties(cuda).total_memory
