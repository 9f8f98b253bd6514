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
