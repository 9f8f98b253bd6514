"""The hand-written CUDA kernels on the card, against their plain
versions.  This file imports no JAX so it also runs where only PyTorch
is installed; run it on a machine with an NVIDIA Hopper GPU with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Without a card the tests skip."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES, edge_segment_max, gossip_mix  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_ref  # noqa: E402
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
    before = LAUNCHES["segment_max"]
    card = batched_cycle_time_sparse_torch(*[a.to(cuda) for a in args], n)
    assert LAUNCHES["segment_max"] == before + n  # one launch per Karp level
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_climb_launches_one_kernel_per_karp_level(cuda):
    import repro_torch.core as P

    gc = P.make_underlay("gaia").connectivity_graph(comp_time_ms=25.4)
    tp = P.TrainingParams(model_size_mbits=42.88, local_steps=1)
    before = LAUNCHES["segment_max"]
    ov = P.search_overlays_jit(gc, tp, n_restarts=4, n_steps=5, device=cuda)
    assert LAUNCHES["segment_max"] - before == (5 + 1) * gc.num_silos
    assert ov.cycle_time_ms <= P.ring_overlay(gc, tp).cycle_time_ms
