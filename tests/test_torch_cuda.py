"""The hand-written CUDA kernels on the card, against their plain
versions.  This file imports no JAX so it also runs where only PyTorch
is installed; run it on a machine with an NVIDIA Hopper GPU with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Without a card the tests skip."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES, gossip_mix  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_ref  # noqa: E402

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
