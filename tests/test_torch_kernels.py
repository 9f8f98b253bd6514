"""The port's gossip_mix (plain version on the CPU) against the Pallas
kernel it replaces, run in interpret mode.  Same K/N/dtype sweep and
tolerances as tests/test_kernels.py (f32 2e-5, bf16 2e-2)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gossip_mix import gossip_mix_pallas  # noqa: E402
from repro_torch.kernels import LAUNCHES, gossip_mix  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_cuda, gossip_mix_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(K, N, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((K, N)).astype(np.float32)
    z = rng.standard_normal(K)
    w = (np.exp(z) / np.exp(z).sum()).astype(np.float32)  # softmax weights
    return blocks, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mult", [1, 5])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_gossip_mix_matches_pallas(K, mult, dtype):
    N = 1000 * mult + 13
    blocks, w = _inputs(K, N, seed=K * N)
    expect = gossip_mix_pallas(jnp.asarray(blocks).astype(JNP[dtype]), jnp.asarray(w),
                               block=512, interpret=True)
    got = gossip_mix(torch.from_numpy(blocks).to(TORCH[dtype]), torch.from_numpy(w))
    assert got.dtype == TORCH[dtype] and got.shape == (N,)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(expect, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_gossip_mix_convex_combination_preserves_constants():
    K, N = 4, 5000
    w = torch.full((K,), 0.25)
    blocks = torch.arange(N, dtype=torch.float32).expand(K, N).contiguous()
    np.testing.assert_allclose(gossip_mix(blocks, w).numpy(), np.arange(N), rtol=1e-6)


def test_gossip_mix_writes_out_and_counts_no_cpu_launch():
    blocks, w = _inputs(3, 777, seed=5)
    out = torch.empty(777)
    before = LAUNCHES["gossip_mix"]
    res = gossip_mix(torch.from_numpy(blocks), torch.from_numpy(w), out=out)
    assert res.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), (w[:, None] * blocks).sum(0), atol=2e-6)
    assert LAUNCHES["gossip_mix"] == before  # the count moves only on kernel launches


def test_gossip_mix_cuda_refuses_cpu_tensors():
    blocks, w = _inputs(2, 64, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_cuda(torch.from_numpy(blocks), torch.from_numpy(w))


def test_plain_version_accumulates_bf16_in_f32():
    # a bf16 accumulator rounds 1 + 2^-8 back to 1 at every step; f32
    # keeps all four terms and 1 + 2^-6 is a bf16 value
    blocks = torch.tensor([[1.0] * 8] + [[2 ** -8] * 8] * 4).to(torch.bfloat16)
    got = gossip_mix_ref(blocks, torch.ones(5))
    assert torch.equal(got, torch.full((8,), 1.0 + 2 ** -6, dtype=torch.bfloat16))


def test_gossip_mix_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        gossip_mix(torch.empty(2, 8, device="meta"), torch.ones(2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from pathlib import Path

    from repro_torch.kernels import _build

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert "gossip_mix" in _build.kernel_sources()
    assert _build.library_path("gossip_mix").name.startswith("libgossip_mix-")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
