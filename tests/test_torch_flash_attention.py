"""The port's flash attention (K3) on the CPU: its plain version against
the JAX package's ``attention_ref`` and the Pallas kernel in interpret
mode, and against the port's own chunked path; the wrapper's dispatch
and preconditions.

Tolerances are the reference's kernel sweep's (tests/test_kernels.py):
float32 2e-5, bfloat16 2e-2 (outputs compared in float32; the sums are
taken in another order).  Inputs come from numpy seeds."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import LAUNCHES, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.models.attention import chunked_attention, naive_attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, B, S, K, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(T_DTYPE[dtype]) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(J_DTYPE[dtype]) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,bq,bkv", [
    (1, 128, 1, 1, 64, 64, 64),
    (2, 256, 2, 2, 64, 128, 128),
    (1, 256, 4, 1, 128, 64, 128),
    (2, 128, 1, 4, 32, 32, 64),
    (1, 256, 2, 4, 80, 128, 128),     # danube's head_dim and group
])
def test_plain_matches_reference_and_pallas(B, S, K, G, hd, bq, bkv, dtype):
    arrays = _inputs(B * S + hd, B, S, K, G, hd)
    got = flash_attention_ref(*_torch(arrays, dtype), causal=True, window=None)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (B, S, K, G, hd)
    jq, jk, jv = _jax(arrays, dtype)
    expect = jref.attention_ref(jq, jk, jv, causal=True, window=None)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=None,
                                    block_q=bq, block_kv=bkv, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_plain_sliding_window_matches_pallas(window):
    arrays = _inputs(7, 1, 256, 2, 2, 64)
    got = flash_attention_ref(*_torch(arrays, "float32"), causal=True, window=window)
    jq, jk, jv = _jax(arrays, "float32")
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                    block_q=64, block_kv=64, interpret=True)
    expect = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("max_scores", [1 << 28, 1000])
def test_plain_matches_ports_chunked_and_naive(window, max_scores):
    """Query chunks of one position (max_scores=1000) or all at once give
    the chunked path's result."""
    q, k, v = _torch(_inputs(3, 2, 256, 2, 2, 64), "float32")
    pos = torch.arange(256)
    got = flash_attention_ref(q, k, v, causal=True, window=window, max_scores=max_scores)
    chunked = chunked_attention(q, k, v, pos, pos, causal=True, window=window)
    naive = naive_attention(q, k, v, pos, pos, causal=True, window=window)
    torch.testing.assert_close(got, chunked, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got, naive, atol=2e-5, rtol=2e-5)


def test_plain_non_causal_matches_reference():
    arrays = _inputs(5, 1, 128, 1, 2, 32)
    got = flash_attention_ref(*_torch(arrays, "float32"), causal=False, window=None)
    expect = jref.attention_ref(*_jax(arrays, "float32"), causal=False, window=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


def test_cpu_wrapper_takes_plain_path_without_launching():
    q, k, v = _torch(_inputs(11, 1, 128, 2, 4, 80), "float32")
    before = dict(LAUNCHES)
    got = flash_attention(q, k, v, None, None, causal=True, window=32)
    assert LAUNCHES == before
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True, window=32),
                               atol=0, rtol=0)


@pytest.mark.parametrize("S,T", [(96, 128), (128, 160)])
def test_wrapper_raises_where_reference_asserts(S, T):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, S, 1, 1, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, T, 1, 32)).astype(np.float32))
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention(q, k, k)


def test_wrapper_rejects_mixed_dtypes_and_shapes():
    q, k, v = _torch(_inputs(1, 1, 128, 1, 2, 32), "float32")
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :16], v[..., :16])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=-1)
