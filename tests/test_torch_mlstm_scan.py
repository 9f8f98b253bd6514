"""The port's mLSTM scan (K4) on the CPU: its plain chunked version
against the JAX package's sequential definition, the Pallas kernel in
interpret mode and the reference's chunked path; the pinned fault of the
reference's chunked path; the wrapper's dispatch and preconditions.

Tolerances: atol 2e-4 / rtol 2e-3 against the sequential definition (the
reference's K4 sweep, tests/test_kernels.py); 1e-4 against the Pallas
kernel (float32 sums in another order and chunk); 1e-5 against the
reference's chunked path, which runs the same algorithm.  Inputs come
from numpy seeds; the gates are log-sigmoids of normal draws, the forget
gate biased by +2 as the reference's tests do, or unbiased as the
model's initialisation gives them."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan_pallas  # noqa: E402
from repro.models.ssm import mlstm_chunked_ref as j_chunked  # noqa: E402
from repro_torch.kernels import LAUNCHES, mlstm_scan  # noqa: E402
from repro_torch.kernels.mlstm_scan import (  # noqa: E402
    mlstm_chunked_ref,
    mlstm_scan_cuda,
    mlstm_scan_ref,
)


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def _inputs(seed, B, S, H, hd, forget_bias=2.0):
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    li = _log_sigmoid(rng.standard_normal((B, S, H)))
    lf = _log_sigmoid(rng.standard_normal((B, S, H)) + forget_bias)
    return [a.astype(np.float32) for a in (q, k, v, li, lf)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 128, 2, 32, 32),       # the reference's three kernel shapes
    (2, 256, 2, 64, 64),
    (1, 256, 4, 32, 128),
    (1, 256, 2, 128, 128),     # reduced xlstm-350m's head dim
    (1, 256, 1, 512, 128),     # xlstm-350m's head dim
])
def test_plain_matches_sequential_reference(B, S, H, hd, chunk):
    arrays = _inputs(B * S + hd, B, S, H, hd)
    got = mlstm_scan(*_torch(arrays), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    expect = np.asarray(jref.mlstm_scan_ref(*_jax(arrays)))
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 128, 2, 32, 32),
    (2, 256, 2, 64, 64),
    (1, 256, 4, 32, 128),
])
def test_plain_matches_pallas_interpret(B, S, H, hd, chunk):
    arrays = _inputs(7 + S + hd, B, S, H, hd)
    got = mlstm_scan(*_torch(arrays), chunk=chunk)
    expect = np.asarray(mlstm_scan_pallas(*_jax(arrays), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(256, 64), (256, 128), (96, 128), (100, 64)])
def test_plain_matches_reference_chunked_path_and_state(S, chunk):
    """Biased forget gates, where the reference's chunked path is finite:
    the same algorithm, the final state included (S=96 and 100 lower the
    chunk until it divides S, as the reference does)."""
    arrays = _inputs(S + chunk, 2, S, 2, 32)
    h, state = mlstm_chunked_ref(*_torch(arrays), chunk=chunk, return_state=True)
    jh, jstate = j_chunked(*_jax(arrays), chunk=chunk, return_state=True)
    assert np.isfinite(np.asarray(jh)).all()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mlstm_scan_ref(*_torch(arrays)).numpy(),
                               np.asarray(jref.mlstm_scan_ref(*_jax(arrays))),
                               atol=1e-5, rtol=1e-5)


def test_reference_chunked_path_is_nan_where_port_is_finite():
    """The pinned fault of the reference: unbiased forget gates at chunk
    128 push the unmasked intra-chunk exponent past float32's exp limit,
    and the reference's ``exp(...) * causal`` gives ``inf * 0 = NaN``.
    The port masks before exp: finite and equal to the sequential
    definition.  The Pallas kernel masks the same way and is finite too."""
    arrays = _inputs(11, 1, 256, 2, 32, forget_bias=0.0)
    jh = np.asarray(j_chunked(*_jax(arrays), chunk=128))
    assert np.isnan(jh).any()
    got = mlstm_chunked_ref(*_torch(arrays), chunk=128)
    assert bool(torch.isfinite(got).all())
    expect = np.asarray(jref.mlstm_scan_ref(*_jax(arrays)))
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-4, rtol=2e-3)
    pallas = np.asarray(mlstm_scan_pallas(*_jax(arrays), chunk=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)


def test_plain_bfloat16_inputs_compute_in_float32():
    arrays = _inputs(3, 2, 128, 2, 64)
    q, k, v, li, lf = _torch(arrays)
    got = mlstm_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), li, lf, chunk=64)
    assert got.dtype == torch.bfloat16
    expect = mlstm_scan_ref(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(),
                            li, lf)
    np.testing.assert_allclose(got.float().numpy(), expect.numpy(), atol=2e-2, rtol=2e-2)


def test_wrapper_routes_cpu_to_plain_version_without_a_launch():
    arrays = _torch(_inputs(5, 1, 128, 2, 32))
    before = dict(LAUNCHES)
    got = mlstm_scan(*arrays, chunk=64)
    assert LAUNCHES == before
    assert torch.equal(got, mlstm_chunked_ref(*arrays, chunk=64))


def test_wrapper_checks_inputs():
    q, k, v, li, lf = _torch(_inputs(6, 1, 96, 2, 32))
    with pytest.raises(ValueError, match="multiple of chunk"):
        mlstm_scan(q, k, v, li, lf, chunk=64)
    with pytest.raises(ValueError, match=r"\[B,S,H,hd\]"):
        mlstm_scan(q[0], k[0], v[0], li, lf, chunk=32)
    with pytest.raises(ValueError, match=r"\[B,S,H\]"):
        mlstm_scan(q, k, v, li[:, :, :1], lf, chunk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mlstm_scan(q.half(), k.half(), v.half(), li, lf, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan_cuda(q, k, v, li, lf)
