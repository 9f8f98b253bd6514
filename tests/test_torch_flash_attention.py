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
from repro_torch.kernels.flash_attention import MASKED, flash_attention_ref  # noqa: E402
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


# The tensor-core kernel's arithmetic, emulated: TF32 rounding, the hi/lo
# split, the passes of each product and the online softmax over the
# kernel's key tiles (csrc/flash_attention.cu).  Each product of TF32
# values is exact in float64; a pass's sum is rounded to float32 as the
# kernel's fp32 accumulators hold it.

KEY_TILE = {32: 64, 64: 64, 80: 64, 128: 32}   # keys per K/V tile (Plan::BN)
MASKED_F32 = torch.tensor(MASKED, dtype=torch.float32)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def emulate_kernel(q, k, v, *, causal=True, window=None, passes=3):
    """The kernel's function with its arithmetic.  float32 inputs: q
    scaled, then both products as hi.lo + lo.hi + hi.hi (``passes=3``) or
    hi.hi alone (``passes=1``); bfloat16 inputs: q.k in one pass on q as
    given, the score then scaled, and P.V as P_lo.V + P_hi.V."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    f32 = q.dtype == torch.float32
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    if f32:
        (qh, ql), (kh, kl), (vh, vl) = _split(qf * scale), _split(kf), _split(vf)
    else:
        qh, kh, vh = qf, kf, vf
    q_pos = torch.arange(S)[:, None]
    m = torch.full((B, S, K, G), MASKED_F32)
    l = torch.zeros((B, S, K, G))
    acc = torch.zeros((B, S, K, G, hd))
    for t0 in range(0, T, KEY_TILE[hd]):
        sl = slice(t0, t0 + KEY_TILE[hd])

        def qk(a, b):
            return torch.einsum("bskgd,btkd->bskgt", a.double(), b[:, sl].double())

        if not f32:
            s = qk(qh, kh).float() * scale
        elif passes == 3:
            s = (qk(qh, kl) + qk(ql, kh) + qk(qh, kh)).float()
        else:
            s = qk(qh, kh).float()
        kv_pos = torch.arange(t0, t0 + s.shape[-1])[None, :]
        visible = torch.ones((S, s.shape[-1]), dtype=torch.bool)
        if causal:
            visible &= kv_pos <= q_pos
        if window is not None:
            visible &= q_pos - kv_pos < window
        s = torch.where(visible[None, :, None, None, :], s, MASKED_F32)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        ph, pl = _split(p)

        def pv(a, b):
            return torch.einsum("bskgt,btkd->bskgd", a.double(), b[:, sl].double())

        if not f32:
            o = pv(pl, vh) + pv(ph, vh)
        elif passes == 3:
            o = pv(ph, vl) + pv(pl, vh) + pv(ph, vh)
        else:
            o = pv(ph, vh)
        acc = acc * alpha[..., None] + o.float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)



def test_tf32_rounds_to_nearest_ties_away():
    """Ten mantissa bits kept; halfway cases go away from zero, others to
    the nearest TF32 value (checked against float64 arithmetic)."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 1 + 0.49 * ulp,
                      3.0 + 2.51 * 2 * ulp, 1e-3, -7.25e5], dtype=torch.float32)
    got = _tf32(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert got[0] == 1 + ulp and got[1] == -(1 + ulp) and got[2] == 1 + 2 * ulp
    assert got[3] == 1.0 and got[4] == 3.0 + 3 * 2 * ulp
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 100)
    err = (y.double() - _tf32(y).double()).abs()
    half_ulp = torch.exp2(torch.floor(torch.log2(y.double().abs())) - 11)
    assert (err <= half_ulp).all()
    hi, lo = _split(y)
    assert ((y.double() - hi.double() - lo.double()).abs() <= half_ulp * 2.0 ** -11).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,bq,bkv", [
    (1, 128, 1, 1, 64, 64, 64),
    (2, 256, 2, 2, 64, 128, 128),
    (1, 256, 4, 1, 128, 64, 128),
    (2, 128, 1, 4, 32, 32, 64),
    (1, 256, 2, 4, 80, 128, 128),     # danube's head_dim and group
])
def test_kernel_arithmetic_matches_reference_and_pallas(B, S, K, G, hd, bq, bkv, dtype):
    """3xTF32 (bf16: one and two passes) over the kernel's key tiles holds
    the reference's tolerances against the plain version and the Pallas
    kernel in interpret mode."""
    arrays = _inputs(B * S + hd, B, S, K, G, hd)
    got = emulate_kernel(*_torch(arrays, dtype), causal=True, window=None)
    plain = flash_attention_ref(*_torch(arrays, dtype), causal=True, window=None)
    jq, jk, jv = _jax(arrays, dtype)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=None,
                                    block_q=bq, block_kv=bkv, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(plain), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,G", [
    (True, 100, 3),      # G = 3: 21 positions a block, 63 live rows
    (True, 0, 2),        # every key masked: the reference's uniform weights
    (False, None, 2),
    (True, 64, 4),
])
def test_kernel_arithmetic_windows_at_hd80(causal, window, G, dtype):
    arrays = _inputs(17 + G, 1, 256, 2, G, 80)
    got = emulate_kernel(*_torch(arrays, dtype), causal=causal, window=window)
    plain = flash_attention_ref(*_torch(arrays, dtype), causal=causal, window=window)
    expect = jref.attention_ref(*_jax(arrays, dtype), causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(plain), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)
    if causal and window is not None and window > 0:
        jq, jk, jv = _jax(arrays, dtype)
        pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                        block_q=128, block_kv=128, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


def test_single_tf32_pass_misses_float32_tolerance_at_hd80():
    """Why the kernel takes three passes: one TF32 pass per product (about
    three decimal digits) lands well outside 2e-5 at danube's head_dim,
    while hi.lo + lo.hi + hi.hi lands well inside."""
    q, k, v = _torch(_inputs(23, 1, 256, 2, 4, 80), "float32")
    plain = flash_attention_ref(q, k, v, causal=True, window=None)
    one = float((emulate_kernel(q, k, v, passes=1) - plain).abs().max())
    three = float((emulate_kernel(q, k, v, passes=3) - plain).abs().max())
    assert one > 10 * TOL["float32"], one
    assert three < TOL["float32"] / 4, three
