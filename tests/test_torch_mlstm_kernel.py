"""The tensor-core mLSTM scan's arithmetic (K4, csrc/mlstm_scan.cu),
emulated on the CPU: the gated-score pass, the chunk-state pass and its
float32 state scratch, the output pass, TF32 rounding with ties away from
zero and the passes of each product for float32 and bfloat16 inputs.  The
emulation is held against the JAX package's Pallas kernel in interpret
mode, its sequential definition and the port's chunked plain version
(atol 2e-4 / rtol 2e-3, the reference's K4 tolerance, tests/test_kernels.py),
and its state scratch against the states the plain version reaches chunk
by chunk.

Each product of TF32 values is exact in float64; a 32-deep slice's passes
are summed and rounded to float32 as the kernel's fresh fp32 accumulator
holds them, and the slices are summed in float32 as the kernel's
registers do.  Inputs come from
numpy seeds; the forget gate is biased by +2 (the reference's tests) or
unbiased (the model's initialisation)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan_pallas  # noqa: E402
from repro_torch.kernels.mlstm_scan import (  # noqa: E402
    KERNEL_CHUNK,
    mlstm_chunked_ref,
    mlstm_scan_ref,
    scratch_shapes,
)

ATOL, RTOL = 2e-4, 2e-3
C = KERNEL_CHUNK
SLICE = 32   # depth of one fresh accumulator (csrc/mlstm_scan.cu kSlice)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, a_split, b_split, one_pass=False):
    """``a @ b^T`` over their last axis, as the kernel computes it: in
    32-deep slices, each into a fresh accumulator in the kernel's passes
    (split operands as hi/lo; a_hi.b_lo + a_lo.b_hi + a_hi.b_hi when both
    are split, x.y_lo + x.y_hi when one is, one pass when neither; with
    ``one_pass`` only hi.hi), exact in float64 and rounded to float32, and
    the slices summed in float32."""
    ah, al = _split(a) if a_split else (a, None)
    bh, bl = _split(b) if b_split else (b, None)
    total = None
    for d0 in range(0, a.shape[-1], SLICE):
        sl = slice(d0, d0 + SLICE)

        def mm(x, y):
            return x[..., sl].double() @ y[..., sl].double().transpose(-1, -2)

        part = mm(ah, bh)
        if not one_pass:
            if b_split:
                part = part + mm(ah, bl)
            if a_split:
                part = part + mm(al, bh)
        total = part.float() if total is None else total + part.float()
    return total


def emulate_kernel(q, k, v, log_i, log_f, *, one_pass=False):
    """The tensor-core kernels' function with their arithmetic.  Returns
    ``h`` in q's dtype and the state scratch ``[B, H, n - 1, hd, hd]`` as
    the kernel stores it (transposed: value dim, then key dim)."""
    B, S, H, hd = q.shape
    f32 = q.dtype == torch.float32
    n = -(-S // C)
    pad = n * C - S

    def padded(x):
        x = x.float()
        return torch.cat([x, x.new_zeros((B, pad) + x.shape[2:])], 1) if pad else x

    qf, kf, vf = (padded(x).reshape(B, n, C, H, hd).permute(0, 3, 1, 2, 4) for x in (q, k, v))
    li = padded(log_i).reshape(B, n, C, H).permute(0, 3, 1, 2)          # [B, H, n, C]
    g = torch.cumsum(padded(log_f).reshape(B, n, C, H), 2).permute(0, 3, 1, 2)
    causal = torch.ones((C, C), dtype=torch.bool).tril()

    # 1. gated scores: q.k^T (three passes, one for bf16), masked before exp
    scores = _product(qf, kf, f32, f32, one_pass)                          # [B, H, n, c, t]
    rel = g[..., :, None] - g[..., None, :] + li[..., None, :]
    scores = scores * torch.exp(torch.where(causal, rel, float("-inf")))

    # 2. chunk states: S^T <- e^{g_total} S^T, then + v^T (w k) of each
    #    32-token slice, in float32 registers
    states = torch.zeros((B, H, n - 1, hd, hd))
    st = torch.zeros((B, H, hd, hd))
    for c in range(n - 1):
        w = torch.exp(g[:, :, c, -1:] - g[:, :, c] + li[:, :, c])       # [B, H, C]
        vt = vf[:, :, c].transpose(-1, -2)                                 # [B, H, e, t]
        wkt = (kf[:, :, c] * w[..., None]).transpose(-1, -2)               # [B, H, d, t]
        st = st * torch.exp(g[:, :, c, -1])[..., None, None]
        for t0 in range(0, C, SLICE):
            sl = slice(t0, t0 + SLICE)
            st = st + _product(vt[..., sl], wkt[..., sl], f32, True, one_pass)
        states[:, :, c] = st

    # 3. output: e^{g} (q . S_{c-1}), then + P . v slice by slice, in float32
    h = torch.zeros((B, H, n, C, hd))
    for c in range(n):
        acc = torch.zeros((B, H, C, hd))
        if c > 0:
            acc = _product(qf[:, :, c], states[:, :, c - 1], f32, True, one_pass)
            acc = acc * torch.exp(g[:, :, c])[..., None]
        vt = vf[:, :, c].transpose(-1, -2)                                 # [B, H, e, t]
        for t0 in range(0, C, SLICE):
            sl = slice(t0, t0 + SLICE)
            acc = acc + _product(scores[:, :, c, :, sl], vt[..., sl], True, f32, one_pass)
        h[:, :, c] = acc
    h = h.permute(0, 2, 3, 1, 4).reshape(B, n * C, H, hd)[:, :S]
    return h.to(q.dtype), states


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def _inputs(seed, B, S, H, hd, forget_bias):
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    li = _log_sigmoid(rng.standard_normal((B, S, H)))
    lf = _log_sigmoid(rng.standard_normal((B, S, H)) + forget_bias)
    return [a.astype(np.float32) for a in (q, k, v, li, lf)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 0.49 * ulp, 1 + 1.5 * ulp],
                     dtype=torch.float32)
    got = _tf32(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert got.tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi, lo = _split(y)
    half_ulp = torch.exp2(torch.floor(torch.log2(y.double().abs())) - 11)
    assert ((y.double() - hi.double()).abs() <= half_ulp).all()
    assert ((y.double() - hi.double() - lo.double()).abs() <= half_ulp * 2.0 ** -11).all()


@pytest.mark.parametrize("forget_bias", [2.0, 0.0])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("hd", [32, 64])
def test_kernel_arithmetic_matches_pallas_and_references(hd, S, forget_bias):
    """float32: the emulation against the Pallas kernel in interpret mode,
    the sequential definition and the port's chunked plain version."""
    arrays = _inputs(S + hd + int(forget_bias), 2, S, 2, hd, forget_bias)
    got, _ = emulate_kernel(*_torch(arrays))
    assert bool(torch.isfinite(got).all())
    pallas = np.asarray(mlstm_scan_pallas(*_jax(arrays), chunk=128, interpret=True))
    seq = np.asarray(jref.mlstm_scan_ref(*_jax(arrays)))
    plain = mlstm_chunked_ref(*_torch(arrays), chunk=128).numpy()
    for expect in (pallas, seq, plain):
        np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("forget_bias", [2.0, 0.0])
@pytest.mark.parametrize("hd", [32, 64])
def test_kernel_arithmetic_bfloat16(hd, forget_bias):
    """bf16 inputs: q.k^T in one pass, every other product in two (the
    float32 operand split); against the plain version on the same bf16
    inputs at the bf16 tolerance, and against the sequential definition of
    the bf16-rounded inputs."""
    q, k, v, li, lf = _torch(_inputs(5 + hd, 1, 256, 2, hd, forget_bias))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got, _ = emulate_kernel(qb, kb, vb, li, lf)
    assert got.dtype == torch.bfloat16
    plain = mlstm_chunked_ref(qb, kb, vb, li, lf, chunk=128)
    torch.testing.assert_close(got.float(), plain.float(), atol=2e-2, rtol=2e-2)
    seq = mlstm_scan_ref(qb.float(), kb.float(), vb.float(), li, lf)
    torch.testing.assert_close(got.float(), seq, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("S,hd", [(200, 32), (300, 64), (96, 32)])
def test_kernel_arithmetic_ragged_last_chunk(S, hd):
    """S not a multiple of the kernel's 128-token chunk: the last chunk is
    padded with zeros (and 96 tokens are one short chunk, no state pass)."""
    arrays = _inputs(S, 1, S, 2, hd, 0.0)
    got, states = emulate_kernel(*_torch(arrays))
    assert states.shape[2] == -(-S // C) - 1
    seq = np.asarray(jref.mlstm_scan_ref(*_jax(arrays)))
    np.testing.assert_allclose(got.numpy(), seq, atol=ATOL, rtol=RTOL)
    plain = mlstm_chunked_ref(*_torch(arrays), chunk=S).numpy()
    np.testing.assert_allclose(got.numpy(), plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("forget_bias", [2.0, 0.0])
def test_state_scratch_matches_plain_chunk_states(forget_bias):
    """The scratch slot c is S after chunks 0..c (stored transposed): the
    state the plain version reaches on the first (c + 1) * 128 tokens."""
    B, S, H, hd = 1, 512, 2, 64
    q, k, v, li, lf = _torch(_inputs(31, B, S, H, hd, forget_bias))
    _, states = emulate_kernel(q, k, v, li, lf)
    assert tuple(states.shape) == scratch_shapes(B, S, H, hd)[0]
    for c in range(S // C - 1):
        t = (c + 1) * C
        _, state = mlstm_chunked_ref(q[:, :t], k[:, :t], v[:, :t], li[:, :t], lf[:, :t],
                                     chunk=128, return_state=True)
        torch.testing.assert_close(states[:, :, c].transpose(-1, -2), state, atol=1e-5,
                                   rtol=1e-5)


def test_three_passes_hold_float32_where_one_pass_does_not():
    """Why the products take three passes: one TF32 pass (about three
    decimal digits) lands far from the float32 plain version at
    xlstm-350m's head dim, three land far closer."""
    arrays = _inputs(41, 1, 256, 1, 512, 0.0)
    plain = mlstm_chunked_ref(*_torch(arrays), chunk=128)
    one = float((emulate_kernel(*_torch(arrays), one_pass=True)[0] - plain).abs().max())
    three = float((emulate_kernel(*_torch(arrays))[0] - plain).abs().max())
    assert three < ATOL / 4, three
    assert one > 10 * ATOL, one
