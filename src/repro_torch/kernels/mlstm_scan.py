"""The mLSTM / gated linear-attention scan: the hand-written CUDA kernel
and its plain versions.

For q, k, v ``[B, S, H, hd]`` and log-gates ``log_i``, ``log_f``
``[B, S, H]``, every head carries a ``[hd, hd]`` state

    S_t = f_t S_{t-1} + i_t k_t v_t^T ;   h_t = q_t . S_t

(``f = exp(log_f)``, ``i = exp(log_i)``, ``S_0 = 0``), in float32, and
the output ``h`` is cast to q's dtype.

* :func:`mlstm_scan_ref` is the per-token definition, the counterpart of
  ``repro.kernels.ref.mlstm_scan_ref``; the tests use it.
* :func:`mlstm_chunked_ref` is the chunkwise-parallel form, the
  counterpart of ``repro.models.ssm.mlstm_chunked_ref``: the CPU path of
  the wrapper, the model's prefill and non-kernel forward, and what the
  kernel is held against on the card.  It follows the reference's
  algorithm (chunk ``C = min(chunk, S)``, lowered until it divides S;
  ``g`` the in-chunk cumulative sum of ``log_f``; the inter-chunk term
  ``(q e^g) . S``; the state update ``e^{g_total} S + (k e^{g_total - g +
  li})^T v``) with one deliberate difference: the intra-chunk gate
  ``exp(g[c] - g[t] + li[t])`` is masked to the causal triangle *before*
  ``exp``, as the Pallas kernel does (``jnp.where(rows >= cols, exp(rel),
  0)``), where the reference's chunked path multiplies ``exp`` by the
  causal matrix afterwards.  Above the diagonal ``g[c] - g[t]`` is a sum
  of up to ``C - 1`` terms ``-log_f``; with unbiased forget gates and
  ``C = 128`` it passes float32's ``exp`` limit (about 88.7), and the
  reference's ``inf * 0`` gives NaN.  Where the reference is finite the
  two are the same function (the masked product is ``att * gate * 1``);
  where it is NaN, this one is finite and equals the per-token
  definition (tests/test_torch_mlstm_scan.py pins both).
* :func:`mlstm_scan_cuda` launches ``csrc/mlstm_scan.cu`` (K4), which
  replaces the Pallas TPU kernel
  ``src/repro/kernels/mlstm_scan.py::mlstm_scan_pallas``: three
  tensor-core kernels (3xTF32 ``wgmma``) at chunks of
  :data:`KERNEL_CHUNK` tokens, the gated scores, the chunk states and
  the output, through two float32 scratches the wrapper allocates
  (:func:`scratch_shapes`); or, with ``simt=True``, the earlier
  CUDA-core kernel of the same source, kept for timing.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512     # the CUDA-core kernel keeps an [hd, 32] float32 state slice in shared memory
KERNEL_CHUNK = 128     # tokens per chunk of the tensor-core kernels


def mlstm_scan_ref(q, k, v, log_i, log_f) -> torch.Tensor:
    """Per-token sequential recurrence (the mathematical definition)."""
    B, S, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    i_g, f_g = torch.exp(log_i.float()), torch.exp(log_f.float())
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        state = (f_g[:, t, :, None, None] * state
                 + i_g[:, t, :, None, None] * torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t]))
        hs.append(torch.einsum("bhd,bhde->bhe", qf[:, t], state))
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_chunked_ref(q, k, v, log_i, log_f, *, chunk: int = 128,
                      return_state: bool = False):
    """Chunkwise-parallel gated linear attention in float32 (module
    docstring).  Returns ``h`` in q's dtype, and with ``return_state``
    also the final ``[B, H, hd, hd]`` float32 state."""
    B, S, H, hd = q.shape
    C = min(chunk, S)
    while S % C:
        C -= 1
    n = S // C
    qf = q.float().reshape(B, n, C, H, hd)
    kf = k.float().reshape(B, n, C, H, hd)
    vf = v.float().reshape(B, n, C, H, hd)
    li = log_i.float().reshape(B, n, C, H)
    g = torch.cumsum(log_f.float().reshape(B, n, C, H), dim=2)  # g[c] = sum_{t<=c} lf[t]
    g_total = g[:, :, -1]                                        # [B, n, H]
    causal = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
    hs = []
    for c in range(n):
        qc, kc, vc, gc, lic, gt = qf[:, c], kf[:, c], vf[:, c], g[:, c], li[:, c], g_total[:, c]
        h_inter = torch.einsum("bchd,bhde->bche", qc * torch.exp(gc)[..., None], state)
        att = torch.einsum("bchd,bthd->bhct", qc, kc)
        rel = (gc[:, :, None, :] - gc[:, None, :, :]).permute(0, 3, 1, 2)  # [B, H, c, t]
        rel = rel + lic.permute(0, 2, 1)[:, :, None, :]
        att = att * torch.exp(torch.where(causal, rel, float("-inf")))     # masked before exp
        h_intra = torch.einsum("bhct,bthd->bchd", att, vc)
        k_dec = kc * torch.exp(gt[:, None, :] - gc + lic)[..., None]
        state = (torch.exp(gt)[..., None, None] * state
                 + torch.einsum("bthd,bthe->bhde", k_dec, vc))
        hs.append(h_inter + h_intra)
    h = torch.stack(hs, dim=1).reshape(B, S, H, hd).to(q.dtype)
    return (h, state) if return_state else h


def check_inputs(q, k, v, log_i, log_f, chunk: int) -> None:
    """The reference's preconditions (``S % chunk == 0``, the Pallas
    kernel's block) and the shapes, dtypes and devices both paths take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k, v [B,S,H,hd] of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"need log_i, log_f [B,S,H] = {tuple(q.shape[:3])}; got "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}")
    S = q.shape[1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"mlstm_scan needs S a multiple of chunk, got S={S}, chunk={chunk}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype of float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (log_i.is_floating_point() and log_f.is_floating_point()):
        raise TypeError(f"log gates must be floating point, got {log_i.dtype}, {log_f.dtype}")
    if any(t.device != q.device for t in (k, v, log_i, log_f)):
        raise ValueError("q, k, v and the log gates must lie on one device")


def scratch_shapes(B: int, S: int, H: int, hd: int) -> tuple:
    """Shapes of the tensor-core kernels' two float32 scratches: the state
    after each chunk but the last, stored transposed (``[B, H, n - 1, hd,
    hd]``), and the gated scores of each chunk (``[B, H, n, C, C]``), for
    ``n = ceil(S / C)`` chunks of ``C = KERNEL_CHUNK`` tokens."""
    n = -(-S // KERNEL_CHUNK)
    return (B, H, n - 1, hd, hd), (B, H, n, KERNEL_CHUNK, KERNEL_CHUNK)


def device_kernels_per_call(S: int) -> int:
    """Device kernels one tensor-core call launches: the scores, the chunk
    states (only when there is more than one chunk) and the output."""
    return 3 if S > KERNEL_CHUNK else 2


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("mlstm_scan")
    fn = lib.mlstm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mlstm_scan_simt_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlstm_scan_error_string.argtypes = [ctypes.c_int]
    lib.mlstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def mlstm_scan_cuda(q, k, v, log_i, log_f, *, simt: bool = False) -> torch.Tensor:
    """Launch the CUDA kernels on PyTorch's current stream: the tensor-core
    kernels, or with ``simt`` the earlier CUDA-core one.  The gates go in
    as contiguous float32; the scratches are allocated here (an
    allocation that fails raises).  Checks device, dtype, shape and
    contiguity, and raises if a launch fails.  The tensor-core kernels read
    16-byte vectors, so an input whose storage starts off that alignment is
    copied first."""
    if not q.is_cuda:
        raise ValueError(f"mlstm_scan_cuda needs CUDA tensors, got {q.device}")
    check_inputs(q, k, v, log_i, log_f, 1)
    B, S, H, hd = q.shape
    if hd % 32 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not supported by the kernel "
                         f"(a multiple of 32 up to {MAX_HEAD_DIM})")
    if B * H > 65535:
        raise ValueError(f"batch {B} x heads {H} above the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    li = log_i.to(torch.float32).contiguous()
    lf = log_f.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _DTYPE_CODES[q.dtype]
        if simt:
            err = lib.mlstm_scan_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(), lf.data_ptr(),
                out.data_ptr(), B, S, H, hd, code, stream)
        else:
            q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
            states_shape, scores_shape = scratch_shapes(B, S, H, hd)
            states = torch.empty(states_shape, dtype=torch.float32, device=q.device)
            scores = torch.empty(scores_shape, dtype=torch.float32, device=q.device)
            err = lib.mlstm_scan_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(), lf.data_ptr(),
                out.data_ptr(), states.data_ptr(), scores.data_ptr(), B, S, H, hd, code, stream)
    if err != 0:
        msg = lib.mlstm_scan_error_string(err).decode()
        raise RuntimeError(f"mlstm_scan kernel launch failed: {msg} (cudaError {err})")
    return out
