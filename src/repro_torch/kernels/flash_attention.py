"""Forward flash attention (GQA, causal, sliding window): the hand-written
CUDA kernel and its plain version.

For q ``[B, S, K, G, hd]`` and k, v ``[B, T, K, hd]`` with positions
``0..S-1`` and ``0..T-1``, the scores ``(q * hd^-0.5) . k`` (q scaled in
float32 first) are masked to ``-1e30`` where the key lies after the query
(causal) or ``q_pos - kv_pos >= window``, soft-maxed over the keys in
float32, and applied to v; the result is cast to q's dtype.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``src/repro/kernels/flash_attention.py::flash_attention_pallas``:
an online softmax over key tiles that a producer warp copies into shared
memory while a warpgroup runs both products on the tensor cores (``wgmma``
in TF32).  Each float32 operand is split into a TF32 high part and a TF32
low part and a product is ``hi*hi + hi*lo + lo*hi`` (3xTF32), which keeps
the float32 tolerance; a bfloat16 operand is exact in TF32 and needs no
low part.  The same source keeps the earlier kernel, whose products are
fp32 FMAs on the CUDA cores (``simt=True``), to be timed beside it.
:func:`flash_attention_ref` is the counterpart of
``repro.kernels.ref.attention_ref`` in plain PyTorch, looping over query
chunks so that a long prefill's scores fit in memory: the CPU path, and
what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)   # head dims the kernel is built for
MAX_GROUP = 64                  # query heads per kv head one block holds
MASKED = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        max_scores: int = 1 << 28) -> torch.Tensor:
    """Softmax attention with causal/window masking, one query chunk at a
    time (each chunk's ``[B, c, K, G, T]`` float32 scores hold at most
    ``max_scores`` elements)."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    kv_pos = torch.arange(T, device=q.device)
    chunk = max(1, min(S, max_scores // max(1, B * K * G * T)))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for s0 in range(0, S, chunk):
        qc = q[:, s0:s0 + chunk].to(torch.float32) * scale
        q_pos = torch.arange(s0, s0 + qc.shape[1], device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", qc, kf)
        mask = torch.ones((qc.shape[1], T), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s, MASKED)
        p = torch.softmax(s, dim=-1)
        out[:, s0:s0 + chunk] = torch.einsum("bskgt,btkd->bskgd", p, vf).to(q.dtype)
    return out


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """The reference's preconditions (``S % 128 == T % 128 == 0``) and the
    shapes, dtypes and devices both paths take."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,S,K,G,hd] and k, v [B,T,K,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, K, G, hd = q.shape
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if S % 128 or k.shape[1] % 128:
        raise ValueError(f"flash attention needs S and T multiples of 128 "
                         f"(block_q = block_kv = 128), got S={S}, T={k.shape[1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype of float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("flash_attention")
    for fn in (lib.flash_attention_launch, lib.flash_attention_simt_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None, simt: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: the tensor-core
    kernel, or with ``simt`` the earlier CUDA-core one.  Checks device,
    dtype, shape and contiguity, and raises if the launch fails.  The
    kernel reads 16-byte rows, so an input whose storage starts off that
    alignment is copied first."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    check_inputs(q, k, v, window)
    B, S, K, G, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel (one of {HEAD_DIMS})")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head; the kernel holds at most {MAX_GROUP}")
    if K > 65535 or B > 65535:
        raise ValueError(f"batch {B} or kv heads {K} above the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch = lib.flash_attention_simt_launch if simt else lib.flash_attention_launch
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, k.shape[1], K, G, hd, hd ** -0.5, int(causal),
            -1 if window is None else int(window), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {err})")
    return out
