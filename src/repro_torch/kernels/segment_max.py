"""Row-wise segment max over an edge batch: the hand-written CUDA kernel,
its plain version, and the dispatch policy of the Karp recursion.

One Karp DP level over a batch of edge lists is

    nxt[b, v] = max over arcs (u -> v) of graph b of  cur[b, u] + w[b, e]

a gather, an add and a per-destination *segment max*.  The reduction is

    out[b, s] = max vals[b, e]  over e with seg_ids[b, e] == s

over ``[B, E]`` float values and int32 ids into ``[B, S]``; empty
segments give ``-inf``, ids outside ``[0, S)`` are dropped, a NaN in a
segment gives NaN, and integer dtypes are refused.  The CUDA kernel
(``csrc/segment_max.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/segment_max.py::edge_segment_max_pallas``: where the
TPU compares every edge tile with every segment tile (its VPU has no
scatter), the card keeps a row's running maxima in shared memory and
folds each edge in with one ``atomicMax`` on an order-preserving integer
encoding -- O(E) work per row instead of O(E·S).  :func:`edge_segment_max_ref`
is the same function in plain PyTorch: the CPU path, and what the kernel
is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

# dtype codes of the C interface (csrc/segment_max.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}
_HALF = (torch.float16, torch.bfloat16)
SEGMENT_MAX_IMPLS = ("scatter", "padded", "cuda")


def _check_float(vals: torch.Tensor) -> None:
    if not vals.is_floating_point():
        raise TypeError(f"edge_segment_max needs a float dtype (the -inf identity "
                        f"is float-only); got {vals.dtype}")


def edge_segment_max_ref(vals: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """``out[b, s] = max vals[b, e]`` over ``seg_ids[b, e] == s`` in plain
    PyTorch.  Out-of-range ids go to a spare column that is cut off; a
    ``-inf`` row seeds the ``scatter_reduce`` so empty segments stay
    ``-inf``.  16-bit inputs reduce in float32 (exact: max only picks)."""
    _check_float(vals)
    if vals.dim() != 2 or seg_ids.shape != vals.shape:
        raise ValueError(f"vals and seg_ids must both be [B, E]; got "
                         f"{tuple(vals.shape)} and {tuple(seg_ids.shape)}")
    S = int(num_segments)
    work = vals.float() if vals.dtype in _HALF else vals
    ids = seg_ids.long()
    ids = torch.where((ids >= 0) & (ids < S), ids, S)
    out = torch.full((vals.shape[0], S + 1), float("-inf"), dtype=work.dtype,
                     device=vals.device)
    out.scatter_reduce_(1, ids, work, "amax", include_self=True)
    # a NaN anywhere in a segment makes it NaN, as jnp.maximum does
    nans = torch.zeros_like(out).scatter_add_(1, ids, torch.isnan(work).to(work.dtype))
    out.masked_fill_(nans > 0, float("nan"))
    return out[:, :S].to(vals.dtype)


def select_segment_max_impl(kernel: str = "auto", *, padded: bool = False,
                            device: torch.device = torch.device("cpu")) -> str:
    """Resolve a segment-max implementation name for the Karp recursion.

    ======== ==========================================================
    auto     ``"cuda"`` when the tensors lie on the card; on the CPU
             ``"padded"`` when the caller supplies a static in-degree
             bound, else ``"scatter"``.
    scatter  ``Tensor.scatter_reduce_(..., "amax")`` into a ``-inf`` row.
    padded   degree-padded ``[B, N, D]`` gather + dense max (needs
             ``max_in_degree``).
    cuda     the hand-written kernel (its plain version on the CPU).
    ======== ==========================================================
    """
    if kernel != "auto":
        if kernel not in SEGMENT_MAX_IMPLS:
            raise ValueError(f"unknown segment-max impl {kernel!r}")
        return kernel
    if torch.device(device).type == "cuda":
        return "cuda"
    return "padded" if padded else "scatter"


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("segment_max")
    fn = lib.segment_max_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.segment_max_error_string.argtypes = [ctypes.c_int]
    lib.segment_max_error_string.restype = ctypes.c_char_p
    return lib


def edge_segment_max_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Takes
    contiguous ``[B, E]`` float values and int32 ids on the card and
    returns ``[B, S]`` in the values' dtype; raises if the launch fails."""
    if not (vals.is_cuda and seg_ids.is_cuda and vals.device == seg_ids.device):
        raise ValueError(f"edge_segment_max_cuda needs CUDA tensors on one device, got "
                         f"{vals.device} and {seg_ids.device}")
    _check_float(vals)
    if vals.dtype not in _DTYPE_CODES:
        raise TypeError(f"edge_segment_max_cuda: dtype {vals.dtype} not supported")
    if vals.dim() != 2 or seg_ids.shape != vals.shape:
        raise ValueError(f"vals and seg_ids must both be [B, E]; got "
                         f"{tuple(vals.shape)} and {tuple(seg_ids.shape)}")
    if seg_ids.dtype != torch.int32 or not (vals.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("edge_segment_max_cuda needs contiguous values and int32 ids")
    B, E = vals.shape
    S = int(num_segments)
    if S < 0:
        raise ValueError(f"num_segments must be >= 0, got {S}")
    out = torch.empty((B, S), dtype=vals.dtype, device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.segment_max_launch(vals.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
                                     B, E, S, _DTYPE_CODES[vals.dtype], stream)
    if err != 0:
        msg = lib.segment_max_error_string(err).decode()
        raise RuntimeError(f"segment_max kernel launch failed: {msg} (cudaError {err})")
    return out
