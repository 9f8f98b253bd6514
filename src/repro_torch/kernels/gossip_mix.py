"""DPASGD gossip mix: the hand-written CUDA kernel and its plain version.

After a round's Birkhoff transfers land, the K-way consensus combine is

    out[n] = sum_k  lambda_k * blocks[k, n]        (w_i <- sum_j A_ij w_j)

accumulated in float32 and cast back to the input type.  The CUDA kernel
(``csrc/gossip_mix.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gossip_mix.py::gossip_mix_pallas``; it is a
memory-bound K-stream fused multiply-add that reads every block once and
writes the output once, with several 16-byte loads in flight per row (K
fixed at compile time for the K = 2 of ring plans, a run-time row loop
otherwise).  The earlier grid-stride kernel stays in the same source for
timing (``grid_stride=True``); both give the same bits.
:func:`gossip_mix_ref` is the same arithmetic
in plain PyTorch: the CPU path, and what the kernel is held against on
the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gossip_mix_ref(neighbor_blocks: torch.Tensor, weights: torch.Tensor,
                   *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_k weights[k] * neighbor_blocks[k]`` over ``[K, N]`` blocks,
    accumulated in float32 row by row (the kernel's order) and cast to
    the blocks' dtype."""
    w = weights.to(torch.float32)
    acc = neighbor_blocks[0].to(torch.float32) * w[0]
    for k in range(1, neighbor_blocks.shape[0]):
        acc.addcmul_(w[k], neighbor_blocks[k].to(torch.float32))
    res = acc.to(neighbor_blocks.dtype)
    if out is None:
        return res
    return out.copy_(res)


def _check(neighbor_blocks: torch.Tensor, weights: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if neighbor_blocks.dim() != 2:
        raise ValueError(f"blocks must be [K, N], got {tuple(neighbor_blocks.shape)}")
    if neighbor_blocks.dtype not in _DTYPE_CODES:
        raise TypeError(f"blocks dtype {neighbor_blocks.dtype} not supported "
                        "(float32 or bfloat16)")
    if not neighbor_blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    K, N = neighbor_blocks.shape
    if K == 0:
        raise ValueError("blocks must hold at least one row")
    if weights.shape != (K,) or weights.dtype != torch.float32 \
            or weights.device != neighbor_blocks.device \
            or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous float32 [{K}] tensor "
                         f"on {neighbor_blocks.device}")
    if out is not None and (out.shape != (N,) or out.dtype != neighbor_blocks.dtype
                            or out.device != neighbor_blocks.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {neighbor_blocks.dtype} "
                         f"[{N}] tensor on {neighbor_blocks.device}")


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("gossip_mix")
    fn = lib.gossip_mix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gossip_mix_grid_stride_launch.argtypes = fn.argtypes
    lib.gossip_mix_grid_stride_launch.restype = ctypes.c_int
    lib.gossip_mix_error_string.argtypes = [ctypes.c_int]
    lib.gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def gossip_mix_cuda(neighbor_blocks: torch.Tensor, weights: torch.Tensor,
                    *, out: Optional[torch.Tensor] = None,
                    grid_stride: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: the streaming
    kernel, or with ``grid_stride`` the earlier grid-stride one (timing
    only; the same bits).  Checks device, dtype, shape and contiguity,
    and raises if the launch fails.  ``out`` (``[N]``, the blocks' dtype)
    receives the result; it must not overlap ``neighbor_blocks``."""
    if not neighbor_blocks.is_cuda:
        raise ValueError(f"gossip_mix_cuda needs CUDA tensors, got {neighbor_blocks.device}")
    _check(neighbor_blocks, weights, out)
    K, N = neighbor_blocks.shape
    if out is None:
        out = torch.empty(N, dtype=neighbor_blocks.dtype, device=neighbor_blocks.device)
    lib = _library()
    launch = lib.gossip_mix_grid_stride_launch if grid_stride else lib.gossip_mix_launch
    with torch.cuda.device(neighbor_blocks.device):
        stream = torch.cuda.current_stream(neighbor_blocks.device).cuda_stream
        err = launch(neighbor_blocks.data_ptr(), weights.data_ptr(), out.data_ptr(), K, N,
                     _DTYPE_CODES[neighbor_blocks.dtype], stream)
    if err != 0:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"gossip_mix kernel launch failed: {msg} (cudaError {err})")
    return out
