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

The same source holds three persistent recursions over such arc lists,
each one launch where the per-level path launched once a level:

* :func:`karp_cycle_time_cuda` -- all N Karp levels and the final
  min/max formula of a batch of max cycle means, one block per graph
  row (:func:`karp_cycle_time_ref` is the plain scatter loop);
* :func:`reach_from_zero_cuda` -- the rewire climb's forward and
  backward reachability from vertex 0, one block per row and direction
  (:func:`reach_from_zero_ref` is the plain hop loop);
* :func:`timing_recursion_cuda` -- all R rounds of the round-varying
  Eq. 4 recursion of a batch of Monte-Carlo chains (MATCHA pricing), one
  block per chain (:func:`timing_recursion_ref` is the plain loop: one
  gather and one ``scatter_reduce_`` a round).

All three are bit-identical to their plain versions: max is exact, the
reachability flags are 0/1, and every add, subtraction and division of
the Karp and timing kernels is done in the input type with
round-to-nearest, as torch does.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

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


class _Lib(NamedTuple):
    segment_max: Callable
    karp: Callable
    reach: Callable
    timing: Callable
    timing_max_nodes: Callable
    error_string: Callable


@functools.cache
def _library() -> _Lib:
    """The kernels' C entry points, loaded (and built) once."""
    from ._build import load_library

    lib = load_library("segment_max")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fns = {"segment_max": (lib.segment_max_launch,
                           [ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]),
           "karp": (lib.karp_cycle_time_launch,
                    [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]),
           "reach": (lib.reach_launch, [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]),
           "timing": (lib.timing_recursion_launch,
                      [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ctypes.c_int,
                       ptr])}
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.timing_recursion_max_nodes.argtypes = [ctypes.c_int]
    lib.timing_recursion_max_nodes.restype = i64
    lib.segment_max_error_string.argtypes = [ctypes.c_int]
    lib.segment_max_error_string.restype = ctypes.c_char_p
    return _Lib(*(fn for fn, _ in fns.values()), lib.timing_recursion_max_nodes,
                lib.segment_max_error_string)


def _device_of(t: torch.Tensor):
    """Make ``t``'s card the current device for a launch, when it is not."""
    if t.device.index is None or t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _raise_on(err: int, what: str, lib: _Lib) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


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
    with _device_of(vals):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.segment_max(vals.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
                              B, E, S, _DTYPE_CODES[vals.dtype], stream)
    _raise_on(err, "segment_max", lib)
    return out


# ---------------------------------------------------------------------------
# Karp's max cycle mean


def check_karp_inputs(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                      num_nodes: int) -> None:
    """Types and shapes of a Karp score, and, for tensors off the card,
    ids in ``[0, N)`` (on the card an out-of-range id stops the kernel,
    which surfaces as a CUDA error at the next synchronise)."""
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"karp_cycle_time needs float32/float64/float16/bfloat16 weights, "
                        f"got {w.dtype}")
    _check_int_ids("karp_cycle_time", src=src, dst=dst)
    if w.dim() != 2 or src.shape != w.shape or dst.shape != w.shape:
        raise ValueError(f"src, dst and w must all be [B, E]; got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)} and {tuple(w.shape)}")
    N = int(num_nodes)
    if N < 1:
        raise ValueError(f"num_nodes must be >= 1, got {N}")
    _check_ids_on_host(N, src, dst)


def _check_int_ids(what: str, **ids: torch.Tensor) -> None:
    for name, t in ids.items():
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{what}: {name} must hold integer ids, got {t.dtype}")


def _check_ids_on_host(N: int, *ids: torch.Tensor) -> None:
    for t in ids:
        if not t.is_cuda and t.numel() and not (int(t.min()) >= 0 and int(t.max()) < N):
            raise ValueError(f"ids must lie in [0, {N}); got [{int(t.min())}, {int(t.max())}]")


def karp_scatter_step(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                      num_nodes: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """One Karp level ``D_k = max over arcs of D_{k-1}[src] + w`` as a
    gather, an add and one ``scatter_reduce_`` into a ``-inf`` row."""
    B, N = w.shape[0], int(num_nodes)
    src = src.long()
    seg_ids = (torch.arange(B, device=w.device)[:, None] * N + dst.long()).ravel()

    def step(cur: torch.Tensor) -> torch.Tensor:
        vals = torch.gather(cur, 1, src) + w
        out = torch.full((B * N,), float("-inf"), dtype=w.dtype, device=w.device)
        return out.scatter_reduce_(0, seg_ids, vals.ravel(), "amax").view(B, N)

    return step


def karp_from_step(step: Callable[[torch.Tensor], torch.Tensor], B: int, N: int,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Karp's max cycle means from N applications of ``step`` to ``D_0 = 0``:
    ``max_v min_k (D_N - D_k) / (N - k)``, a NaN ratio read as ``+inf``
    and a node with ``D_N = -inf`` as ``-inf``."""
    D0 = torch.zeros((B, N), dtype=dtype, device=device)
    levels = []
    cur = D0
    for _ in range(N):  # D_1 .. D_N
        cur = step(cur)
        levels.append(cur)
    Dn = levels[-1]
    allk = torch.stack([D0] + levels[:-1])  # D_0 .. D_{N-1}
    denom = (N - torch.arange(N, device=device)).to(dtype)
    ratios = (Dn[None, :, :] - allk) / denom[:, None, None]
    ratios = torch.where(torch.isnan(ratios), torch.inf, ratios)
    mins = ratios.amin(dim=0)
    mins = torch.where(torch.isneginf(Dn), float("-inf"), mins)
    return mins.amax(dim=1)


def karp_cycle_time_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                        num_nodes: int) -> torch.Tensor:
    """``[B]`` max cycle means of ``[B, E]`` arc lists (``-inf`` weights
    are absent arcs; ``-inf`` for an acyclic row) in plain PyTorch: N
    scatter levels, then the final formula."""
    check_karp_inputs(src, dst, w, num_nodes)
    N = int(num_nodes)
    return karp_from_step(karp_scatter_step(src, dst, w, N), w.shape[0], N, w.dtype, w.device)


def karp_cycle_time_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """One persistent launch for a batch of Karp scores, on PyTorch's
    current stream.  Takes contiguous int32 ``src``/``dst`` and ``w`` of
    one float dtype, ``[B, E]``, on one card; returns ``[B]`` in ``w``'s
    dtype, bit-identical to :func:`karp_cycle_time_ref`.  Raises if the
    launch fails."""
    check_karp_inputs(src, dst, w, num_nodes)
    if not (w.is_cuda and src.device == w.device and dst.device == w.device):
        raise ValueError(f"karp_cycle_time_cuda needs CUDA tensors on one device, got "
                         f"{src.device}, {dst.device} and {w.device}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32 or not (
            src.is_contiguous() and dst.is_contiguous() and w.is_contiguous()):
        raise ValueError("karp_cycle_time_cuda needs contiguous int32 ids and weights")
    B, E = w.shape
    N = int(num_nodes)
    out = torch.empty((B,), dtype=w.dtype, device=w.device)
    levels = torch.empty((B, N, N), dtype=w.dtype, device=w.device)  # L2-resident scratch
    lib = _library()
    with _device_of(w):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.karp(src.data_ptr(), dst.data_ptr(), w.data_ptr(), levels.data_ptr(),
                       out.data_ptr(), B, E, N, _DTYPE_CODES[w.dtype], stream)
    _raise_on(err, "karp_cycle_time", lib)
    return out


# ---------------------------------------------------------------------------
# Reachability from vertex 0, forward and backward


def check_reach_inputs(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                       num_nodes: int) -> None:
    """Types and shapes of a reachability call, and, for tensors off the
    card, ids in ``[0, N)``."""
    if present.dtype != torch.bool:
        raise TypeError(f"reach_from_zero: present must be bool, got {present.dtype}")
    _check_int_ids("reach_from_zero", src=src, dst=dst)
    if present.dim() != 2 or src.shape != present.shape or dst.shape != present.shape:
        raise ValueError(f"src, dst and present must all be [B, E]; got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)} and {tuple(present.shape)}")
    N = int(num_nodes)
    if N < 1:
        raise ValueError(f"num_nodes must be >= 1, got {N}")
    _check_ids_on_host(N, src, dst)


def reach_from_zero_ref(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                        num_nodes: int) -> torch.Tensor:
    """``[2, B, N]`` bool: the vertices reachable from vertex 0 along
    present arcs ``src -> dst`` (row 0) and ``dst -> src`` (row 1), by
    N - 1 synchronous hops of gather, multiply and ``scatter_reduce_``."""
    check_reach_inputs(src, dst, present, num_nodes)
    B, n = present.shape[0], int(num_nodes)
    dev = present.device
    boff = torch.arange(B, device=dev)[:, None] * n
    pf = present.to(torch.float32)

    def reach(take_idx, seg):
        r = torch.zeros((B, n), dtype=torch.float32, device=dev)
        r[:, 0] = 1.0
        for _ in range(max(n - 1, 0)):
            vals = torch.gather(r, 1, take_idx) * pf
            hop = torch.zeros(B * n, dtype=torch.float32, device=dev)
            hop.scatter_reduce_(0, seg, vals.ravel(), "amax")
            r = torch.maximum(r, hop.view(B, n))
        return r > 0

    src, dst = src.long(), dst.long()
    return torch.stack([reach(src, (boff + dst).ravel()), reach(dst, (boff + src).ravel())])


def reach_from_zero_cuda(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """One launch for both directions, on PyTorch's current stream.  Takes
    contiguous int32 ``src``/``dst`` and bool ``present``, ``[B, E]``, on
    one card; returns ``[2, B, N]`` bool, equal to :func:`reach_from_zero_ref`.
    Raises if the launch fails."""
    check_reach_inputs(src, dst, present, num_nodes)
    if not (present.is_cuda and src.device == present.device and dst.device == present.device):
        raise ValueError(f"reach_from_zero_cuda needs CUDA tensors on one device, got "
                         f"{src.device}, {dst.device} and {present.device}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32 or not (
            src.is_contiguous() and dst.is_contiguous() and present.is_contiguous()):
        raise ValueError("reach_from_zero_cuda needs contiguous int32 ids and mask")
    B, E = present.shape
    N = int(num_nodes)
    out = torch.empty((2, B, N), dtype=torch.bool, device=present.device)
    lib = _library()
    with _device_of(present):
        stream = torch.cuda.current_stream(present.device).cuda_stream
        err = lib.reach(src.data_ptr(), dst.data_ptr(), present.data_ptr(), out.data_ptr(),
                        B, E, N, stream)
    _raise_on(err, "reach", lib)
    return out


# ---------------------------------------------------------------------------
# The round-varying Eq. 4 timing recursion (MATCHA pricing)

_TIMING_DTYPES = (torch.float32, torch.float64)


def check_timing_inputs(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                        round_ids: torch.Tensor, num_nodes: int,
                        t0: Optional[torch.Tensor] = None) -> None:
    """Types and shapes of a timing recursion, and, for tensors off the
    card, arc ids in ``[0, N)`` and round ids in ``[0, U)`` (on the card
    an out-of-range id stops the kernel, which surfaces as a CUDA error
    at the next synchronise)."""
    if w_unique.dtype not in _TIMING_DTYPES:
        raise TypeError(f"timing_recursion needs float32/float64 weights, got {w_unique.dtype}")
    _check_int_ids("timing_recursion", src=src, dst=dst, round_ids=round_ids)
    if src.dim() != 1 or dst.shape != src.shape:
        raise ValueError(f"src and dst must both be [E]; got {tuple(src.shape)} and "
                         f"{tuple(dst.shape)}")
    if src.shape[0] == 0:
        raise ValueError("timing_recursion needs at least one arc (E = 0)")
    if w_unique.dim() != 2 or w_unique.shape[1] != src.shape[0]:
        raise ValueError(f"w_unique must be [U, E] with E = {src.shape[0]}; got "
                         f"{tuple(w_unique.shape)}")
    if round_ids.dim() != 2:
        raise ValueError(f"round_ids must be [C, R], got {tuple(round_ids.shape)}")
    N = int(num_nodes)
    if N < 1:
        raise ValueError(f"num_nodes must be >= 1, got {N}")
    if t0 is not None and tuple(t0.shape) != (round_ids.shape[0], N):
        raise ValueError(f"t0 must be [C, N] = {(round_ids.shape[0], N)}, got {tuple(t0.shape)}")
    _check_ids_on_host(N, src, dst)
    _check_ids_on_host(w_unique.shape[0], round_ids)


def timing_recursion_ref(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                         round_ids: torch.Tensor, num_nodes: int,
                         t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unique-rounds Eq. 4 recursion in plain PyTorch: ``[C, R+1, N]``
    start times with ``t(k+1)[c, v] = max( max over arcs (u -> v) of
    t(k)[c, u] + w_unique[round_ids[c, k], e], carry )``, where the carry
    is ``t(k)[c, v]`` when row ``round_ids[c, k]`` has no present
    self-loop at v and ``-inf`` otherwise.  A round is one gather of the
    sources and one ``scatter_reduce_`` (``amax``) into a row seeded with
    the carry; the per-row self-loop flags are computed once.  Computes
    in ``w_unique``'s dtype (``t0``, default zeros, is cast to it)."""
    check_timing_inputs(src, dst, w_unique, round_ids, num_nodes, t0)
    N = int(num_nodes)
    dev, dt = w_unique.device, w_unique.dtype
    src, dst = src.to(dev).long(), dst.to(dev).long()
    ids = round_ids.to(dev).long()
    C, R = ids.shape
    U = w_unique.shape[0]
    self_arc = src == dst
    present = (w_unique[:, self_arc] > float("-inf")).to(dt)
    has_self = torch.zeros((U, N), dtype=dt, device=dev)
    has_self.scatter_reduce_(1, src[self_arc].expand(U, -1), present, "amax")
    has_self = has_self > 0
    seg = (torch.arange(C, device=dev)[:, None] * N + dst[None, :]).ravel()
    t = (torch.zeros((C, N), dtype=dt, device=dev) if t0 is None
         else t0.to(device=dev, dtype=dt))
    out = torch.empty((C, R + 1, N), dtype=dt, device=dev)
    out[:, 0] = t
    for k in range(R):
        ids_k = ids[:, k]
        vals = t[:, src] + w_unique[ids_k]
        nxt = torch.where(has_self[ids_k], float("-inf"), t).view(-1)
        t = nxt.scatter_reduce_(0, seg, vals.view(-1), "amax").view(C, N)
        out[:, k + 1] = t
    return out


def timing_recursion_cuda(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                          round_ids: torch.Tensor, num_nodes: int,
                          t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One persistent launch for every round of every chain, on PyTorch's
    current stream.  Takes contiguous int32 ``src``/``dst`` ``[E]`` and
    ``round_ids`` ``[C, R]``, ``w_unique`` ``[U, E]`` (float32 or
    float64) and an optional ``t0`` ``[C, N]`` of its dtype, on one card;
    returns ``[C, R+1, N]`` in ``w_unique``'s dtype, bit-identical to
    :func:`timing_recursion_ref`.  Raises if N is past what the card's
    shared memory holds, or if the launch fails."""
    check_timing_inputs(src, dst, w_unique, round_ids, num_nodes, t0)
    tensors = (src, dst, w_unique, round_ids) + (() if t0 is None else (t0,))
    if not all(t.is_cuda and t.device == w_unique.device for t in tensors):
        raise ValueError(f"timing_recursion_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not (src.dtype == dst.dtype == round_ids.dtype == torch.int32
            and all(t.is_contiguous() for t in tensors)):
        raise ValueError("timing_recursion_cuda needs contiguous int32 ids and weights")
    if t0 is not None and t0.dtype != w_unique.dtype:
        raise TypeError(f"t0 must have the weights' dtype {w_unique.dtype}, got {t0.dtype}")
    (U, E), (C, R) = w_unique.shape, round_ids.shape
    N = int(num_nodes)
    code = _DTYPE_CODES[w_unique.dtype]
    lib = _library()
    with _device_of(w_unique):
        limit = int(lib.timing_max_nodes(code))
        if N > limit:
            raise ValueError(f"timing_recursion: N = {N} nodes do not fit the card's shared "
                             f"memory; the limit for {w_unique.dtype} is {limit} nodes")
        out = torch.empty((C, R + 1, N), dtype=w_unique.dtype, device=w_unique.device)
        stream = torch.cuda.current_stream(w_unique.device).cuda_stream
        err = lib.timing(src.data_ptr(), dst.data_ptr(), w_unique.data_ptr(),
                         round_ids.data_ptr(), None if t0 is None else t0.data_ptr(),
                         out.data_ptr(), C, R, U, E, N, code, stream)
    _raise_on(err, "timing_recursion", lib)
    return out
