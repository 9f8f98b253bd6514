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
scatter), the card folds each edge into a row's running maxima with
``atomicMax`` on an order-preserving integer encoding -- O(E) work per row
instead of O(E·S).  A row is spread over a thread-block cluster of CTAs
and its maxima are held in shared memory or, past it, in the output, as
:func:`segment_max_plan` lays the call out.  :func:`edge_segment_max_ref`
is the same function in plain PyTorch: the CPU path, and what the kernel
is held against on the card.

The same source holds three persistent recursions over such arc lists,
each one launch where the per-level path launched once a level:

* :func:`karp_cycle_time_cuda` -- all N Karp levels and the final
  min/max formula of a batch of max cycle means, one block per graph
  row (:func:`karp_cycle_time_ref` is the plain scatter loop);
* :func:`reach_from_zero_cuda` -- the rewire climb's forward and
  backward reachability from vertex 0: for N <= 1024 a row and
  direction's adjacency as bitsets in shared memory and one warp a
  traversal, else a block a row and direction hopping over the arcs, as
  :func:`reach_plan` lays the call out (:func:`reach_from_zero_ref` is the
  plain hop loop);
* :func:`timing_recursion_cuda` -- all R rounds of the round-varying
  Eq. 4 recursion of a batch of Monte-Carlo chains (MATCHA pricing), one
  thread-block cluster per chain, its arcs split over the cluster's CTAs
  by :func:`timing_plan` (:func:`timing_recursion_ref` is the plain loop:
  one gather and one ``scatter_reduce_`` a round).

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

from ..analysis.contracts import contract

# dtype codes of the C interface (csrc/segment_max.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}
_HALF = (torch.float16, torch.bfloat16)
SEGMENT_MAX_IMPLS = ("scatter", "padded", "cuda")


def _check_float(vals: torch.Tensor) -> None:
    if not vals.is_floating_point():
        raise TypeError(f"edge_segment_max needs a float dtype (the -inf identity "
                        f"is float-only); got {vals.dtype}")


@contract("[B,E]", "[B,E]", "S", ret="[B,S]")
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


@contract()
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
    segment_max_plan: Callable
    segment_max_plan_of: Callable
    karp: Callable
    reach: Callable
    reach_plan: Callable
    reach_plan_of: Callable
    timing: Callable
    timing_max_nodes: Callable
    timing_smem_bytes: Callable
    smem_cap: Callable
    error_string: Callable


@functools.cache
def _library() -> _Lib:
    """The kernels' C entry points, loaded (and built) once."""
    from ._build import load_library

    lib = load_library("segment_max")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fns = {"segment_max": (lib.segment_max_launch,
                           [ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]),
           "segment_max_plan": (lib.segment_max_launch_plan,
                                [ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, i64, i64, i64, ptr]),
           "karp": (lib.karp_cycle_time_launch,
                    [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]),
           "reach": (lib.reach_launch, [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]),
           "reach_plan": (lib.reach_launch_plan, [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64,
                                                  ptr]),
           "timing": (lib.timing_recursion_launch,
                      [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i64,
                       ctypes.c_int, ctypes.c_int, ptr])}
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.segment_max_plan_of.argtypes = [i64, i64, i64, ctypes.c_int, ctypes.POINTER(i64)]
    lib.segment_max_plan_of.restype = None
    lib.reach_plan_of.argtypes = [i64, i64, ctypes.POINTER(i64)]
    lib.reach_plan_of.restype = None
    lib.timing_recursion_max_nodes.argtypes = [ctypes.c_int]
    lib.timing_recursion_max_nodes.restype = i64
    lib.timing_recursion_smem_bytes.argtypes = [i64, i64, ctypes.c_int, i64, ctypes.c_int]
    lib.timing_recursion_smem_bytes.restype = i64
    lib.smem_cap_optin.argtypes = []
    lib.smem_cap_optin.restype = i64
    lib.segment_max_error_string.argtypes = [ctypes.c_int]
    lib.segment_max_error_string.restype = ctypes.c_char_p
    fns = [fn for fn, _ in fns.values()]
    return _Lib(*fns[:2], lib.segment_max_plan_of, *fns[2:5], lib.reach_plan_of, *fns[5:],
                lib.timing_recursion_max_nodes, lib.timing_recursion_smem_bytes,
                lib.smem_cap_optin, lib.segment_max_error_string)


def _device_of(t: torch.Tensor):
    """Make ``t``'s card the current device for a launch, when it is not
    (the bare device query: a CUDA tensor exists, so CUDA is initialised)."""
    dev = t.get_device()
    if dev < 0 or dev == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _raise_on(err: int, what: str, lib: _Lib) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _stream_of(index: int) -> int:
    """The current stream of card ``index``, as the raw pointer a launch
    takes (without building a ``torch.cuda.Stream``: a few µs a call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check_segment_max_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                            num_segments: int) -> tuple:
    """The checks of a standalone segment max on the card, cheapest first;
    returns ``(card index, dtype code, S)``."""
    dev = vals.get_device()
    if dev < 0 or seg_ids.get_device() != dev:
        raise ValueError(f"edge_segment_max_cuda needs CUDA tensors on one device, got "
                         f"{vals.device} and {seg_ids.device}")
    code = _DTYPE_CODES.get(vals.dtype)
    if code is None:
        _check_float(vals)
        raise TypeError(f"edge_segment_max_cuda: dtype {vals.dtype} not supported")
    shape = vals.shape
    if len(shape) != 2 or seg_ids.shape != shape:
        raise ValueError(f"vals and seg_ids must both be [B, E]; got "
                         f"{tuple(shape)} and {tuple(seg_ids.shape)}")
    if seg_ids.dtype is not torch.int32 or not (vals.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("edge_segment_max_cuda needs contiguous values and int32 ids")
    S = int(num_segments)
    if S < 0:
        raise ValueError(f"num_segments must be >= 0, got {S}")
    return dev, code, S


@contract("[B,E]", "[B,E]", "S", ret="[B,S]")
def edge_segment_max_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream, laid out by
    :func:`segment_max_plan` for the card (the C entry computes the same
    plan).  Takes contiguous ``[B, E]`` float values and int32 ids on the
    card and returns ``[B, S]`` in the values' dtype; raises if the launch
    fails."""
    dev, code, S = _check_segment_max_cuda(vals, seg_ids, num_segments)
    B, E = vals.shape
    lib = _library()
    with _device_of(vals):
        out = vals.new_empty((B, S))
        err = lib.segment_max(vals.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), B, E, S, code,
                              _stream_of(dev))
    _raise_on(err, "segment_max", lib)
    return out


# Cluster sizes the standalone segment max takes (portable on every sm_90
# card) and the least work a CTA keeps when a row is split; the C entry's
# own copy of the rule, csrc/segment_max.cu::segmax_plan, mirrors
# segment_max_plan.
SEGMENT_MAX_CLUSTERS = (8, 4, 2)
SEGMENT_MAX_MIN_WORK_PER_CTA = 512


class SegmentMaxPlan(NamedTuple):
    """How the standalone segment max lays out a call: ``cluster`` CTAs a
    row, CTA r folding edges ``[r * edges_per_cta, (r + 1) *
    edges_per_cta)`` of it (the last CTAs may hold fewer, or none), the
    row's maxima held in each CTA's shared memory (``segments ==
    "shared"``, ``smem_bytes`` a CTA) or in the output (``"global"``)."""
    cluster: int
    edges_per_cta: int
    segments: str
    smem_bytes: int


@contract("B", "E", "S", None)
def segment_max_plan(B: int, E: int, S: int, elem_bytes: int, *, num_sms: int,
                     smem_cap: int) -> SegmentMaxPlan:
    """The standalone kernel's layout for ``B`` rows of ``E`` edges into
    ``S`` segments of ``elem_bytes``-byte values.  The maxima live in the
    output when a row has more segments than edges or its S keys (8 bytes
    each for float64, 4 for the others) pass ``smem_cap``, else in every
    CTA's shared memory.  A row takes the largest cluster in
    :data:`SEGMENT_MAX_CLUSTERS` whose ``B * cluster`` CTAs fit the card's
    ``num_sms`` (one wave) and whose CTAs keep at least
    :data:`SEGMENT_MAX_MIN_WORK_PER_CTA` edges each (edges and segments
    when the maxima live in the output: each CTA also sets and decodes its
    share of them), else one CTA; each CTA's slice is ``ceil(E /
    cluster)`` edges rounded up to four (one vector load of ids).  Every
    edge is read once either way."""
    smem = S * _key_bytes(elem_bytes)
    where = "global" if S > E or smem > smem_cap else "shared"
    work = E + S if where == "global" else E
    cs = next((k for k in SEGMENT_MAX_CLUSTERS
               if B * k <= num_sms and -(-work // k) >= SEGMENT_MAX_MIN_WORK_PER_CTA), 1)
    return SegmentMaxPlan(cs, _edges_per_cta(E, cs), where, smem if where == "shared" else 0)


def _key_bytes(elem_bytes: int) -> int:
    return 8 if elem_bytes == 8 else 4


def _edges_per_cta(E: int, cluster: int) -> int:
    return (-(-E // cluster) + 3) // 4 * 4


@contract("E", "S", None, None)
def segment_max_layouts(E: int, S: int, elem_bytes: int, smem_cap: int) -> list:
    """Every layout the standalone kernel can take for rows of ``E`` edges
    into ``S`` segments of ``elem_bytes``-byte values: 1, 2, 4 and 8 CTAs a
    row, each with the maxima in shared memory (where the S keys fit
    ``smem_cap``) and in the output.  :func:`segment_max_plan` picks one."""
    smem = S * _key_bytes(elem_bytes)
    return [SegmentMaxPlan(cs, _edges_per_cta(E, cs), where, smem if where == "shared" else 0)
            for cs in (1,) + SEGMENT_MAX_CLUSTERS[::-1]
            for where in ("shared", "global") if where == "global" or smem <= smem_cap]


@functools.cache
def _smem_cap(index: int) -> int:
    """The most shared memory card ``index`` grants a block (the input of
    :func:`segment_max_plan` and :func:`timing_plan`)."""
    with torch.cuda.device(index):
        return int(_library().smem_cap())


def _card_index(device: torch.device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


@contract("B", "E", "S", None, None)
def segment_max_plan_on_card(B: int, E: int, S: int, dtype: torch.dtype,
                             device: torch.device) -> SegmentMaxPlan:
    """:func:`segment_max_plan` with ``device``'s SM count and shared memory."""
    index = _card_index(device)
    return segment_max_plan(B, E, S, torch.empty((), dtype=dtype).element_size(),
                            num_sms=_num_sms(index), smem_cap=_smem_cap(index))


def _segment_max_plan_in_c(B: int, E: int, S: int, dtype: torch.dtype,
                          device: torch.device) -> tuple:
    """``(cluster, edges_per_cta, global)``: the layout the C entry
    ``segment_max_launch`` takes on ``device``; for the tests only, which
    hold it to :func:`segment_max_plan_on_card`."""
    plan = (ctypes.c_int64 * 3)()
    with torch.cuda.device(torch.device(device)):
        _library().segment_max_plan_of(B, E, S, _DTYPE_CODES[dtype], plan)
    return tuple(plan)


def _launch_segment_max(vals: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                        plan: SegmentMaxPlan) -> torch.Tensor:
    """The standalone kernel under ``plan``; the inputs are checked as
    :func:`edge_segment_max_cuda` checks them.  Raises if the card refuses
    the layout (a cluster it cannot place, shared memory it cannot grant,
    a split that leaves edges out)."""
    dev, code, S = _check_segment_max_cuda(vals, seg_ids, num_segments)
    B, E = vals.shape
    lib = _library()
    with _device_of(vals):
        out = vals.new_empty((B, S))
        err = lib.segment_max_plan(vals.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), B, E, S,
                                   code, plan.cluster, plan.edges_per_cta,
                                   int(plan.segments == "global"), _stream_of(dev))
    _raise_on(err, "segment_max", lib)
    return out


# ---------------------------------------------------------------------------
# Karp's max cycle mean


@contract("[B,E]", "[B,E]", "[B,E]", "N")
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


@contract("[B,E]", "[B,E]", "[B,E]", "N")
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


@contract(None, "B", "N", ret="[B]")
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


@contract("[B,E]", "[B,E]", "[B,E]", "N", ret="[B]")
def karp_cycle_time_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                        num_nodes: int) -> torch.Tensor:
    """``[B]`` max cycle means of ``[B, E]`` arc lists (``-inf`` weights
    are absent arcs; ``-inf`` for an acyclic row) in plain PyTorch: N
    scatter levels, then the final formula."""
    check_karp_inputs(src, dst, w, num_nodes)
    N = int(num_nodes)
    return karp_from_step(karp_scatter_step(src, dst, w, N), w.shape[0], N, w.dtype, w.device)


@contract("[B,E]", "[B,E]", "[B,E]", "N", ret="[B]")
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


@contract("[B,E]", "[B,E]", "[B,E]", "N")
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


@contract("[B,E]", "[B,E]", "[B,E]", "N", ret="[2,B,N]")
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


def _check_reach_cuda(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                      num_nodes: int) -> tuple:
    """The checks of a reachability call on the card, types and shapes
    first (as :func:`check_reach_inputs` orders them), then the device and
    the layout; returns ``(card index, N)``.  Ids on the card are not read
    back: one outside ``[0, N)`` stops the kernel."""
    if present.dtype is not torch.bool:
        raise TypeError(f"reach_from_zero: present must be bool, got {present.dtype}")
    if src.dtype is not torch.int32 or dst.dtype is not torch.int32:
        _check_int_ids("reach_from_zero", src=src, dst=dst)
    shape = present.shape
    if len(shape) != 2 or src.shape != shape or dst.shape != shape:
        raise ValueError(f"src, dst and present must all be [B, E]; got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)} and {tuple(shape)}")
    N = int(num_nodes)
    if N < 1:
        raise ValueError(f"num_nodes must be >= 1, got {N}")
    dev = present.get_device()
    if dev < 0 or src.get_device() != dev or dst.get_device() != dev:
        raise ValueError(f"reach_from_zero_cuda needs CUDA tensors on one device, got "
                         f"{src.device}, {dst.device} and {present.device}")
    if src.dtype is not torch.int32 or dst.dtype is not torch.int32 or not (
            src.is_contiguous() and dst.is_contiguous() and present.is_contiguous()):
        raise ValueError("reach_from_zero_cuda needs contiguous int32 ids and mask")
    return dev, N


@contract("[B,E]", "[B,E]", "[B,E]", "N", ret="[2,B,N]")
def reach_from_zero_cuda(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """One launch for both directions, on PyTorch's current stream, laid
    out by :func:`reach_plan` for the card (the C entry computes the same
    plan).  Takes contiguous int32 ``src``/``dst`` and bool ``present``,
    ``[B, E]``, on one card; returns ``[2, B, N]`` bool, equal to
    :func:`reach_from_zero_ref`.  Raises if the launch fails."""
    dev, N = _check_reach_cuda(src, dst, present, num_nodes)
    B, E = present.shape
    lib = _library()
    with _device_of(present):
        out = present.new_empty((2, B, N))
        err = lib.reach(src.data_ptr(), dst.data_ptr(), present.data_ptr(), out.data_ptr(),
                        B, E, N, _stream_of(dev))
    _raise_on(err, "reach", lib)
    return out


# Reachability's layouts (the C interface's codes are their indices) and
# the most nodes the bitsets take (one 32-bit word a lane of a warp); the C
# entry's own copy of the rule, csrc/segment_max.cu::reach_plan, mirrors
# reach_plan.
REACH_LAYOUTS = ("bitset", "hop", "hop_global")
REACH_MAX_BITSET_NODES = 1024


class ReachPlan(NamedTuple):
    """How reachability lays out a call: ``layout`` ``"bitset"`` (a
    traversal's adjacency as N bitsets in shared memory, one warp a
    traversal, ``rows`` traversals a CTA: 1, a direction of one row, or 2,
    both directions of one row), ``"hop"`` (a CTA a row and direction
    hopping over the row's arcs staged in shared memory) or
    ``"hop_global"`` (the same, the arcs read from global memory at every
    hop); ``smem_bytes`` a CTA."""
    layout: str
    rows: int
    smem_bytes: int


def _reach_bitset_bytes(N: int) -> int:
    return N * -(-N // 32) * 4


@contract("E", "N")
def reach_plan(E: int, num_nodes: int, *, smem_cap: int) -> ReachPlan:
    """Reachability's layout for rows of ``E`` arcs over N nodes on a card
    granting ``smem_cap`` bytes a block.  The bitsets take every N up to
    :data:`REACH_MAX_BITSET_NODES` whose N bitsets of ``ceil(N / 32)``
    words fit, both directions of a row in one CTA (``rows`` 2, the arcs
    read once for both) where two sets fit, else one.  Past that the hop
    kernel, its arcs staged in shared memory where their ``8 * E`` bytes
    and N flags fit, else read in place."""
    N = num_nodes
    bits = _reach_bitset_bytes(N)
    if N <= REACH_MAX_BITSET_NODES and bits <= smem_cap:
        rows = 2 if 2 * bits <= smem_cap else 1
        return ReachPlan("bitset", rows, rows * bits)
    staged = 8 * E + N
    return ReachPlan("hop", 1, staged) if staged <= smem_cap else ReachPlan("hop_global", 1, N)


@contract("E", "N", None)
def reach_layouts(E: int, num_nodes: int, smem_cap: int) -> list:
    """Every layout reachability can take for rows of ``E`` arcs over N
    nodes on a card granting ``smem_cap`` bytes a block: the bitsets at 1
    and 2 traversals a CTA where they fit, the hops over staged arcs where
    they fit, the hops over arcs in global memory where the N flags fit.
    :func:`reach_plan` picks one."""
    N = num_nodes
    bits = _reach_bitset_bytes(N)
    out = []
    if N <= REACH_MAX_BITSET_NODES:
        out += [ReachPlan("bitset", r, r * bits) for r in (1, 2) if r * bits <= smem_cap]
    if 8 * E + N <= smem_cap:
        out.append(ReachPlan("hop", 1, 8 * E + N))
    if N <= smem_cap:
        out.append(ReachPlan("hop_global", 1, N))
    return out


@contract("E", "N", None)
def reach_plan_on_card(E: int, num_nodes: int, device: torch.device) -> ReachPlan:
    """:func:`reach_plan` with ``device``'s shared memory."""
    return reach_plan(E, num_nodes, smem_cap=_smem_cap(_card_index(device)))


def _reach_plan_in_c(E: int, N: int, device: torch.device) -> ReachPlan:
    """The layout the C entry ``reach_launch`` takes on ``device``; for the
    tests only, which hold it to :func:`reach_plan_on_card`."""
    plan = (ctypes.c_int64 * 3)()
    with torch.cuda.device(torch.device(device)):
        _library().reach_plan_of(E, N, plan)
    return ReachPlan(REACH_LAYOUTS[plan[0]], plan[1], plan[2])


def _launch_reach(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor, num_nodes: int,
                  plan: ReachPlan) -> torch.Tensor:
    """Reachability under ``plan``; the inputs are checked as
    :func:`reach_from_zero_cuda` checks them.  Raises if the card refuses
    the layout (bitsets past 1024 nodes or past its shared memory, staged
    arcs past it, a ``rows`` the layout does not take)."""
    dev, N = _check_reach_cuda(src, dst, present, num_nodes)
    B, E = present.shape
    lib = _library()
    with _device_of(present):
        out = present.new_empty((2, B, N))
        err = lib.reach_plan(src.data_ptr(), dst.data_ptr(), present.data_ptr(), out.data_ptr(),
                             B, E, N, REACH_LAYOUTS.index(plan.layout), plan.rows,
                             _stream_of(dev))
    _raise_on(err, "reach", lib)
    return out


# ---------------------------------------------------------------------------
# The round-varying Eq. 4 timing recursion (MATCHA pricing)

_TIMING_DTYPES = (torch.float32, torch.float64)


@contract("[E]", "[E]", "[U,E]", "[C,R]", "N", "*[C,N]")
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


@contract("[E]", "[E]", "[U,E]", "[C,R]", "N", "*[C,N]", ret="[C,R+1,N]")
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


# Cluster sizes the timing kernel takes (portable on every sm_90 card), the
# fewest arcs a CTA keeps when a chain is split, and the deepest ring.
TIMING_CLUSTERS = (8, 4, 2)
TIMING_MIN_ARCS_PER_CTA = 256
TIMING_MAX_STAGES = 4


class TimingPlan(NamedTuple):
    """How the timing kernel lays out a call: ``cluster`` CTAs a chain,
    each folding ``arcs_per_cta`` contiguous arcs (the last CTAs may hold
    fewer, or none), ``stages`` rounds of weights in flight in each CTA's
    shared-memory ring (0: arcs and weights read in place), and the
    ``smem_bytes`` a CTA takes."""
    cluster: int
    arcs_per_cta: int
    stages: int
    smem_bytes: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


@contract("N", "A", None, None, None)
def timing_smem_bytes(num_nodes: int, arcs_per_cta: int, stages: int, elem_bytes: int,
                      cluster: int = 1) -> int:
    """Shared memory of one CTA of the timing kernel, as the kernel lays it
    out (``csrc/segment_max.cu::timing_smem_bytes``): ring and inbox
    mbarriers, slot offsets and counts; with ``cluster > 1`` an inbox of two
    rounds x ``cluster`` CTAs x N {key, flag} slots; two start-time buffers,
    a partial-key and a flag buffer of N; with a ring, the CTA's arcs
    grouped by dst (N + 2 offsets, a node list, (src, index) pairs) and
    ``stages`` slots, each the 16-byte-aligned window of a weight row
    around the CTA's slice."""
    inbox = 4 * cluster * num_nodes * elem_bytes if cluster > 1 else 0
    b = _align16(12 * stages + 28) + _align16(inbox + num_nodes * (3 * elem_bytes + 1))
    if stages:
        b += (_align16(4 * (2 * num_nodes + 2)) + _align16(8 * arcs_per_cta)
              + stages * (_align16(arcs_per_cta * elem_bytes) + 16))
    return b


@contract("C", "E", "N", None)
def timing_plan(C: int, E: int, num_nodes: int, elem_bytes: int, *, num_sms: int,
                smem_cap: int) -> TimingPlan:
    """The timing kernel's layout for ``C`` chains over ``E`` arcs and N
    nodes.  A chain takes the largest cluster in :data:`TIMING_CLUSTERS`
    whose ``C * cluster`` CTAs fit the card's ``num_sms`` (one wave), whose
    CTAs keep at least :data:`TIMING_MIN_ARCS_PER_CTA` arcs each, and whose
    inboxes fit ``smem_cap``, else one CTA; the arcs are cut into
    ``cluster`` contiguous slices of ``ceil(E / cluster)``.  The ring is as
    deep as ``smem_cap`` allows, up to :data:`TIMING_MAX_STAGES` rounds (at
    least 2; else 0, read in place)."""
    N = num_nodes
    cs = next((k for k in TIMING_CLUSTERS
               if C * k <= num_sms and -(-E // k) >= TIMING_MIN_ARCS_PER_CTA
               and timing_smem_bytes(N, -(-E // k), 0, elem_bytes, k) <= smem_cap), 1)
    arcs = -(-E // cs)
    stages = next((s for s in range(TIMING_MAX_STAGES, 1, -1)
                   if timing_smem_bytes(N, arcs, s, elem_bytes, cs) <= smem_cap), 0)
    return TimingPlan(cs, arcs, stages, timing_smem_bytes(N, arcs, stages, elem_bytes, cs))


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@contract("C", "E", "N", None, None)
def timing_plan_on_card(C: int, E: int, num_nodes: int, dtype: torch.dtype,
                        device: torch.device) -> TimingPlan:
    """:func:`timing_plan` with ``device``'s SM count and shared memory."""
    index = _card_index(device)
    return timing_plan(C, E, num_nodes, torch.empty((), dtype=dtype).element_size(),
                       num_sms=_num_sms(index), smem_cap=_smem_cap(index))


@contract("[E]", "[E]", "[U,E]", "[C,R]", "N", "*[C,N]", ret="[C,R+1,N]")
def timing_recursion_cuda(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                          round_ids: torch.Tensor, num_nodes: int,
                          t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One persistent launch for every round of every chain, on PyTorch's
    current stream, laid out by :func:`timing_plan` for the card.  Takes
    contiguous int32 ``src``/``dst`` ``[E]`` and ``round_ids`` ``[C, R]``,
    ``w_unique`` ``[U, E]`` (float32 or float64) and an optional ``t0``
    ``[C, N]`` of its dtype, on one card; returns ``[C, R+1, N]`` in
    ``w_unique``'s dtype, bit-identical to :func:`timing_recursion_ref`.
    Raises if N is past what the card's shared memory holds, or if the
    card refuses the launch."""
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
    lib = _library()
    with _device_of(w_unique):
        limit = int(lib.timing_max_nodes(_DTYPE_CODES[w_unique.dtype]))
        if N > limit:
            raise ValueError(f"timing_recursion: N = {N} nodes do not fit the card's shared "
                             f"memory; the limit for {w_unique.dtype} is {limit} nodes")
        plan = timing_plan_on_card(C, E, N, w_unique.dtype, w_unique.device)
        return _launch_timing(src, dst, w_unique, round_ids, N, t0, plan)


def _launch_timing(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                  round_ids: torch.Tensor, num_nodes: int, t0: Optional[torch.Tensor],
                  plan: TimingPlan) -> torch.Tensor:
    """The timing kernel under ``plan``, on inputs that
    :func:`timing_recursion_cuda` has checked; raises if the card refuses
    the launch (a cluster it cannot place, shared memory it cannot grant)."""
    (U, E), (C, R) = w_unique.shape, round_ids.shape
    if plan.stages and w_unique.data_ptr() % 16:
        w_unique = w_unique.clone()  # the ring's bulk copies read 16-byte-aligned windows
    lib = _library()
    with _device_of(w_unique):
        out = torch.empty((C, R + 1, num_nodes), dtype=w_unique.dtype, device=w_unique.device)
        stream = torch.cuda.current_stream(w_unique.device).cuda_stream
        err = lib.timing(src.data_ptr(), dst.data_ptr(), w_unique.data_ptr(),
                         round_ids.data_ptr(), None if t0 is None else t0.data_ptr(),
                         out.data_ptr(), C, R, U, E, num_nodes, plan.cluster, plan.arcs_per_cta,
                         plan.stages, _DTYPE_CODES[w_unique.dtype], stream)
    _raise_on(err, "timing_recursion", lib)
    return out
