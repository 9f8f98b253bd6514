"""Public wrappers around the hand-written kernels.

Each wrapper picks its path from where its input lies: a CPU tensor goes
through the kernel's plain PyTorch version, a CUDA tensor launches the
kernel (or the wrapper raises).  There is no fallback from the kernel to
the plain version.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a run
resets it with :func:`reset_launch_counts` before the path it wants to
account for and reads it after.

K3 (``flash_attention``) and K4 (``mlstm_scan``) are forward-only, as
their Pallas counterparts are: under autograd, with an input that
requires grad, both wrappers raise on every device instead of returning
an output with no gradient path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .flash_attention import check_inputs, flash_attention_cuda, flash_attention_ref
from .gossip_mix import gossip_mix_cuda, gossip_mix_ref
from .mlstm_scan import check_inputs as check_mlstm_inputs
from .mlstm_scan import mlstm_chunked_ref, mlstm_scan_cuda
from .segment_max import (
    check_karp_inputs,
    check_reach_inputs,
    edge_segment_max_cuda,
    edge_segment_max_ref,
    karp_cycle_time_cuda,
    karp_cycle_time_ref,
    reach_from_zero_cuda,
    reach_from_zero_ref,
    timing_recursion_cuda,
    timing_recursion_ref,
)

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "gossip_mix": 0, "karp": 0, "mlstm_scan": 0,
                            "reach": 0, "segment_max": 0, "timing": 0}


def _refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise when autograd would need a backward of a forward-only kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward (its Pallas counterpart has none either): training "
            "takes the chunked attention and scan paths, or flash_vjp for attention; call "
            "the kernel under torch.no_grad() or on tensors that do not require grad")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gossip_mix(neighbor_blocks: torch.Tensor, weights: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[n] = sum_k weights[k] * neighbor_blocks[k, n]`` over
    ``[K, N]`` blocks (float32 or bfloat16; own params at k=0 by
    convention), accumulated in float32.  Counterpart of
    ``repro.kernels.ops.gossip_mix``."""
    weights = weights.to(device=neighbor_blocks.device, dtype=torch.float32).contiguous()
    if neighbor_blocks.device.type == "cpu":
        return gossip_mix_ref(neighbor_blocks, weights, out=out)
    if neighbor_blocks.is_cuda:
        res = gossip_mix_cuda(neighbor_blocks, weights, out=out)
        LAUNCHES["gossip_mix"] += 1
        return res
    raise ValueError(f"gossip_mix: no kernel for device {neighbor_blocks.device}")


def edge_segment_max(vals: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``out[b, s] = max vals[b, e]`` over ``seg_ids[b, e] == s`` for
    ``[B, E]`` float values and integer ids into ``[B, S]`` (``-inf`` for
    empty segments; out-of-range ids dropped).  Counterpart of
    ``repro.kernels.ops.edge_segment_max``."""
    if vals.device.type == "cpu":
        return edge_segment_max_ref(vals, seg_ids, num_segments)
    if vals.is_cuda:
        ids = seg_ids.to(device=vals.device, dtype=torch.int32).contiguous()
        res = edge_segment_max_cuda(vals.contiguous(), ids, num_segments)
        if res.numel():
            LAUNCHES["segment_max"] += 1
        return res
    raise ValueError(f"edge_segment_max: no kernel for device {vals.device}")


def karp_cycle_time(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """``[B]`` Karp max cycle means of ``[B, E]`` arc lists ``src -> dst``
    with weights ``w`` (``-inf`` marks an absent arc) over ``num_nodes``
    nodes; ``-inf`` for an acyclic row.  On the card all N levels and the
    final formula are one launch of the persistent K1 recursion."""
    if w.device.type == "cpu":
        return karp_cycle_time_ref(src, dst, w, num_nodes)
    if w.is_cuda:
        check_karp_inputs(src, dst, w, num_nodes)
        res = karp_cycle_time_cuda(src.to(device=w.device, dtype=torch.int32).contiguous(),
                                   dst.to(device=w.device, dtype=torch.int32).contiguous(),
                                   w.contiguous(), num_nodes)
        if res.numel():
            LAUNCHES["karp"] += 1
        return res
    raise ValueError(f"karp_cycle_time: no kernel for device {w.device}")


def reach_from_zero(src: torch.Tensor, dst: torch.Tensor, present: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """``[2, B, N]`` bool: the vertices reachable from vertex 0 along the
    present arcs of ``[B, E]`` lists, forward (``src -> dst``) and
    backward (``dst -> src``).  On the card both directions are one
    launch of the persistent K1 recursion."""
    if present.device.type == "cpu":
        return reach_from_zero_ref(src, dst, present, num_nodes)
    if present.is_cuda:
        check_reach_inputs(src, dst, present, num_nodes)
        res = reach_from_zero_cuda(src.to(device=present.device, dtype=torch.int32).contiguous(),
                                   dst.to(device=present.device, dtype=torch.int32).contiguous(),
                                   present.contiguous(), num_nodes)
        if res.numel():
            LAUNCHES["reach"] += 1
        return res
    raise ValueError(f"reach_from_zero: no kernel for device {present.device}")


def timing_recursion(src: torch.Tensor, dst: torch.Tensor, w_unique: torch.Tensor,
                     round_ids: torch.Tensor, num_nodes: int,
                     t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[C, R+1, N]`` start times of the unique-rounds Eq. 4 recursion:
    arcs ``src -> dst`` ``[E]`` shared by every round, round k of chain c
    weighted by row ``round_ids[c, k]`` of ``w_unique`` ``[U, E]``
    (``-inf`` marks an absent arc; a vertex without a present self-loop
    keeps its start), from ``t0`` ``[C, N]`` (default zeros).  On the
    card every round of every chain is one launch of the persistent K1
    recursion; the ids and ``t0`` follow ``w_unique`` to its device."""
    if w_unique.device.type == "cpu":
        return timing_recursion_ref(src, dst, w_unique, round_ids, num_nodes, t0)
    if w_unique.is_cuda:
        dev = w_unique.device

        def ids(t):
            return t.to(device=dev, dtype=torch.int32).contiguous()

        res = timing_recursion_cuda(ids(src), ids(dst), w_unique.contiguous(), ids(round_ids),
                                    num_nodes, None if t0 is None else
                                    t0.to(device=dev, dtype=w_unique.dtype).contiguous())
        if res.numel():
            LAUNCHES["timing"] += 1
        return res
    raise ValueError(f"timing_recursion: no kernel for device {w_unique.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: Any = None, kv_pos: Any = None, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Forward GQA attention, q ``[B, S, K, G, hd]`` against k, v
    ``[B, T, K, hd]`` (float32 or bfloat16; ``S`` and ``T`` multiples of
    128), causal and optionally windowed, softmax in float32, output in
    q's dtype.  Counterpart of ``repro.kernels.ops.flash_attention``: like
    it, it takes ``q_pos``/``kv_pos`` and ignores them, since the
    positions are ``0..S-1`` and ``0..T-1``.  Forward only: raises under
    autograd when an input requires grad."""
    check_inputs(q, k, v, window)
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.is_cuda:
        res = flash_attention_cuda(q, k, v, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
        return res
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_i: torch.Tensor,
               log_f: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """The mLSTM / gated linear-attention scan ``S_t = f_t S_{t-1} + i_t
    k_t v_t^T``, ``h_t = q_t . S_t`` over q, k, v ``[B, S, H, hd]``
    (float32 or bfloat16) and log-gates ``[B, S, H]``, with a float32
    state; output in q's dtype.  Counterpart of
    ``repro.kernels.ops.mlstm_scan``: like it, it needs ``S % chunk ==
    0``.  The CPU path is the chunked plain version at ``chunk``; the
    kernel picks its own chunk, which changes the result only by rounding.
    Forward only: raises under autograd when an input requires grad."""
    check_mlstm_inputs(q, k, v, log_i, log_f, chunk)
    _refuse_grad("mlstm_scan", q, k, v, log_i, log_f)
    if q.device.type == "cpu":
        return mlstm_chunked_ref(q, k, v, log_i, log_f, chunk=chunk)
    if q.is_cuda:
        res = mlstm_scan_cuda(q, k, v, log_i, log_f)
        LAUNCHES["mlstm_scan"] += 1
        return res
    raise ValueError(f"mlstm_scan: no kernel for device {q.device}")
