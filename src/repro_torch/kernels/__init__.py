"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside
its plain PyTorch version, and the dispatching wrappers in :mod:`.ops`."""

from .ops import (
    LAUNCHES,
    edge_segment_max,
    flash_attention,
    gossip_mix,
    karp_cycle_time,
    mlstm_scan,
    reach_from_zero,
    reset_launch_counts,
    timing_recursion,
)
from .segment_max import select_segment_max_impl

__all__ = ["LAUNCHES", "edge_segment_max", "flash_attention", "gossip_mix", "karp_cycle_time",
           "mlstm_scan", "reach_from_zero", "reset_launch_counts", "select_segment_max_impl",
           "timing_recursion"]
