"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside
its plain PyTorch version, and the dispatching wrappers in :mod:`.ops`."""

from .ops import LAUNCHES, gossip_mix, reset_launch_counts

__all__ = ["LAUNCHES", "gossip_mix", "reset_launch_counts"]
