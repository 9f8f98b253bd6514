"""Host-side math behind the gossip plans (numpy only): Birkhoff
decomposition and the consensus matrices."""

from .birkhoff import birkhoff_decomposition, reconstruct, schedule_cost
from .consensus import is_doubly_stochastic, local_degree_matrix, ring_matrix

__all__ = [
    "birkhoff_decomposition",
    "reconstruct",
    "schedule_cost",
    "is_doubly_stochastic",
    "local_degree_matrix",
    "ring_matrix",
]
