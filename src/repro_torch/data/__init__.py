from .partition import dirichlet_vocab_partition
from .pipeline import FederatedBatcher, SyntheticLMStream

__all__ = ["FederatedBatcher", "SyntheticLMStream", "dirichlet_vocab_partition"]
