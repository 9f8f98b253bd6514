from .partition import dirichlet_vocab_partition, jensen_shannon, lognormal_sizes
from .pipeline import FederatedBatcher, SyntheticLMStream

__all__ = ["FederatedBatcher", "SyntheticLMStream", "dirichlet_vocab_partition",
           "jensen_shannon", "lognormal_sizes"]
