"""Federated data partitioning (Appendix G): per-silo token
distributions drawn from a Dirichlet over the vocabulary (the
label-skew analogue of the paper's non-iid LEAF splits).  A copy of
``repro.data.partition.dirichlet_vocab_partition``: same seed, same
numbers."""

from __future__ import annotations

import numpy as np


def dirichlet_vocab_partition(
    n_silos: int, vocab_size: int, alpha: float = 0.3, seed: int = 0
) -> np.ndarray:
    """Per-silo token sampling distributions [n_silos, vocab].

    Lower alpha -> more skew (more non-iid).
    """
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(vocab_size, alpha), size=n_silos)
    return probs.astype(np.float64)
