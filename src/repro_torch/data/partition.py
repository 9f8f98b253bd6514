"""Federated data partitioning (Appendix G), a copy of the reference's
``repro/data/partition.py``: same seeds, same numbers.

The paper builds non-iid silo datasets two ways: label-skew splits of
LEAF datasets (lognormal writer counts) and geo-assignment of iNaturalist
images.  For synthetic LM streams we reproduce the *statistical* shape:
per-silo token distributions drawn from a Dirichlet over vocab buckets
(label-skew analogue) and lognormal silo dataset sizes.
"""

from __future__ import annotations

import numpy as np


def lognormal_sizes(n_silos: int, total: int, mean: float = 5.0,
                    sigma: float = 1.5, seed: int = 0) -> np.ndarray:
    """Silo dataset sizes ~ lognormal(mean, sigma), normalized to ``total``
    (the paper associates a lognormal number of writers/roles per silo)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean, sigma, n_silos)
    sizes = np.maximum(1, (raw / raw.sum() * total).astype(np.int64))
    return sizes


def dirichlet_vocab_partition(
    n_silos: int, vocab_size: int, alpha: float = 0.3, seed: int = 0
) -> np.ndarray:
    """Per-silo token sampling distributions [n_silos, vocab].

    Lower alpha -> more skew (more non-iid).
    """
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(vocab_size, alpha), size=n_silos)
    return probs.astype(np.float64)


def jensen_shannon(p: np.ndarray, q: np.ndarray) -> float:
    """JS divergence between silo label distributions (Appendix H.4
    diagnostic, Fig. 25)."""
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)
