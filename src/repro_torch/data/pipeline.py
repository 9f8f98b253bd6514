"""Synthetic data pipeline: deterministic, infinite, numpy-seeded.

A copy of ``repro.data.pipeline``'s ``SyntheticLMStream`` and
``FederatedBatcher``: the same seed gives bit-identical token batches
in both packages.  Batches are numpy ``int32`` arrays laid out for
DPASGD as ``[n_silos?, s_local, batch, seq]``; the training loop moves
them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .partition import dirichlet_vocab_partition


@dataclass
class SyntheticLMStream:
    """Per-silo synthetic LM stream.  Tokens are drawn from the silo's
    Dirichlet vocab distribution with a bigram twist (token t+1 depends on
    t mod a small table) so the LM has learnable structure."""

    vocab_size: int
    seq_len: int
    n_silos: int = 1
    alpha: float = 0.3
    seed: int = 0

    def __post_init__(self):
        self.probs = dirichlet_vocab_partition(
            self.n_silos, self.vocab_size, self.alpha, self.seed
        )
        rng = np.random.default_rng(self.seed + 1)
        # shared bigram shift table: next ~ P_silo shifted by table[t % 17]
        self.shift = rng.integers(0, self.vocab_size, size=17)

    def sample(self, silo: int, batch: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + silo * 7919 + step) % (2 ** 63)
        )
        p = self.probs[silo]
        base = rng.choice(self.vocab_size, size=(batch, self.seq_len + 1), p=p)
        # inject bigram structure on half the positions
        mix = rng.random((batch, self.seq_len + 1)) < 0.5
        shifted = (base[:, :-1] + self.shift[base[:, :-1] % 17]) % self.vocab_size
        seq = base.copy()
        seq[:, 1:] = np.where(mix[:, 1:], shifted, base[:, 1:])
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }


@dataclass
class FederatedBatcher:
    """Yields DPASGD batches [n_silos, s, B, S] (or [s, B, S] if 1 silo)."""

    stream: SyntheticLMStream
    local_steps: int
    batch_per_silo: int

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def batch(
        self, step: int, silos: Optional[Tuple[int, ...]] = None
    ) -> Dict[str, np.ndarray]:
        """One DPASGD batch.  ``silos`` restricts (and orders) the stacked
        silo dimension to a subset of the stream's silos; row k of the
        batch is silo ``silos[k]``.  Default: every silo, in label order."""
        s, B = self.local_steps, self.batch_per_silo
        labels = tuple(range(self.stream.n_silos)) if silos is None else tuple(silos)
        per_silo = []
        for i in labels:
            if not (0 <= i < self.stream.n_silos):
                raise ValueError(
                    f"silo {i} outside stream universe 0..{self.stream.n_silos - 1}"
                )
            micro = [self.stream.sample(i, B, step * s + m) for m in range(s)]
            per_silo.append(
                {k: np.stack([m[k] for m in micro]) for k in micro[0]}
            )
        if self.stream.n_silos == 1 and silos is None:
            return per_silo[0]
        return {k: np.stack([ps[k] for ps in per_silo]) for k in per_silo[0]}
