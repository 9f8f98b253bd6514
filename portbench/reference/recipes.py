"""Frozen copies of the recipes by which the program's ``train()`` draws
its inputs from a seed, and the benchmark's own token recipe.

``train()`` draws its batches from a synthetic language-model stream
(per-silo Dirichlet token distributions with a bigram twist, numpy
seeded) and, under ``designer="matcha"``, each round's topology from a
MATCHA schedule (a greedy edge colouring of the complete silo graph, each
matching active with probability C_b, drawn from ``(sample_seed, round)``,
then the local-degree consensus matrix).  The reference draws them again
here, so it takes no batch and no matrix from the program;
``tests/test_portbench_recipes.py`` holds each copy equal to the
program's draw.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


# -- the synthetic LM stream ------------------------------------------------

class LMStream:
    """Per-silo token stream: ``sample(silo, batch, step)`` gives
    ``{"tokens", "labels"}`` int32 ``[batch, seq_len]``."""

    def __init__(self, vocab_size: int, seq_len: int, n_silos: int, alpha: float = 0.3,
                 seed: int = 0):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        rng = np.random.default_rng(seed)
        self.probs = rng.dirichlet(np.full(vocab_size, alpha), size=n_silos).astype(np.float64)
        self.shift = np.random.default_rng(seed + 1).integers(0, vocab_size, size=17)

    def sample(self, silo: int, batch: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + silo * 7919 + step) % (2 ** 63))
        base = rng.choice(self.vocab_size, size=(batch, self.seq_len + 1), p=self.probs[silo])
        mix = rng.random((batch, self.seq_len + 1)) < 0.5
        shifted = (base[:, :-1] + self.shift[base[:, :-1] % 17]) % self.vocab_size
        seq = base.copy()
        seq[:, 1:] = np.where(mix[:, 1:], shifted, base[:, 1:])
        return {"tokens": seq[:, :-1].astype(np.int32), "labels": seq[:, 1:].astype(np.int32)}


def stream_batch(stream: LMStream, round_idx: int, silos: Sequence[int], local_steps: int,
                 batch: int) -> Dict[str, np.ndarray]:
    """Round ``round_idx``'s ``[len(silos), s, B, S]`` batch, row k silo
    ``silos[k]``: local step m of a round draws stream step
    ``round_idx * s + m``."""
    per = []
    for i in silos:
        micro = [stream.sample(i, batch, round_idx * local_steps + m) for m in range(local_steps)]
        per.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


# -- MATCHA over the complete silo graph ---------------------------------------

def greedy_matchings(n: int) -> List[List[Tuple[int, int]]]:
    """Greedy edge colouring of K_n, edges incident to high degrees first."""
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
    deg: Dict[int, int] = {}
    for u, v in edges:
        deg[u] = deg.get(u, 0) + 1
        deg[v] = deg.get(v, 0) + 1
    colors: List[List[Tuple[int, int]]] = []
    used: Dict[int, set] = {}
    for u, v in sorted(edges, key=lambda e: -(deg[e[0]] + deg[e[1]])):
        taken = used.setdefault(u, set()) | used.setdefault(v, set())
        c = 0
        while c in taken:
            c += 1
        while c >= len(colors):
            colors.append([])
        colors[c].append((u, v))
        used[u].add(c)
        used[v].add(c)
    return colors


def matcha_active(n_matchings: int, budget: float, sample_seed: int, round_idx: int) -> List[int]:
    """The matchings active in a round: each with probability ``budget``,
    from a generator seeded by ``(sample_seed, round_idx)``, drawn again
    until one is active."""
    rng = np.random.default_rng(np.random.SeedSequence((int(sample_seed), int(round_idx))))
    while True:
        active = np.flatnonzero(rng.random(n_matchings) < budget)
        if active.size:
            return [int(a) for a in active]


def local_degree_matrix(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """``A[j, i] = 1 / (1 + max(deg i, deg j))`` on each arc ``i -> j``, the
    rest of each row on its diagonal (in-degrees counted over the arcs)."""
    deg = np.zeros(n, dtype=np.int64)
    for i, j in edges:
        if i != j:
            deg[j] += 1
    A = np.zeros((n, n), dtype=np.float64)
    for i, j in edges:
        if i != j:
            A[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    for i in range(n):
        A[i, i] = 1.0 - A[i].sum()
    return A


def matcha_matrix(n: int, budget: float, sample_seed: int, round_idx: int,
                  matchings=None) -> np.ndarray:
    """Round ``round_idx``'s consensus matrix of homogeneous MATCHA on K_n."""
    matchings = greedy_matchings(n) if matchings is None else matchings
    arcs = []
    for m in matcha_active(len(matchings), budget, sample_seed, round_idx):
        for i, j in matchings[m]:
            arcs += [(i, j), (j, i)]
    return local_degree_matrix(n, sorted(set(arcs)))


# -- the benchmark's own tokens -----------------------------------------------

def round_tokens(seed: int, round_idx: int, shape: Tuple[int, ...], vocab_size: int,
                 device) -> Dict[str, torch.Tensor]:
    """Uniform random tokens for one round, ``shape`` = ``[n, s, B, S]``,
    drawn on ``device`` from a generator seeded by ``(seed, round)``:
    every row of every round differs.  Labels are the tokens shifted by
    one position."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(round_idx) * 7919 + 17) % (2 ** 63))
    seq = torch.randint(0, vocab_size, (*shape[:-1], shape[-1] + 1), generator=gen,
                        device=device)
    return {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
