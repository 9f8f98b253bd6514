"""The reference's view of elastic membership and of a designer's
answer.  Imports nothing of the program.

A migration re-stacks the silos' rows from one active set to another:
a survivor keeps its row bit for bit, a leaver's row goes, a joiner
starts at the survivors' mean, summed in float64 in the order of the new
active set and rounded once.  An overlay that a re-design returns must
span the active silos and nothing else, and be strongly connected.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch


@torch.no_grad()
def migration_faults(old: Dict, new: Dict, old_active: Sequence[int],
                     new_active: Sequence[int], chunk: int = 1 << 22) -> int:
    """Rows of ``new`` (params and every optimizer slot) that a migration
    from ``old`` should not have given: a survivor's row not equal to its
    old row counts one, a joiner's row counts its elements that differ
    from the reference's mean, a buffer of the wrong shape counts one."""
    old_active, new_active = tuple(old_active), tuple(new_active)
    oi = {v: k for k, v in enumerate(old_active)}
    survivors = [v for v in new_active if v in oi]
    faults = 0
    for key, a in _buffers(old).items():
        b = _buffers(new).get(key)
        if b is None or b.numel() != len(new_active) * (a.numel() // len(old_active)):
            faults += 1
            continue
        a = a.view(len(old_active), -1)
        b = b.view(len(new_active), -1)
        for k, v in enumerate(new_active):
            if v in oi:
                faults += 0 if torch.equal(a[oi[v]], b[k]) else 1
                continue
            for lo in range(0, a.shape[1], chunk):
                acc = a[oi[survivors[0]], lo:lo + chunk].double()
                for u in survivors[1:]:
                    acc += a[oi[u], lo:lo + chunk]
                mean = (acc / len(survivors)).float()
                faults += int((mean != b[k, lo:lo + chunk]).sum())
    return faults


def _buffers(state: Dict) -> Dict[str, torch.Tensor]:
    out = {}
    for key, entry in state.items():
        if isinstance(entry, dict):
            out.update({f"{key}/{k}": v for k, v in entry.items() if isinstance(v, torch.Tensor)})
        elif isinstance(entry, torch.Tensor):
            out[key] = entry
    return out


def overlay_faults(arcs: Iterable[Tuple[int, int]], active: Sequence[int]) -> int:
    """1 unless the arcs (self-loops aside) use only ``active`` silos,
    reach every one of them and are strongly connected over them; else 0."""
    nodes = set(active)
    fwd: Dict[int, set] = {v: set() for v in nodes}
    bwd: Dict[int, set] = {v: set() for v in nodes}
    for i, j in arcs:
        if i == j:
            continue
        if i not in nodes or j not in nodes:
            return 1
        fwd[i].add(j)
        bwd[j].add(i)
    if len(nodes) < 2:
        return 0
    start = next(iter(sorted(nodes)))
    for graph in (fwd, bwd):
        seen, todo = {start}, [start]
        while todo:
            for w in graph[todo.pop()]:
                if w not in seen:
                    seen.add(w)
                    todo.append(w)
        if seen != nodes:
            return 1
    return 0
