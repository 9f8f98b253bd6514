"""Checkpointing: msgpack-serialized trees with a shape/dtype manifest, in
the reference's format (``repro/checkpoint/io.py``).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers; a leaf's key is the ``"/"``-joined path of dict keys
and list indices (``params/layers/0/attn/wq``), the reference's
``tree_flatten_with_path`` keys, so a checkpoint written by either
package loads in the other.  A port train state becomes such a tree
through :func:`repro_torch.models.params.state_to_tree`.  Writes are
atomic (``os.replace``), with a ``.meta.json`` beside the file.
``msgpack`` is imported when a checkpoint is read or written.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch


def _leaves_with_keys(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, lists and tuples in order (an empty one holds no leaf)."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _leaves_with_keys(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_keys(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(like, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if isinstance(like, Mapping):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (str(i),)) for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def tree_to_bytes(tree) -> bytes:
    import msgpack

    payload = {}
    for key, leaf in _leaves_with_keys(tree):
        v = _to_numpy(leaf)
        payload[key] = {"dtype": str(v.dtype), "shape": list(v.shape), "data": v.tobytes()}
    return msgpack.packb(payload, use_bin_type=True)


def tree_from_bytes(blob: bytes, like) -> Any:
    """The tree shaped like ``like`` with the checkpoint's values: every
    leaf a CPU tensor of the ``like`` leaf's dtype (its shape checked)."""
    import msgpack

    payload = msgpack.unpackb(blob, raw=False)
    leaves = {}
    for key, leaf in _leaves_with_keys(like):
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = payload[key]
        arr = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"])).reshape(rec["shape"])
        expect = _to_numpy(leaf)
        if tuple(arr.shape) != tuple(expect.shape):
            raise ValueError(
                f"shape mismatch at {key}: ckpt {arr.shape} vs model {expect.shape}")
        leaves[key] = torch.from_numpy(arr.astype(expect.dtype))
    return _rebuild(like, leaves)


def save_checkpoint(path: str, state, step: int | None = None) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    blob = tree_to_bytes(state)
    with tempfile.NamedTemporaryFile(dir=d, delete=False) as f:
        f.write(blob)
        tmp = f.name
    os.replace(tmp, path)
    meta = {"step": int(step) if step is not None else None, "bytes": len(blob)}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, like) -> Any:
    with open(path, "rb") as f:
        blob = f.read()
    return tree_from_bytes(blob, like)


def save_silo_checkpoint(directory: str, silo: int, state, step: int) -> str:
    """Checkpoint one departing silo's row under elastic membership.

    ``state`` is the train-state tree *sliced to this silo's row*
    (:func:`repro_torch.fed.dpasgd.slice_silo_row`) — the leaver's
    parameters and optimizer slots at the instant its row is dropped, so a
    later rejoin (or audit) can recover exactly what the silo had trained.
    Returns the written path ``<directory>/silo<label>_step<step>.msgpack``."""
    path = os.path.join(directory, f"silo{int(silo)}_step{int(step)}.msgpack")
    save_checkpoint(path, state, step=step)
    return path
