"""Parameter specs, the flat parameter layout, initialisation, and the
carry-over of the JAX package's weights.

A model's parameters are a tree shaped like the reference's pytree:
nested dicts (and the ``"layers"`` list) whose leaves are ``[in, out]``
weights, so ``x @ w`` reads the same in both packages.  The training
state keeps every silo's parameters as one row of a flat ``[n_silos, P]``
buffer; :class:`ParamLayout` gives the per-leaf views of a row, so the
fused gossip mix needs no concatenation and a silo's gradient comes out
flat.  Leaves are laid out in the reference's ``tree_flatten`` order
(dict keys sorted, lists in order).  :func:`from_jax_params` carries the
reference's trees in and :func:`state_to_tree` carries a state back out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Path = Tuple[Any, ...]


@dataclass(frozen=True)
class ParamSpec:
    """One leaf: its shape and initialisation (the reference's spec
    without the logical sharding axes, which one card does not use)."""

    shape: Tuple[int, ...]
    scale: float = 0.02              # std of the truncated normal; unused for zeros/ones
    init: str = "normal"             # "normal" | "zeros" | "ones"


def tree_leaves_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in the reference's flatten order.  Dicts
    and lists are containers; anything else, tuples included (a leaf may
    be a shape), is a leaf."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping the dict/list structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _unflatten(skeleton, leaves_by_path: Dict[Path, Any], path: Path = ()):
    if isinstance(skeleton, Mapping):
        return {k: _unflatten(v, leaves_by_path, path + (k,)) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, leaves_by_path, path + (i,)) for i, v in enumerate(skeleton)]
    return leaves_by_path[path]


class ParamLayout:
    """Offsets of every leaf of a parameter tree inside one flat row.

    Built from a tree whose leaves are :class:`ParamSpec`\\ s or shapes.
    ``views(row)`` returns the tree of ``[in, out]`` views into a flat
    ``[P]`` tensor; writes through a view land in the row."""

    def __init__(self, tree):
        self._skeleton = tree
        self.paths: List[Path] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.offsets: List[int] = []
        off = 0
        for path, leaf in tree_leaves_with_path(tree):
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
            self.paths.append(path)
            self.shapes.append(shape)
            self.offsets.append(off)
            off += math.prod(shape)
        self.size = off

    def leaf_views(self, row: torch.Tensor) -> List[torch.Tensor]:
        """Per-leaf views of a flat ``[P]`` row, in layout order."""
        if row.shape != (self.size,):
            raise ValueError(f"row has shape {tuple(row.shape)}, layout needs ({self.size},)")
        return [row[o:o + math.prod(s)].view(s)
                for o, s in zip(self.offsets, self.shapes)]

    def unflatten(self, leaves: Sequence[Any]):
        """The parameter tree holding ``leaves`` (in layout order)."""
        return _unflatten(self._skeleton, dict(zip(self.paths, leaves)))

    def views(self, row: torch.Tensor):
        return self.unflatten(self.leaf_views(row))

    def flatten_into(self, tree, row: torch.Tensor) -> torch.Tensor:
        """Copy a parameter tree (tensors or arrays) into a flat row."""
        leaves = dict(tree_leaves_with_path(tree))
        if set(leaves) != set(self.paths):
            raise ValueError("tree does not match the layout's leaves")
        with torch.no_grad():
            for view, path in zip(self.leaf_views(row), self.paths):
                src = leaves[path]
                view.copy_(src if isinstance(src, torch.Tensor)
                           else torch.tensor(np.asarray(src)))
        return row


def _fill(spec: ParamSpec, t: torch.Tensor, gen: torch.Generator) -> None:
    if spec.init == "zeros":
        t.zero_()
    elif spec.init == "ones":
        t.fill_(1.0)
    else:  # truncated normal, clipped at +-2 sigma, scaled by spec.scale
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(spec.scale)


def init_params_(row: torch.Tensor, layout: ParamLayout, specs,
                 gen: torch.Generator) -> torch.Tensor:
    """Initialise a flat ``[P]`` row in place from the spec tree."""
    spec_leaves = [s for _, s in tree_leaves_with_path(specs)]
    with torch.no_grad():
        for spec, view in zip(spec_leaves, layout.leaf_views(row)):
            _fill(spec, view, gen)
    return row


def init_params(specs, *, seed: int = 0, device: DeviceLike = "cuda"):
    """Materialise a spec tree into a float32 parameter tree (views of one
    flat buffer), drawn from a ``torch.Generator`` seeded with ``seed``.  The
    draws differ from ``jax.random``'s; to compute the same function as
    the reference, carry its weights over with :func:`from_jax_params`."""
    dev = resolve_device(device)
    layout = ParamLayout(specs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    row = torch.empty(layout.size, device=dev)
    return layout.views(init_params_(row, layout, specs, gen))


def count_params(spec_tree) -> int:
    """Number of parameters of a spec tree (leaves are :class:`ParamSpec`\\ s,
    shapes or tensors)."""
    total = 0
    for _, leaf in tree_leaves_with_path(spec_tree):
        total += math.prod(tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf))
    return total


def _is_state(tree) -> bool:
    return isinstance(tree, Mapping) and set(tree) == {"params", "opt_state", "step"}


def _silo_count(params) -> int:
    """Leading silo dimension of a stacked parameter tree: every leaf
    shares it.  An unstacked tree of a real model has leaves with
    different leading dims (``[V, D]`` embedding, ``[D]`` norms)."""
    leads = {np.shape(a)[0] if np.ndim(a) else None
             for _, a in tree_leaves_with_path(params)}
    return leads.pop() if len(leads) == 1 and None not in leads else 1


def from_jax_params(tree, *, device: DeviceLike = "cuda"):
    """Carry the JAX package's weights, given as numpy arrays, into the port.

    * A parameter tree (the reference's ``init_params`` output) becomes
      the same tree of tensors on ``device``.
    * A train state ``{"params", "opt_state", "step"}`` (the reference's
      ``init_state`` / ``make_train_step`` state) becomes the port's
      state: ``params`` and ``opt_state`` as flat ``[n_silos, P]``
      buffers (``[P]`` for one silo; ``opt_state`` None for a stateless
      optimizer, whose reference state is ``()``, and a dict of buffers
      for a dict of parameter-shaped trees, such as AdamW's ``{"mu":
      tree, "nu": tree}``) and ``step`` as an int.
      ``n_silos`` is the leading dimension every params leaf shares (1
      when they share none).
    """
    dev = resolve_device(device)
    if not _is_state(tree):
        return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)
    params = tree["params"]
    n = _silo_count(params)
    leaf_tree = tree_map(lambda a: np.shape(a)[1:] if n > 1 else np.shape(a), params)
    layout = ParamLayout(leaf_tree)

    def flat(sub):
        if isinstance(sub, (tuple, list)) and len(sub) == 0:
            return None
        if isinstance(sub, Mapping) and [p for p, _ in tree_leaves_with_path(sub)] != layout.paths:
            return {k: flat(v) for k, v in sub.items()}  # one buffer per slot
        if n == 1:
            return layout.flatten_into(sub, torch.empty(layout.size, device=dev))
        buf = torch.empty((n, layout.size), device=dev)
        for i in range(n):
            layout.flatten_into(tree_map(lambda a: np.asarray(a)[i], sub), buf[i])
        return buf

    return {"params": flat(params), "opt_state": flat(tree["opt_state"]),
            "step": int(np.asarray(tree["step"]))}


def state_to_tree(state, layout: ParamLayout):
    """The reference's train-state tree of a port state: the inverse of
    :func:`from_jax_params`' state branch.

    ``params`` and ``opt_state`` (flat ``[n_silos, P]`` buffers, ``[P]``
    for one silo) become trees of host numpy arrays shaped by ``layout``
    with the leading silo dimension kept (``()`` for a stateless
    optimizer's None, a dict of such trees for a dict of slots), and
    ``step`` an int32 scalar, as the reference's ``init_state`` makes it."""

    def tree(buf):
        if buf is None:
            return ()
        if isinstance(buf, Mapping):
            return {k: tree(v) for k, v in buf.items()}
        x = buf.detach().cpu().numpy()
        lead = x.shape[:-1]
        if x.shape[-1] != layout.size:
            raise ValueError(f"buffer holds {x.shape[-1]} params per silo, "
                             f"the layout needs {layout.size}")
        return layout.unflatten([x[..., o:o + math.prod(s)].reshape(lead + s)
                                 for o, s in zip(layout.offsets, layout.shapes)])

    return {"params": tree(state["params"]), "opt_state": tree(state["opt_state"]),
            "step": np.asarray(int(state["step"]), np.int32)}
