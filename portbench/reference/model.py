"""Plain PyTorch reference of the benchmark's dense GQA decoders, their
initialisation recipe, and the optimizer updates and gossip mix of a
DPASGD round.

It follows the published descriptions of InternLM2 and H2O-Danube: token
embedding, pre-norm blocks of RMSNorm, grouped-query attention with
rotary positions (rotate-half, the angles in float32 as the published
implementations take them) under a causal mask and, where the config
has one, a sliding window, then a SwiGLU MLP; a final RMSNorm, an untied
head and the mean token cross entropy.  Attention is one softmax over
the whole score matrix, with no blocking, no kernel and no checkpointing.
Matrix products run in float32 with TF32 off unless a caller (the
control of ``calibrate.py``) turns it on.

A silo's parameters are one flat float32 row.  :func:`leaf_table` gives
the leaves' names, shapes and offsets in the row, in the order of a
sorted-key flatten of the parameter tree, so that the benchmark can hold
a leaf of the program's row against the same leaf of the reference's.
:func:`init_rows` draws rows with a truncated normal per leaf from one
``torch.Generator`` on the card, leaf after leaf and row after row.

This module imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Dims:
    """The sizes a config file gives, under the program's field names."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    offset: int
    init: str      # "normal" (truncated at two sigma, then scaled) or "ones"
    scale: float

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def leaf_table(d: Dims) -> List[Leaf]:
    """Every leaf of one silo's row, in row order."""
    D, H, K, hd, Fd, V = d.d_model, d.n_heads, d.n_kv_heads, d.head_dim, d.d_ff, d.padded_vocab
    items: List[Tuple[str, Tuple[int, ...], str, float]] = [
        ("embed", (V, D), "normal", 1.0 / (D ** 0.5)),
        ("final_ln", (D,), "ones", 1.0),
    ]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        items += [
            (p + "attn.wk", (D, K * hd), "normal", D ** -0.5),
            (p + "attn.wo", (H * hd, D), "normal", (H * hd) ** -0.5),
            (p + "attn.wq", (D, H * hd), "normal", D ** -0.5),
            (p + "attn.wv", (D, K * hd), "normal", D ** -0.5),
            (p + "ln1", (D,), "ones", 1.0),
            (p + "ln2", (D,), "ones", 1.0),
            (p + "mlp.w_down", (Fd, D), "normal", Fd ** -0.5),
            (p + "mlp.w_gate", (D, Fd), "normal", D ** -0.5),
            (p + "mlp.w_up", (D, Fd), "normal", D ** -0.5),
        ]
    items.append(("lm_head", (D, V), "normal", D ** -0.5))
    out, off = [], 0
    for name, shape, init, scale in items:
        out.append(Leaf(name, shape, off, init, scale))
        off += math.prod(shape)
    return out


def row_size(d: Dims) -> int:
    last = leaf_table(d)[-1]
    return last.offset + last.size


def views(row: torch.Tensor, table: Sequence[Leaf]) -> Dict[str, torch.Tensor]:
    return {lf.name: row[lf.offset:lf.offset + lf.size].view(lf.shape) for lf in table}


@torch.no_grad()
def fill_row(row: torch.Tensor, table: Sequence[Leaf], gen: torch.Generator) -> None:
    """One silo's row: each normal leaf from ``trunc_normal_`` at one sigma
    clipped to two, times its scale; each norm weight 1."""
    for lf in table:
        v = row[lf.offset:lf.offset + lf.size]
        if lf.init == "ones":
            v.fill_(1.0)
        else:
            torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
            v.mul_(lf.scale)


def iter_rows(d: Dims, n: int, seed: int, device, scratch: Optional[torch.Tensor] = None
              ) -> Iterator[torch.Tensor]:
    """Rows 0 .. n-1 of :func:`init_rows`, one at a time in one scratch row."""
    table = leaf_table(d)
    gen = torch.Generator(device=device).manual_seed(seed)
    row = scratch if scratch is not None else torch.empty(row_size(d), device=device)
    for _ in range(n):
        fill_row(row, table, gen)
        yield row


def init_rows(d: Dims, n: int, seed: int, device) -> torch.Tensor:
    """``[n, P]`` float32 rows drawn from ``seed``."""
    out = torch.empty((n, row_size(d)), device=device)
    table = leaf_table(d)
    gen = torch.Generator(device=device).manual_seed(seed)
    for r in range(n):
        fill_row(out[r], table, gen)
    return out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss(row: torch.Tensor, d: Dims, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [B, S] against
    ``labels`` [B, S] under the parameters in ``row``."""
    p = views(row, leaf_table(d))
    B, S = tokens.shape
    H, K, hd = d.n_heads, d.n_kv_heads, d.head_dim
    dev = row.device
    pos = torch.arange(S, device=dev, dtype=torch.float32)
    inv_freq = 1.0 / (d.rope_theta ** (torch.arange(0, hd // 2, device=dev,
                                                    dtype=torch.float32) / (hd // 2)))
    ang = pos[:, None] * inv_freq[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    qi = torch.arange(S, device=dev)
    visible = qi[None, :] <= qi[:, None]
    if d.sliding_window is not None:
        visible &= (qi[:, None] - qi[None, :]) < d.sliding_window
    x = p["embed"][tokens]
    for i in range(d.n_layers):
        pre = f"layers.{i}."
        h = _rms(x, p[pre + "ln1"], d.norm_eps)
        q = _rope((h @ p[pre + "attn.wq"]).view(B, S, H, hd), cos, sin)
        k = _rope((h @ p[pre + "attn.wk"]).view(B, S, K, hd), cos, sin)
        v = (h @ p[pre + "attn.wv"]).view(B, S, K, hd)
        k = k.repeat_interleave(H // K, dim=2)   # query head j reads key head j // (H / K)
        v = v.repeat_interleave(H // K, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * hd)
        x = x + o @ p[pre + "attn.wo"]
        h = _rms(x, p[pre + "ln2"], d.norm_eps)
        x = x + (F.silu(h @ p[pre + "mlp.w_gate"]) * (h @ p[pre + "mlp.w_up"])) @ p[pre + "mlp.w_down"]
    x = _rms(x, p["final_ln"], d.norm_eps)
    logits = (x @ p["lm_head"])[..., :d.vocab_size]
    return F.cross_entropy(logits.reshape(-1, d.vocab_size), labels.reshape(-1).long())


def loss_and_grad(row: torch.Tensor, d: Dims, tokens: torch.Tensor,
                  labels: torch.Tensor) -> Tuple[float, torch.Tensor]:
    """``(loss, flat gradient [P])`` at ``row``."""
    w = row.detach().clone().requires_grad_()
    val = loss(w, d, tokens, labels)
    (g,) = torch.autograd.grad(val, w)
    return float(val.detach()), g


@torch.no_grad()
def adamw_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, t: int,
               lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Adam with decoupled weight decay 0 at step ``t`` (1-based), in place."""
    mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * g * (1 - b2))
    p.sub_(lr * (mu / (1 - b1 ** t)) / ((nu / (1 - b2 ** t)).sqrt() + eps))


@torch.no_grad()
def momentum_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, lr: float,
                  beta: float = 0.9) -> None:
    """Heavy ball: ``m <- beta m + g``, ``p <- p - lr m``, in place."""
    m.mul_(beta).add_(g)
    p.sub_(lr * m)


@torch.no_grad()
def mix_rows(rows: torch.Tensor, A, chunk: int = 1 << 24) -> None:
    """``rows <- A rows`` over the leading silo dimension, in float64
    column blocks, rounded once to float32."""
    A64 = torch.as_tensor(A, dtype=torch.float64, device=rows.device)
    for lo in range(0, rows.shape[1], chunk):
        blk = rows[:, lo:lo + chunk]
        blk.copy_((A64 @ blk.double()).float())


def ring_matrix_from_arcs(arcs: Sequence[Tuple[int, int]], n: int):
    """``(I + P) / 2`` of a directed ring given as its ``n`` arcs ``i -> j``
    (silo j takes half of silo i's row), as a nested list of floats; raises
    ``ValueError`` unless the arcs form one cycle through all ``n`` silos."""
    succ: Dict[int, int] = {}
    for i, j in arcs:
        if i == j or i in succ or not (0 <= i < n and 0 <= j < n):
            raise ValueError(f"not a directed ring over {n} silos: {sorted(arcs)}")
        succ[i] = j
    seen, cur = [], 0
    while cur not in seen and cur in succ:
        seen.append(cur)
        cur = succ[cur]
    if len(succ) != n or len(seen) != n or cur != 0:
        raise ValueError(f"not one cycle through {n} silos: {sorted(arcs)}")
    A = [[0.5 if r == c else 0.0 for c in range(n)] for r in range(n)]
    for i, j in succ.items():
        A[j][i] += 0.5
    return A
