"""Mixture-of-Experts FFN: top-k router, capacity-based dispatch
(GShard/Switch style), shared experts (DeepSeek-V2) and the load-balance
auxiliary loss; counterpart of ``repro.models.moe`` on one card (no
expert-parallel sharding).

Dispatch is group-local: each sequence is a group with its own capacity,
``cap = int(max(1, top_k * S * capacity_factor // n_experts))`` slots per
expert.  A token's position in an expert's queue comes from one stable
sort of the group's ``S * top_k`` assignments in token-major, slot-minor
order; an assignment at or past ``cap`` is dropped and its token passes
through the residual (the routed output is 0 for it).

The routed experts run as three batched products over a ``[B, E, W, D]``
buffer, outside any kernel, as the reference's einsums do.  ``W`` is the
smaller of ``cap`` and the largest expert load of the batch: the
reference's buffer has ``cap`` slots, and the ones past the largest load
are empty there, give zero rows and are never read back (a dropped
assignment reads slot ``cap - 1``, and there is one only when some load
exceeds ``cap``, so then ``W == cap``).  So the function is the same,
while a dropless buffer (``cap = top_k * S``) keeps the size of the
tokens it holds.  Finding ``W`` reads one integer back to the host per call.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    s = D ** -0.5
    specs = {
        "router": ParamSpec((D, E), s),
        "w_gate": ParamSpec((E, D, Fe), s),
        "w_up": ParamSpec((E, D, Fe), s),
        "w_down": ParamSpec((E, Fe, D), Fe ** -0.5),
    }
    if m.n_shared:
        Fs = m.d_shared or Fe
        specs.update(
            sh_gate=ParamSpec((D, m.n_shared * Fs), s),
            sh_up=ParamSpec((D, m.n_shared * Fs), s),
            sh_down=ParamSpec((m.n_shared * Fs, D), Fs ** -0.5),
        )
    return specs


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert of a group of ``S`` tokens (the reference's ``cap``)."""
    m = cfg.moe
    return int(max(1, (m.top_k * S * m.capacity_factor) // m.n_experts))


def _dispatch_group(x: torch.Tensor, logits: torch.Tensor, k: int, E: int, cap: int):
    """Top-k dispatch of every group (sequence) at once.  x [B, S, D];
    logits [B, S, E] float32.

    Returns the buffer ``[B, E, W, D]`` and ``(gate_idx, safe_pos, gate,
    probs, keep)``: the chosen experts ``[B, S, k]`` (a stable descending
    sort, so a tie puts the lower expert first, as ``jax.lax.top_k``
    does), each assignment's slot (``cap - 1`` where dropped), its gate
    (renormalised over the k, 0 where dropped, in x's dtype), the router
    probabilities ``[B, S, E]`` and the kept mask."""
    B, S, D = x.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat = gate_idx.reshape(B, S * k)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(S * k, device=x.device) - first
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted).reshape(B, S, k)
    keep = pos < cap
    gate = (gate_vals * keep).to(x.dtype)
    safe_pos = torch.where(keep, pos, cap - 1)
    width = min(cap, int(pos.max()) + 1)
    buf = torch.zeros((B, E, width, D), dtype=x.dtype, device=x.device)
    groups = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    vals = torch.where(keep[..., None], x[:, :, None, :], 0.0)
    # accumulate, as the reference's scatter-add: a dropped assignment adds
    # zeros at slot cap - 1, which leaves a token kept there unchanged
    buf.index_put_((groups, gate_idx, safe_pos), vals, accumulate=True)
    return buf, (gate_idx, safe_pos, gate, probs, keep)


def moe_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (output [B, S, D], aux loss).  The aux loss is the
    Switch load-balance term over all B*S tokens, ``E * sum_e mean_prob_e
    * top1_share_e * router_aux_weight``."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    logits = (x @ p["router"]).to(torch.float32)
    buf, (gate_idx, safe_pos, gate, probs, _) = _dispatch_group(x, logits, k, E,
                                                                capacity(cfg, S))
    g = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"]))
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    y = torch.einsum("gecf,efd->gecd", g * u, p["w_down"])  # [B, E, W, D]
    groups = torch.arange(B, device=x.device)[:, None]
    out = torch.zeros((B, S, D), dtype=y.dtype, device=x.device)
    for slot in range(k):  # the reference's order of the k terms
        out = out + y[groups, gate_idx[..., slot], safe_pos[..., slot]] * gate[..., slot, None]

    me = probs.reshape(-1, E).mean(dim=0)
    ce = F.one_hot(gate_idx[..., 0].reshape(-1), E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(me * ce) * m.router_aux_weight

    if m.n_shared:
        out = out + (F.silu(x @ p["sh_gate"]) * (x @ p["sh_up"])) @ p["sh_down"]
    return out.to(x.dtype), aux
