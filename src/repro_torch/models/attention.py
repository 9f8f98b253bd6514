"""GQA attention (causal / sliding-window) on the chunked online-softmax
path; counterpart of ``repro.models.attention`` (``attn_specs``,
``chunked_attention``, ``attn_forward``).

Written as plain tensor code: one score block per ``kv_block`` keys,
running max and normaliser in float32, masked scores set to ``MASKED``.
The flash-attention kernel of the reference (K3) is a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ModelConfig
from .layers import apply_rope, rope_angles
from .params import ParamSpec

MASKED = -1e30  # score of a masked key (the reference's attention mask value)


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D ** -0.5
    return {
        "wq": ParamSpec((D, H * hd), s),
        "wk": ParamSpec((D, K * hd), s),
        "wv": ParamSpec((D, K * hd), s),
        "wo": ParamSpec((H * hd, D), (H * hd) ** -0.5),
    }


def chunked_attention(
    q: torch.Tensor,       # [B, S, K, G, hd] (grouped query heads)
    k: torch.Tensor,       # [B, T, K, hd]
    v: torch.Tensor,       # [B, T, K, hd]
    q_pos: torch.Tensor,   # [S] int
    kv_pos: torch.Tensor,  # [T] int (-1 marks invalid cache slots)
    *,
    causal: bool,
    window: Optional[int],
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over ``kv_block`` key chunks.

    The reference pads T up to a multiple of ``kv_block`` with masked
    keys; a masked key adds exactly 0 to the normaliser and the output,
    so the last chunk here is simply shorter."""
    B, S, K, G, hd = q.shape
    hd_v = v.shape[-1]
    T = k.shape[1]
    scale = hd ** -0.5
    qf = q.to(torch.float32) * scale
    m = torch.full((B, S, K, G), MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, hd_v), dtype=torch.float32, device=q.device)
    for start in range(0, T, kv_block):
        kc = k[:, start:start + kv_block].to(torch.float32)
        vc = v[:, start:start + kv_block].to(torch.float32)
        pc = kv_pos[start:start + kv_block]
        s = torch.einsum("bskgd,btkd->bskgt", qf, kc)
        mask = pc[None, :] >= 0  # [1, kb] valid
        if causal:
            mask = mask & (pc[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - pc[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s, MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def attn_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 window: Optional[int] = None) -> torch.Tensor:
    """GQA block forward on the chunked path.  x: [B, S, D]."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    B, S = x.shape[:2]
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qg = q.reshape(B, S, K, G, hd)
    out = chunked_attention(qg, k, v, positions, positions, causal=causal, window=window)
    return out.reshape(B, S, H * hd) @ p["wo"]
