"""GQA attention (causal / sliding-window) and its serving caches;
counterpart of ``repro.models.attention`` (``attn_specs``,
``chunked_attention``, ``naive_attention``, ``attn_forward``, the KV
caches and ``attn_decode``).

Full-sequence attention runs on the chunked online-softmax path (one
score block per ``kv_block`` keys, running max and normaliser in
float32, masked scores set to ``MASKED``), or, when
``cfg.use_flash_kernel`` and the attention is causal, through the
flash-attention kernel (K3, :func:`repro_torch.kernels.flash_attention`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

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


def naive_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """O(S*T) reference used for small-shape correctness tests."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgd,btkd->bskgt", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    mask = kv_pos[None, :] >= 0
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    s = torch.where(mask[None, :, None, None, :], s, MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bskgt,btkd->bskgd", p, v.to(torch.float32)).to(q.dtype)


def _qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """Projections and RoPE: q [B, S, K, G, hd], k and v [B, S, K, hd]."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = x.shape[:2]
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q.reshape(B, S, K, H // K, hd), k, v


def attn_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 window: Optional[int] = None, return_kv: bool = False):
    """GQA block forward.  x: [B, S, D].  Causal attention goes through
    the flash-attention kernel when ``cfg.use_flash_kernel``, else the
    chunked path.  With ``return_kv`` also returns the post-RoPE
    ``(k, v)`` for the serving cache."""
    B, S = x.shape[:2]
    qg, k, v = _qkv(p, cfg, x, positions)
    if cfg.use_flash_kernel and causal:
        out = kops.flash_attention(qg, k, v, positions, positions,
                                   causal=causal, window=window)
    else:
        out = chunked_attention(qg, k, v, positions, positions, causal=causal,
                                window=window)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: Optional[int],
                  dtype: torch.dtype, device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty cache: ``min(max_len, window)`` slots (a ring buffer under a
    window), ``pos`` -1 for every free slot."""
    K, hd = cfg.n_kv_heads, cfg.head_dim
    size = min(max_len, window) if window is not None else max_len
    return {
        "k": torch.zeros((batch, size, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, K, hd), dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write prefill K/V into a (possibly ring-buffered) cache: the last
    ``min(S, size)`` positions, each at slot ``pos % size``.  Updates the
    cache in place (the reference returns a new one) and returns it."""
    size = cache["k"].shape[1]
    take = min(k.shape[1], size)
    pos_t = positions[-take:]
    slots = pos_t % size
    cache["k"][:, slots] = k[:, -take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, -take:].to(cache["v"].dtype)
    cache["pos"][slots] = pos_t.to(torch.int32)
    return cache


def attn_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], position: int, *,
                window: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a (possibly ring-buffered) KV cache.
    x: [B, 1, D]; ``position`` a Python int, so nothing here waits for the
    device.  Writes the token's K/V into the cache in place and attends
    over the whole cache on the chunked path."""
    B = x.shape[0]
    pos_arr = torch.arange(position, position + 1, device=x.device)
    qg, k, v = _qkv(p, cfg, x, pos_arr)
    cache_len = cache["k"].shape[1]
    slot = position if window is None else position % cache_len
    # The reference writes with lax.dynamic_update_slice, which clamps a
    # start index so that the update fits: a slot past the end of an
    # unwindowed cache lands on its last slot.
    slot = min(max(slot, 0), cache_len - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = position
    out = chunked_attention(qg, cache["k"], cache["v"], pos_arr, cache["pos"],
                            causal=True, window=window)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"], cache
