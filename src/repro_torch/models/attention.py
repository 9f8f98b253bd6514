"""GQA attention (causal / sliding-window / bidirectional), DeepSeek MLA
(multi-head latent attention, absorbed decode), Whisper's cross-attention
and their serving caches; counterpart of ``repro.models.attention``
(``attn_specs``, ``chunked_attention``, ``banded_swa_attention``,
``naive_attention``, ``flash_attention_vjp``, ``attn_forward``, the KV
caches, ``attn_decode``, the MLA functions, ``cross_attn_specs`` and
``cross_attn_forward``).

Full-sequence attention runs in the reference's order of dispatch: when
``cfg.use_flash_kernel`` and the attention is causal, through the
flash-attention kernel (K3, :func:`repro_torch.kernels.flash_attention`);
else, with ``cfg.banded_swa`` and a window shorter than half the
sequence, on the banded path (each query block against only its visible
key band); else on the chunked online-softmax path (one score block per
``kv_block`` keys, running max and normaliser in float32, masked scores
set to ``MASKED``), or, with ``cfg.flash_vjp``, through
:func:`flash_attention_vjp`, the same online softmax whose backward
recomputes the probabilities instead of storing them (training's path;
K3 has no backward).
MLA always takes the chunked path, in both packages: its q.k width
(``qk_nope_dim + qk_rope_dim``, 192 for deepseek-v2-lite) differs from
its v width (128), while K3 takes one head dim for q, k and v.  So do
bidirectional attention (Whisper's encoder) and cross-attention, which
K3 does not compute (it masks the keys after each query), as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

from .config import ModelConfig
from .layers import apply_rope, rms_norm, rope_angles
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


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    s = D ** -0.5
    return {
        "w_dkv": ParamSpec((D, m.kv_lora_rank), s),
        "w_krope": ParamSpec((D, m.qk_rope_dim), s),
        "kv_ln": ParamSpec((m.kv_lora_rank,), 1.0, init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H * m.qk_nope_dim), m.kv_lora_rank ** -0.5),
        "w_uv": ParamSpec((m.kv_lora_rank, H * m.v_head_dim), m.kv_lora_rank ** -0.5),
        "wq": ParamSpec((D, H * (m.qk_nope_dim + m.qk_rope_dim)), s),
        "wo": ParamSpec((H * m.v_head_dim, D), (H * m.v_head_dim) ** -0.5),
    }


def cross_attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = D ** -0.5
    return {
        "wq": ParamSpec((D, H * hd), s),
        "wk": ParamSpec((D, H * hd), s),
        "wv": ParamSpec((D, H * hd), s),
        "wo": ParamSpec((H * hd, D), (H * hd) ** -0.5),
    }


def _kv_blocks(k: torch.Tensor, v: torch.Tensor, kv_pos: torch.Tensor, kv_block: int):
    """k, v and kv_pos padded to whole ``kv_block``s (padded keys zero, at
    position -1, so masked), as the reference pads them."""
    T = k.shape[1]
    pad = -T % kv_block if T else kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    return k, v, kv_pos


def _block_scores(qf, kc, pc, q_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Masked scores [B, S, K, G, kb] of the scaled queries against one key block."""
    s = torch.einsum("bskgd,btkd->bskgt", qf, kc)
    mask = pc[None, :] >= 0
    if causal:
        mask = mask & (pc[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - pc[None, :] < window)
    return torch.where(mask[None, :, None, None, :], s, MASKED)


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
        s = _block_scores(qf, kc, kv_pos[start:start + kv_block], q_pos, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


class _FlashAttentionVJP(torch.autograd.Function):
    """The reference's ``flash_attention_vjp``: the chunked online softmax
    forward, saving only its output and log-sum-exp; the backward
    recomputes each probability block from them.  Arithmetic in float32
    (float64 for float64 inputs, so that ``gradcheck`` can hold it)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, kv_block):
        B, S, K, G, hd = q.shape
        dt = torch.promote_types(q.dtype, torch.float32)
        kp, vp, pp = _kv_blocks(k, v, kv_pos, kv_block)
        qf = q.to(dt) * hd ** -0.5
        m = torch.full((B, S, K, G), MASKED, dtype=dt, device=q.device)
        l = torch.zeros((B, S, K, G), dtype=dt, device=q.device)
        acc = torch.zeros((B, S, K, G, v.shape[-1]), dtype=dt, device=q.device)
        for start in range(0, kp.shape[1], kv_block):
            blk = slice(start, start + kv_block)
            s = _block_scores(qf, kp[:, blk].to(dt), pp[blk], q_pos, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vp[:, blk].to(dt))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out = (acc / l[..., None]).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.causal, ctx.window, ctx.kv_block = causal, window, kv_block
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        kv_block = ctx.kv_block
        T, hd = k.shape[1], q.shape[-1]
        dt = lse.dtype
        kp, vp, pp = _kv_blocks(k, v, kv_pos, kv_block)
        scale = hd ** -0.5
        qf = q.to(dt) * scale
        do = dout.to(dt)
        drow = torch.einsum("bskgd,bskgd->bskg", do, out.to(dt))
        dq = torch.zeros(qf.shape, dtype=dt, device=q.device)
        dk = torch.empty(kp.shape, dtype=dt, device=q.device)
        dv = torch.empty(vp.shape, dtype=dt, device=q.device)
        for start in range(0, kp.shape[1], kv_block):
            blk = slice(start, start + kv_block)
            kc, vc = kp[:, blk].to(dt), vp[:, blk].to(dt)
            s = _block_scores(qf, kc, pp[blk], q_pos, ctx.causal, ctx.window)
            p = torch.exp(s - lse[..., None])
            dv[:, blk] = torch.einsum("bskgt,bskgd->btkd", p, do)
            dp = torch.einsum("bskgd,btkd->bskgt", do, vc)
            ds = p * (dp - drow[..., None])
            dq += torch.einsum("bskgt,btkd->bskgd", ds, kc)
            dk[:, blk] = torch.einsum("bskgt,bskgd->btkd", ds, qf)
        return ((dq * scale).to(q.dtype), dk[:, :T].to(k.dtype), dv[:, :T].to(v.dtype),
                None, None, None, None, None)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                        window: Optional[int], kv_block: int) -> torch.Tensor:
    """Chunked attention with a flash-style backward: q [B, S, K, G, hd]
    against k, v [B, T, K, hd], keys in blocks of ``kv_block`` (T padded
    to whole blocks with masked keys).  The backward recomputes each
    probability block from q, k and the saved log-sum-exp: O(S·kv_block)
    transients instead of the S·T float32 probabilities that autograd
    through :func:`chunked_attention` keeps.  Counterpart of
    ``repro.models.attention.flash_attention_vjp``, argument for
    argument."""
    return _FlashAttentionVJP.apply(q, k, v, q_pos, kv_pos, causal, window, kv_block)


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


def math_gcd_block(S: int, prefer: int) -> int:
    """The largest block length up to ``prefer`` that divides ``S``."""
    b = min(prefer, S)
    while S % b:
        b -= 1
    return b


def banded_swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, *, window: int,
                         q_block: int = 1024) -> torch.Tensor:
    """Causal sliding-window attention that touches only the key band each
    query block can see: O(S * window) instead of O(S^2).  q [B, S, K, G,
    hd], k and v [B, S, K, hd], ``positions`` [S].  Each block of
    ``q_block`` queries (a divisor of S) takes the ``q_block + window``
    keys that end with it (clamped to the sequence), as the reference."""
    B, S, K, G, hd = q.shape
    if S % q_block:
        q_block = math_gcd_block(S, q_block)
    band = min(q_block + window, S)
    scale = hd ** -0.5
    out = torch.empty_like(q)
    for qi in range(S // q_block):
        s0 = qi * q_block
        start = min(max(s0 + q_block - band, 0), S - band)
        pc = positions[s0:s0 + q_block]
        kv_pos = start + torch.arange(band, device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", q[:, s0:s0 + q_block].float() * scale,
                         k[:, start:start + band].float())
        mask = (kv_pos[None, :] <= pc[:, None]) & (pc[:, None] - kv_pos[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s, MASKED)
        p = torch.softmax(s, dim=-1)
        out[:, s0:s0 + q_block] = torch.einsum(
            "bskgt,btkd->bskgd", p, v[:, start:start + band].float()).to(q.dtype)
    return out


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
    the flash-attention kernel when ``cfg.use_flash_kernel`` (forward
    only), else the banded path when ``cfg.banded_swa`` and ``S > 2 *
    window``; otherwise, causal or not, through :func:`flash_attention_vjp`
    (1024-key blocks) when ``cfg.flash_vjp``, else the chunked path.  With
    ``return_kv`` also returns the post-RoPE ``(k, v)`` for the serving
    cache."""
    B, S = x.shape[:2]
    qg, k, v = _qkv(p, cfg, x, positions)
    if cfg.use_flash_kernel and causal:
        out = kops.flash_attention(qg, k, v, positions, positions,
                                   causal=causal, window=window)
    elif cfg.banded_swa and causal and window is not None and S > 2 * window:
        out = banded_swa_attention(qg, k, v, positions, window=window)
    elif cfg.flash_vjp:
        out = flash_attention_vjp(qg, k, v, positions, positions, causal, window, 1024)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)


def _mla_query(p, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    """The query's no-RoPE and RoPE parts, [B, S, H, nope] and [B, S, H, rope]."""
    m = cfg.mla
    B, S = x.shape[:2]
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., : m.qk_nope_dim], apply_rope(q[..., m.qk_nope_dim:], cos, sin)


def _mla_latent(p, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    """The cached part of a token: c_kv [B, S, R] and k_rope [B, S, rope]
    (one RoPE key shared by every head)."""
    m = cfg.mla
    B, S = x.shape[:2]
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_krope"]).reshape(B, S, 1, m.qk_rope_dim), cos, sin)
    return c_kv, k_rope[:, :, 0]


def mla_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, return_latent: bool = False):
    """Training/prefill path: the latent expanded to per-head K/V, causal
    attention on the chunked path (never K3: see the module docstring).
    With ``return_latent`` also returns ``(c_kv, k_rope)`` for the cache."""
    m = cfg.mla
    H = cfg.n_heads
    B, S = x.shape[:2]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, cfg, x, cos, sin)
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q_nope, q_rope = _mla_query(p, cfg, x, cos, sin)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, m.qk_rope_dim)], dim=-1)
    qg = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, m.qk_nope_dim + m.qk_rope_dim)
    out = chunked_attention(qg, k, v, positions, positions, causal=True, window=None)
    out = out.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty latent cache: ``max_len`` slots of (c_kv, k_rope), ``pos`` -1."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def fill_mla_cache(cache: Dict[str, torch.Tensor], c_kv: torch.Tensor, k_rope: torch.Tensor,
                   positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write prefill latents into the cache (the last ``min(S, size)``
    positions, each at slot ``pos % size``), in place, and return it."""
    size = cache["c_kv"].shape[1]
    take = min(c_kv.shape[1], size)
    pos_t = positions[-take:]
    slots = pos_t % size
    cache["c_kv"][:, slots] = c_kv[:, -take:].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slots] = k_rope[:, -take:].to(cache["k_rope"].dtype)
    cache["pos"][slots] = pos_t.to(torch.int32)
    return cache


def mla_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor],
               position: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed one-token decode: the cache holds only (c_kv, k_rope), and
    the scores are taken in latent space, W_uk absorbed into the query and
    W_uv into the output; slots with ``pos`` in ``[0, position]`` are seen.
    x: [B, 1, D]; ``position`` a Python int (its slot is clamped to the
    cache, as the reference's ``dynamic_update_slice`` does).  Writes the
    token's latents in place."""
    m = cfg.mla
    H = cfg.n_heads
    B = x.shape[0]
    pos_arr = torch.arange(position, position + 1, device=x.device)
    cos, sin = rope_angles(pos_arr, m.qk_rope_dim, cfg.rope_theta)
    c_kv_new, k_rope_new = _mla_latent(p, cfg, x, cos, sin)
    slot = min(max(position, 0), cache["c_kv"].shape[1] - 1)
    cache["c_kv"][:, slot] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    cache["pos"][slot] = position
    ckv, ckr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    q_nope, q_rope = _mla_query(p, cfg, x, cos, sin)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s = (torch.einsum("bshr,btr->bsht", q_lat, ckv.to(x.dtype))
         + torch.einsum("bshn,btn->bsht", q_rope, ckr.to(x.dtype))) * scale
    mask = (cpos >= 0) & (cpos <= position)
    s = torch.where(mask[None, None, None, :], s.to(torch.float32), MASKED)
    pattn = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bsht,btr->bshr", pattn, ckv.to(x.dtype))
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).reshape(B, 1, H * m.v_head_dim)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)


def cross_kv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
             enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of the encoder output ``enc``
    [B, T, D]: each [B, T, H, hd], no RoPE."""
    B, T = enc.shape[:2]
    H, hd = cfg.n_heads, cfg.head_dim
    return (enc @ p["wk"]).reshape(B, T, H, hd), (enc @ p["wv"]).reshape(B, T, H, hd)


def cross_attn_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                       enc: torch.Tensor, *, return_kv: bool = False):
    """Decoder queries x [B, S, D] against every position of the encoder
    output ``enc`` [B, T, D]: bidirectional, one query head per key head,
    no RoPE, on the chunked path.  With ``return_kv`` also returns the
    ``(xk, xv)`` that the serving cache keeps."""
    H, hd = cfg.n_heads, cfg.head_dim
    B, S = x.shape[:2]
    T = enc.shape[1]
    q = (x @ p["wq"]).reshape(B, S, H, 1, hd)
    k, v = cross_kv(p, cfg, enc)
    out = chunked_attention(q, k, v, torch.arange(S, device=x.device),
                            torch.arange(T, device=x.device), causal=False, window=None)
    out = out.reshape(B, S, H * hd) @ p["wo"]
    return (out, (k, v)) if return_kv else out


def cross_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                 xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """One decoder token x [B, 1, D] against the cached cross K/V [B, T,
    H, hd]: a float32 softmax over all T positions, cast to x's dtype
    before the value product (the reference's ``_cross_decode``)."""
    H, hd = cfg.n_heads, cfg.head_dim
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    s = torch.einsum("bshd,bthd->bsht", q.to(torch.float32) * hd ** -0.5, xk.to(torch.float32))
    w = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bsht,bthd->bshd", w, xv).reshape(B, 1, H * hd)
    return o @ p["wo"]
