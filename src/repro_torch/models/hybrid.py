"""Hymba-style hybrid block: attention heads and Mamba (SSM) heads run in
parallel on the same input; their RMS-normed outputs are averaged
[arXiv:2411.13676].  Attention uses a sliding window in all but every
``global_attn_every``-th layer.  Counterpart of ``repro.models.hybrid``.

The attention half goes through K3 in a full-sequence pass when
``cfg.use_flash_kernel`` (as every GQA layer does); the Mamba half is the
chunked selective scan of :mod:`.ssm`.  The serving cache of a layer is
``{"kv": its (ring-buffered) KV cache, "ssm": (h, conv buffer)}``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device

from .attention import attn_decode, attn_forward, attn_specs, init_kv_cache
from .config import ModelConfig
from .layers import rms_norm
from .params import ParamSpec
from .ssm import init_mamba_state, mamba_decode, mamba_forward, mamba_specs


def hymba_d_inner(cfg: ModelConfig) -> int:
    """The Mamba head's width matches the attention width (parallel heads)."""
    return cfg.n_heads * cfg.head_dim


def hymba_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    return {
        "attn": attn_specs(cfg),
        "mamba": mamba_specs(cfg, hymba_d_inner(cfg)),
        "attn_ln": ParamSpec((D,), 1.0, init="ones"),
        "mamba_ln": ParamSpec((D,), 1.0, init="ones"),
    }


def _window(cfg: ModelConfig, layer: int):
    return cfg.sliding_window if cfg.layer_uses_window(layer) else None


def _merge(p, cfg: ModelConfig, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (rms_norm(a, p["attn_ln"], cfg.norm_eps)
                  + rms_norm(m, p["mamba_ln"], cfg.norm_eps))


def hymba_forward(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, layer: int, *,
                  return_cache: bool = False):
    """x [B, S, D] -> [B, S, D]; with ``return_cache`` also ``((k, v),
    (h, conv buffer))`` for the serving cache."""
    a = attn_forward(p["attn"], cfg, x, positions, causal=True, window=_window(cfg, layer),
                     return_kv=return_cache)
    m = mamba_forward(p["mamba"], cfg, x, hymba_d_inner(cfg), return_state=return_cache)
    if not return_cache:
        return _merge(p, cfg, a, m)
    (a, kv), (m, st) = a, m
    return _merge(p, cfg, a, m), (kv, st)


def hymba_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict[str, Any], position: int,
                 layer: int):
    """One token: x [B, 1, D] -> (out, cache).  The KV cache is written in
    place; the Mamba state is replaced in the cache dict."""
    a, cache["kv"] = attn_decode(p["attn"], cfg, x, cache["kv"], position,
                                 window=_window(cfg, layer))
    m, cache["ssm"] = mamba_decode(p["mamba"], cfg, x, cache["ssm"], hymba_d_inner(cfg))
    return _merge(p, cfg, a, m), cache


def init_hymba_cache(cfg: ModelConfig, batch: int, max_len: int, layer: int, dtype,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return {"kv": init_kv_cache(cfg, batch, max_len, _window(cfg, layer), dtype, dev),
            "ssm": init_mamba_state(cfg, batch, hymba_d_inner(cfg), dtype, dev)}
