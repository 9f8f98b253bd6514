"""Model assembly for the dense GQA transformer and the xLSTM stack: the
parameter spec tree, ``forward`` / ``loss_fn`` for training, and
``init_cache`` / ``prefill`` / ``decode_step`` for serving.  Counterpart
of ``repro.models.transformer`` on its ``"attn"``, ``"mlstm"`` and
``"slstm"`` block kinds.  A recurrent block is a residual add around
its mixer with no FFN half, and its serving cache is its state: the
mLSTM's float32 ``[B, H, hd, hd]`` matrix, the sLSTM's ``(c, n, h, m)``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import attention as A
from . import ssm as SSM
from .config import ModelConfig
from .layers import embed_tokens, rms_norm, softmax_cross_entropy, swiglu
from .params import ParamSpec


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s = D ** -0.5
    return {
        "w_gate": ParamSpec((D, F), s),
        "w_up": ParamSpec((D, F), s),
        "w_down": ParamSpec((F, D), F ** -0.5),
    }


def block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    D = cfg.d_model

    def ln():
        return ParamSpec((D,), 1.0, init="ones")

    if kind == "attn":
        return {"ln1": ln(), "attn": A.attn_specs(cfg), "ln2": ln(), "mlp": mlp_specs(cfg)}
    if kind == "mlstm":
        return {"ln1": ln(), "mlstm": SSM.mlstm_specs(cfg)}
    if kind == "slstm":
        return {"ln1": ln(), "slstm": SSM.slstm_specs(cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab_size
    return {
        "embed": ParamSpec((V, D), 1.0 / (D ** 0.5)),
        "layers": [block_specs(cfg, k) for k in cfg.block_pattern],
        "final_ln": ParamSpec((D,), 1.0, init="ones"),
        "lm_head": ParamSpec((D, V), D ** -0.5),
    }


def _window(cfg: ModelConfig, layer: int):
    return cfg.sliding_window if cfg.layer_uses_window(layer) else None


def _mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(xin, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


def _block_forward(p, cfg: ModelConfig, layer: int, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    kind = cfg.block_pattern[layer]
    xin = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mlstm":
        return x + SSM.mlstm_forward(p["mlstm"], cfg, xin)
    if kind == "slstm":
        return x + SSM.slstm_forward(p["slstm"], cfg, xin)
    x = x + A.attn_forward(p["attn"], cfg, xin, positions, causal=True,
                           window=_window(cfg, layer))
    return _mlp(p, cfg, x)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward.  tokens [B, S] -> logits [B, S, V].  (The
    reference also returns an auxiliary loss, which is 0 for these
    blocks.)  With ``cfg.use_flash_kernel`` every mLSTM layer's scan is one
    ``mlstm_scan`` call, which needs S to be a multiple of 128."""
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer, p in enumerate(params["layers"]):
        if cfg.remat:
            x = checkpoint(_block_forward, p, cfg, layer, x, positions, use_reentrant=False)
        else:
            x = _block_forward(p, cfg, layer, x, positions)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x @ params["lm_head"])[..., : cfg.vocab_size]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return softmax_cross_entropy(forward(params, cfg, batch["tokens"]), batch["labels"])


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = "cuda") -> List[Any]:
    """One cache per layer: a KV cache for attention (a windowed layer's
    is a ring buffer of ``min(max_len, window)`` slots; ``dtype`` applies
    to these), the float32 recurrent state for mLSTM and sLSTM."""
    dev = resolve_device(device)
    caches: List[Any] = []
    for layer, kind in enumerate(cfg.block_pattern):
        if kind == "mlstm":
            caches.append(SSM.init_mlstm_state(cfg, batch, dev))
        elif kind == "slstm":
            caches.append(SSM.init_slstm_state(cfg, batch, dev))
        else:
            caches.append(A.init_kv_cache(cfg, batch, max_len, _window(cfg, layer), dtype, dev))
    return caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int, *,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, List[Any]]:
    """Serving prefill: full forward, filling the serving cache.  Returns
    (last-token logits [B, V], cache ready for decode at position S).
    Attention goes through the flash-attention kernel when
    ``cfg.use_flash_kernel``; the recurrent blocks return their final
    state, so the mLSTM takes its plain chunked path whatever the flag."""
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, cache_dtype, x.device)
    for layer, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        xin = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "mlstm":
            h, cache[layer] = SSM.mlstm_forward(p["mlstm"], cfg, xin, return_state=True)
            x = x + h
            continue
        if kind == "slstm":
            h, cache[layer] = SSM.slstm_forward(p["slstm"], cfg, xin, return_state=True)
            x = x + h
            continue
        h, (k, v) = A.attn_forward(p["attn"], cfg, xin, positions, causal=True,
                                   window=_window(cfg, layer), return_kv=True)
        A.fill_kv_cache(cache[layer], k, v, positions)
        x = _mlp(p, cfg, x + h)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, -1] @ params["lm_head"])[:, : cfg.vocab_size], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: List[Any],
                position: int) -> Tuple[torch.Tensor, List[Any]]:
    """One-token decode at ``position`` (a Python int): token [B] ->
    (logits [B, V], cache).  Updates the cache in place (KV caches are
    written, recurrent states replaced in the list) and returns it."""
    x = embed_tokens(params["embed"], token[:, None])
    for layer, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        xin = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "mlstm":
            h, cache[layer] = SSM.mlstm_decode(p["mlstm"], cfg, xin, cache[layer])
            x = x + h
            continue
        if kind == "slstm":
            h, cache[layer] = SSM.slstm_decode(p["slstm"], cfg, xin, cache[layer])
            x = x + h
            continue
        h, _ = A.attn_decode(p["attn"], cfg, xin, cache[layer], position,
                             window=_window(cfg, layer))
        x = _mlp(p, cfg, x + h)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, 0] @ params["lm_head"])[:, : cfg.vocab_size], cache
