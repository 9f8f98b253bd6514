"""Model assembly for the dense GQA transformer: the parameter spec tree
and ``forward`` / ``loss_fn`` for training.  Counterpart of
``repro.models.transformer`` on its ``"attn"`` block kind."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
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
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")

    def ln():
        return ParamSpec((D,), 1.0, init="ones")

    return {"ln1": ln(), "attn": A.attn_specs(cfg), "ln2": ln(), "mlp": mlp_specs(cfg)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab_size
    return {
        "embed": ParamSpec((V, D), 1.0 / (D ** 0.5)),
        "layers": [block_specs(cfg, k) for k in cfg.block_pattern],
        "final_ln": ParamSpec((D,), 1.0, init="ones"),
        "lm_head": ParamSpec((D, V), D ** -0.5),
    }


def _block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    x = x + A.attn_forward(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                           positions, causal=True)
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(xin, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward.  tokens [B, S] -> logits [B, S, V].  (The
    reference also returns an auxiliary loss, which is 0 for dense blocks.)"""
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block_forward, p, cfg, x, positions, use_reentrant=False)
        else:
            x = _block_forward(p, cfg, x, positions)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x @ params["lm_head"])[..., : cfg.vocab_size]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return softmax_cross_entropy(forward(params, cfg, batch["tokens"]), batch["labels"])
