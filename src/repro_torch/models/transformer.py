"""Model assembly for the decoder-only transformers (dense GQA/MQA, MoE,
DeepSeek MLA, the vision-prefix backbone), the xLSTM stack and the Hymba
hybrid: the parameter spec tree, ``forward`` / ``loss_fn`` for training,
and ``init_cache`` / ``prefill`` / ``decode_step`` for serving.
Counterpart of ``repro.models.transformer`` on its ``"attn"``,
``"attn_moe"``, ``"mla"``, ``"mla_moe"``, ``"mlstm"``, ``"slstm"`` and
``"hymba"`` block kinds and its vision prefix.  An attention block (GQA,
MLA or Hymba's parallel attention and Mamba heads) is followed by an FFN
half: the routed experts for the ``*_moe`` kinds, else the SwiGLU or GELU
MLP.  A recurrent block is a residual add around its mixer with no FFN
half, and its serving cache is its state: the mLSTM's float32 ``[B, H,
hd, hd]`` matrix, the sLSTM's ``(c, n, h, m)``; an MLA layer caches only
its latents ``(c_kv, k_rope)``; a Hymba layer ``{"kv": its KV cache,
"ssm": (h, conv buffer)}``.

With ``cfg.vision_prefix_len`` (a VLM backbone) ``forward``, ``loss_fn``
and ``prefill`` take ``vision_embeds`` ``[B, P, 1024]``: stub patch
embeddings (the vision encoder is not modelled, as in the reference),
projected by ``vision_proj`` and put ahead of the tokens; the prefix
takes positions ``0..P-1`` and is dropped before the head, so decode
continues at position ``P + S``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import attention as A
from . import hybrid as HY
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from .layers import embed_tokens, gelu_mlp, rms_norm, softmax_cross_entropy, swiglu
from .params import ParamSpec

VISION_FRONTEND_DIM = 1024  # width of the stub patch embeddings (the reference's)


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s = D ** -0.5
    if cfg.mlp_variant == "gelu":
        return {
            "w_up": ParamSpec((D, F), s),
            "b_up": ParamSpec((F,), 0.0, init="zeros"),
            "w_down": ParamSpec((F, D), F ** -0.5),
            "b_down": ParamSpec((D,), 0.0, init="zeros"),
        }
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
    if kind == "attn_moe":
        return {"ln1": ln(), "attn": A.attn_specs(cfg), "ln2": ln(), "moe": MOE.moe_specs(cfg)}
    if kind == "mla":
        return {"ln1": ln(), "attn": A.mla_specs(cfg), "ln2": ln(), "mlp": mlp_specs(cfg)}
    if kind == "mla_moe":
        return {"ln1": ln(), "attn": A.mla_specs(cfg), "ln2": ln(), "moe": MOE.moe_specs(cfg)}
    if kind == "mlstm":
        return {"ln1": ln(), "mlstm": SSM.mlstm_specs(cfg)}
    if kind == "slstm":
        return {"ln1": ln(), "slstm": SSM.slstm_specs(cfg)}
    if kind == "hymba":
        return {"ln1": ln(), "hymba": HY.hymba_specs(cfg), "ln2": ln(), "mlp": mlp_specs(cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab_size
    specs = {
        "embed": ParamSpec((V, D), 1.0 / (D ** 0.5)),
        "layers": [block_specs(cfg, k) for k in cfg.block_pattern],
        "final_ln": ParamSpec((D,), 1.0, init="ones"),
        "lm_head": ParamSpec((D, V), D ** -0.5),
    }
    if cfg.vision_prefix_len:
        specs["vision_proj"] = ParamSpec((VISION_FRONTEND_DIM, D), VISION_FRONTEND_DIM ** -0.5)
    return specs


def _window(cfg: ModelConfig, layer: int):
    return cfg.sliding_window if cfg.layer_uses_window(layer) else None


def _ffn(p, cfg: ModelConfig, kind: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN half of an attention block: ``(x + ffn(rms_norm(x)), aux)``,
    the routed experts' load-balance loss as aux (0 for a dense MLP)."""
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind in ("attn_moe", "mla_moe"):
        h, aux = MOE.moe_forward(p["moe"], cfg, xin)
        return x + h, aux
    m = p["mlp"]
    if cfg.mlp_variant == "gelu":
        h = gelu_mlp(xin, m["w_up"], m["b_up"], m["w_down"], m["b_down"])
    else:
        h = swiglu(xin, m["w_gate"], m["w_up"], m["w_down"])
    return x + h, torch.zeros((), device=x.device)


def _block_forward(p, cfg: ModelConfig, layer: int, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: ``(x, aux)``."""
    kind = cfg.block_pattern[layer]
    xin = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mlstm":
        return x + SSM.mlstm_forward(p["mlstm"], cfg, xin), torch.zeros((), device=x.device)
    if kind == "slstm":
        return x + SSM.slstm_forward(p["slstm"], cfg, xin), torch.zeros((), device=x.device)
    if kind in ("mla", "mla_moe"):
        x = x + A.mla_forward(p["attn"], cfg, xin, positions)
    elif kind == "hymba":
        x = x + HY.hymba_forward(p["hymba"], cfg, xin, positions, layer)
    else:
        x = x + A.attn_forward(p["attn"], cfg, xin, positions, causal=True,
                               window=_window(cfg, layer))
    return _ffn(p, cfg, kind, x)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, vision_embeds) -> torch.Tensor:
    """Token embeddings, behind the projected vision prefix for a VLM."""
    x = embed_tokens(params["embed"], tokens)
    if not cfg.vision_prefix_len:
        return x
    if vision_embeds is None:
        raise ValueError(f"{cfg.arch_id} has a {cfg.vision_prefix_len}-patch vision prefix: "
                         "pass vision_embeds [B, P, 1024]")
    prefix = vision_embeds @ params["vision_proj"]
    return torch.cat([prefix.to(x.dtype), x], dim=1)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, return_aux: bool = False,
            vision_embeds=None):
    """Full-sequence forward.  tokens [B, S] -> logits [B, S, V], or with
    ``return_aux`` ``(logits, aux)``: the sum over the MoE layers of their
    load-balance loss (0 without MoE layers), which the reference's
    forward always returns beside the logits.  A VLM needs
    ``vision_embeds`` [B, P, 1024] (see the module docstring).  With
    ``cfg.use_flash_kernel`` every GQA layer's attention (Hymba's
    included) is one K3 launch and every mLSTM layer's scan one
    ``mlstm_scan`` call, which need the sequence (prefix included) to be
    a multiple of 128."""
    x = _embed(params, cfg, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(params["layers"]):
        if cfg.remat:
            x, aux = checkpoint(_block_forward, p, cfg, layer, x, positions, use_reentrant=False)
        else:
            x, aux = _block_forward(p, cfg, layer, x, positions)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)[:, cfg.vision_prefix_len:]
    logits = (x @ params["lm_head"])[..., : cfg.vocab_size]
    return (logits, aux_total) if return_aux else logits


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token cross entropy plus the MoE load-balance loss, as the
    reference's; a VLM's batch carries ``"vision_embeds"``."""
    logits, aux = forward(params, cfg, batch["tokens"], return_aux=True,
                          vision_embeds=batch.get("vision_embeds"))
    return softmax_cross_entropy(logits, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = "cuda") -> List[Any]:
    """One cache per layer: a KV cache for GQA attention (a windowed
    layer's is a ring buffer of ``min(max_len, window)`` slots), the
    latent cache for MLA (``dtype`` applies to these two), the float32
    recurrent state for mLSTM and sLSTM, and for Hymba a KV cache beside
    the Mamba state (float32 ``h``, conv buffer in ``dtype``)."""
    dev = resolve_device(device)
    caches: List[Any] = []
    for layer, kind in enumerate(cfg.block_pattern):
        if kind == "mlstm":
            caches.append(SSM.init_mlstm_state(cfg, batch, dev))
        elif kind == "slstm":
            caches.append(SSM.init_slstm_state(cfg, batch, dev))
        elif kind in ("mla", "mla_moe"):
            caches.append(A.init_mla_cache(cfg, batch, max_len, dtype, dev))
        elif kind == "hymba":
            caches.append(HY.init_hymba_cache(cfg, batch, max_len, layer, dtype, dev))
        else:
            caches.append(A.init_kv_cache(cfg, batch, max_len, _window(cfg, layer), dtype, dev))
    return caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int, *,
            cache_dtype=torch.bfloat16, vision_embeds=None) -> Tuple[torch.Tensor, List[Any]]:
    """Serving prefill: full forward, filling the serving cache.  Returns
    (last-token logits [B, V], cache ready for decode at position S, or
    P + S behind a VLM's P-patch prefix, which ``max_len`` must hold).
    GQA attention goes through the flash-attention kernel when
    ``cfg.use_flash_kernel`` (one launch per ``attn`` / ``attn_moe`` /
    ``hymba`` layer; MLA stays on the chunked path); the recurrent blocks
    return their final state, so the mLSTM takes its plain chunked path
    whatever the flag.  The MoE layers' aux loss is dropped, as in the
    reference."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
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
        if kind in ("mla", "mla_moe"):
            h, (c_kv, k_rope) = A.mla_forward(p["attn"], cfg, xin, positions,
                                              return_latent=True)
            A.fill_mla_cache(cache[layer], c_kv, k_rope, positions)
        elif kind == "hymba":
            h, ((k, v), cache[layer]["ssm"]) = HY.hymba_forward(p["hymba"], cfg, xin, positions,
                                                                layer, return_cache=True)
            A.fill_kv_cache(cache[layer]["kv"], k, v, positions)
        else:
            h, (k, v) = A.attn_forward(p["attn"], cfg, xin, positions, causal=True,
                                       window=_window(cfg, layer), return_kv=True)
            A.fill_kv_cache(cache[layer], k, v, positions)
        x, _ = _ffn(p, cfg, kind, x + h)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, -1] @ params["lm_head"])[:, : cfg.vocab_size], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: List[Any],
                position: int) -> Tuple[torch.Tensor, List[Any]]:
    """One-token decode at ``position`` (a Python int): token [B] ->
    (logits [B, V], cache).  Updates the cache in place (KV and latent
    caches are written, recurrent states replaced in the list or, for
    Hymba, in the layer's dict) and returns it; the MoE layers route the
    one token as a group of 1."""
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
        if kind in ("mla", "mla_moe"):
            h, _ = A.mla_decode(p["attn"], cfg, xin, cache[layer], position)
        elif kind == "hymba":
            h, _ = HY.hymba_decode(p["hymba"], cfg, xin, cache[layer], position, layer)
        else:
            h, _ = A.attn_decode(p["attn"], cfg, xin, cache[layer], position,
                                 window=_window(cfg, layer))
        x, _ = _ffn(p, cfg, kind, x + h)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, 0] @ params["lm_head"])[:, : cfg.vocab_size], cache
