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
continues at position ``P + S``.

An encoder-decoder config (``cfg.is_encdec``, whisper) builds every
``"attn"`` layer as the decoder block ``"xattn"``: causal self-attention,
cross-attention over the encoder's output, the GELU MLP.  ``forward``,
``loss_fn`` and ``prefill`` then take ``enc_frames`` ``[B, T, 128]``:
stub frame features (the mel frontend is not modelled, as in the
reference), which :func:`encode` projects by ``frontend``, adds sinusoidal
positions to and runs through ``enc_layers`` of bidirectional attention
(with RoPE, as the reference applies it) and the MLP.  Such a layer's
serving cache is ``{"kv": its KV cache, "xk", "xv": the cross K/V of the
encoder output, [B, T, H, hd]}``; :func:`init_cache` leaves the cross
K/V None, and :func:`prefill` (or :func:`prefill_cross_cache`) fills
them."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import attention as A
from . import hybrid as HY
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from .layers import (
    embed_tokens,
    gelu_mlp,
    rms_norm,
    sinusoidal_positions,
    softmax_cross_entropy,
    swiglu,
)
from .params import ParamSpec

AUDIO_FRONTEND_DIM = 128    # width of the stub frame features (the reference's mel bins)
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
    if kind == "xattn":  # whisper decoder block
        return {"ln1": ln(), "attn": A.attn_specs(cfg), "lnx": ln(),
                "xattn": A.cross_attn_specs(cfg), "ln2": ln(), "mlp": mlp_specs(cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _kind(cfg: ModelConfig, layer: int) -> str:
    """The block a layer is built as: an encoder-decoder's ``"attn"``
    layers are ``"xattn"`` decoder blocks."""
    kind = cfg.block_pattern[layer]
    return "xattn" if cfg.is_encdec and kind == "attn" else kind


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab_size
    specs = {
        "embed": ParamSpec((V, D), 1.0 / (D ** 0.5)),
        "layers": [block_specs(cfg, _kind(cfg, i)) for i in range(cfg.n_layers)],
        "final_ln": ParamSpec((D,), 1.0, init="ones"),
        "lm_head": ParamSpec((D, V), D ** -0.5),
    }
    if cfg.is_encdec:
        specs["frontend"] = ParamSpec((AUDIO_FRONTEND_DIM, D), AUDIO_FRONTEND_DIM ** -0.5)
        specs["enc_layers"] = [block_specs(cfg, "attn") for _ in range(cfg.encoder.n_layers)]
        specs["enc_final_ln"] = ParamSpec((D,), 1.0, init="ones")
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
                   positions: torch.Tensor, enc_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: ``(x, aux)``; a decoder block also attends over
    ``enc_out``."""
    kind = _kind(cfg, layer)
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
        if kind == "xattn":
            x = x + A.cross_attn_forward(p["xattn"], cfg, rms_norm(x, p["lnx"], cfg.norm_eps),
                                         enc_out)
    return _ffn(p, cfg, kind, x)


def _encoder_block(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    h = A.attn_forward(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                       causal=False, window=None)
    return _ffn(p, cfg, "attn", x + h)[0]


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over stub frame features ``frames`` [B, T, 128]:
    the frontend projection plus sinusoidal positions, then every encoder
    layer (bidirectional attention on the chunked path, whatever
    ``cfg.use_flash_kernel``, and the MLP), then the final norm.
    Returns [B, T, D]."""
    x = frames @ params["frontend"]
    T = x.shape[1]
    x = x + sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(T, device=x.device)
    for p in params["enc_layers"]:
        if cfg.remat:
            x = checkpoint(_encoder_block, p, cfg, x, positions, use_reentrant=False)
        else:
            x = _encoder_block(p, cfg, x, positions)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def _encode_frames(params, cfg: ModelConfig, enc_frames) -> Optional[torch.Tensor]:
    """The encoder output of an encoder-decoder config, else None."""
    if not cfg.is_encdec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.arch_id} is an encoder-decoder: pass enc_frames "
                         f"[B, {cfg.encoder.seq_len}, {AUDIO_FRONTEND_DIM}]")
    return encode(params, cfg, enc_frames)


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
            vision_embeds=None, enc_frames=None):
    """Full-sequence forward.  tokens [B, S] -> logits [B, S, V], or with
    ``return_aux`` ``(logits, aux)``: the sum over the MoE layers of their
    load-balance loss (0 without MoE layers), which the reference's
    forward always returns beside the logits.  A VLM needs
    ``vision_embeds`` [B, P, 1024], an encoder-decoder ``enc_frames``
    [B, T, 128] (see the module docstring).  With
    ``cfg.use_flash_kernel`` every GQA layer's attention (Hymba's
    included) is one K3 launch and every mLSTM layer's scan one
    ``mlstm_scan`` call, which need the sequence (prefix included) to be
    a multiple of 128."""
    x = _embed(params, cfg, tokens, vision_embeds)
    enc_out = _encode_frames(params, cfg, enc_frames)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(params["layers"]):
        if cfg.remat:
            x, aux = checkpoint(_block_forward, p, cfg, layer, x, positions, enc_out,
                                use_reentrant=False)
        else:
            x, aux = _block_forward(p, cfg, layer, x, positions, enc_out)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)[:, cfg.vision_prefix_len:]
    logits = (x @ params["lm_head"])[..., : cfg.vocab_size]
    return (logits, aux_total) if return_aux else logits


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token cross entropy plus the MoE load-balance loss, as the
    reference's; a VLM's batch carries ``"vision_embeds"``, an
    encoder-decoder's ``"enc_frames"``."""
    logits, aux = forward(params, cfg, batch["tokens"], return_aux=True,
                          vision_embeds=batch.get("vision_embeds"),
                          enc_frames=batch.get("enc_frames"))
    return softmax_cross_entropy(logits, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: DeviceLike = "cuda") -> List[Any]:
    """One cache per layer: a KV cache for GQA attention (a windowed
    layer's is a ring buffer of ``min(max_len, window)`` slots), the
    latent cache for MLA (``dtype`` applies to these two), the float32
    recurrent state for mLSTM and sLSTM, and for Hymba a KV cache beside
    the Mamba state (float32 ``h``, conv buffer in ``dtype``); an
    encoder-decoder's layer ``{"kv": its KV cache, "xk": None, "xv":
    None}``, the cross K/V left for the prefill to fill."""
    dev = resolve_device(device)
    caches: List[Any] = []
    for layer in range(cfg.n_layers):
        kind = _kind(cfg, layer)
        if kind == "xattn":
            caches.append({"kv": A.init_kv_cache(cfg, batch, max_len, None, dtype, dev),
                           "xk": None, "xv": None})
        elif kind == "mlstm":
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
            cache_dtype=torch.bfloat16, vision_embeds=None,
            enc_frames=None) -> Tuple[torch.Tensor, List[Any]]:
    """Serving prefill: full forward, filling the serving cache.  Returns
    (last-token logits [B, V], cache ready for decode at position S, or
    P + S behind a VLM's P-patch prefix, which ``max_len`` must hold).
    GQA attention goes through the flash-attention kernel when
    ``cfg.use_flash_kernel`` (one launch per ``attn`` / ``attn_moe`` /
    ``hymba`` layer and per decoder layer of an encoder-decoder, whose
    encoder and cross-attention, being bidirectional, stay on the chunked
    path, as MLA does); an encoder-decoder's cross K/V are those of the
    encoder output of ``enc_frames``, kept in the encoder output's dtype
    (as the reference keeps them, whatever ``cache_dtype``); the
    recurrent blocks return their final state, so the mLSTM takes its
    plain chunked path whatever the flag.  The MoE layers' aux loss is dropped, as in the
    reference."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, vision_embeds)
    enc_out = _encode_frames(params, cfg, enc_frames)
    positions = torch.arange(x.shape[1], device=x.device)
    cache = init_cache(cfg, B, max_len, cache_dtype, x.device)
    for layer, p in enumerate(params["layers"]):
        kind = _kind(cfg, layer)
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
        elif kind == "xattn":
            h, (k, v) = A.attn_forward(p["attn"], cfg, xin, positions, causal=True,
                                       window=None, return_kv=True)
            A.fill_kv_cache(cache[layer]["kv"], k, v, positions)
            x = x + h
            h, (cache[layer]["xk"], cache[layer]["xv"]) = A.cross_attn_forward(
                p["xattn"], cfg, rms_norm(x, p["lnx"], cfg.norm_eps), enc_out, return_kv=True)
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
    one token as a group of 1; an encoder-decoder's layers attend over
    their cached cross K/V after the self-attention."""
    x = embed_tokens(params["embed"], token[:, None])
    for layer, p in enumerate(params["layers"]):
        kind = _kind(cfg, layer)
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
        elif kind == "xattn":
            c = cache[layer]
            h, _ = A.attn_decode(p["attn"], cfg, xin, c["kv"], position, window=None)
            x = x + h
            h = A.cross_decode(p["xattn"], cfg, rms_norm(x, p["lnx"], cfg.norm_eps),
                               c["xk"], c["xv"])
        else:
            h, _ = A.attn_decode(p["attn"], cfg, xin, cache[layer], position,
                                 window=_window(cfg, layer))
        x, _ = _ffn(p, cfg, kind, x + h)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, 0] @ params["lm_head"])[:, : cfg.vocab_size], cache


def prefill_cross_cache(params, cfg: ModelConfig,
                        enc_out: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every decoder layer's cross ``(xk, xv)`` [B, T, H, hd] of the
    encoder output ``enc_out`` [B, T, D], for a cache from
    :func:`init_cache`."""
    return [A.cross_kv(p["xattn"], cfg, enc_out) for p in params["layers"]]
