"""Analytic FLOP model — exact matmul accounting per (arch x shape).

Counterpart of ``repro.launch.analytic_model``, the same formulas in the
same order of operations, so the counts are the same floats.  It counts
every matmul from the config's shapes: backward = 2x forward, and
rematerialisation (``cfg.remat``) adds one more forward.  The dry run
(:mod:`repro_torch.launch.dryrun`) divides these counts by the card's
rates for its compute bound.

As in the reference, an encoder-decoder's :func:`forward_flops` adds the
whole encoder over its frames even with ``decode=True``, although a
decode step reads cached cross K/V and never runs the encoder: whisper's
``decode_32k`` count is almost all encoder.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models import ModelConfig

MLSTM_CHUNK = 128


def _attn_T_eff(S: int, T: int, causal: bool, window) -> float:
    """Average number of visible KV positions per query."""
    if window is not None:
        return min(window, (S + 1) / 2 if causal and T == S else T)
    if causal and T == S:
        return (S + 1) / 2
    return T


def _layer_flops(cfg: ModelConfig, kind: str, layer: int, S: int,
                 T: int, decode: bool) -> float:
    """Forward FLOPs for one layer over S query tokens with T KV context."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F = cfg.d_ff
    f = 0.0
    if kind in ("attn", "attn_moe", "xattn"):
        window = cfg.sliding_window if cfg.layer_uses_window(layer) else None
        Te = _attn_T_eff(S, T, True, window)
        f += 2 * S * D * (H + 2 * K) * hd          # qkv proj
        f += 4 * S * Te * H * hd                    # qk^T + pv
        f += 2 * S * H * hd * D                     # out proj
        if kind == "xattn":
            Tenc = cfg.encoder.seq_len
            f += 2 * S * D * H * hd * 3 + 4 * S * Tenc * H * hd + 2 * S * H * hd * D
    elif kind in ("mla", "mla_moe"):
        m = cfg.mla
        R = m.kv_lora_rank
        qk = m.qk_nope_dim + m.qk_rope_dim
        Te = _attn_T_eff(S, T, True, None)
        f += 2 * S * D * R                          # down-proj
        f += 2 * S * R * H * (m.qk_nope_dim + m.v_head_dim)  # up-proj
        f += 2 * S * D * H * qk                     # wq
        f += 2 * S * Te * H * qk + 2 * S * Te * H * m.v_head_dim
        f += 2 * S * H * m.v_head_dim * D           # wo
    elif kind == "mlstm":
        e = cfg.ssm.expand if cfg.ssm else 2
        Di = e * D
        hdi = Di // H
        f += 2 * S * D * 2 * Di                     # up
        f += 3 * 2 * S * Di * Di                    # q,k,v
        if decode:
            f += 4 * S * H * hdi * hdi              # state update + readout
        else:
            C = min(MLSTM_CHUNK, S)
            f += H * (4 * S * C * hdi + 4 * S * hdi * hdi)
        f += 2 * S * Di * D                         # down
        return f
    elif kind == "slstm":
        dh = D // H
        f += 2 * S * D * 4 * D + 8 * S * D * dh
        f += 2 * S * D * D
        return f
    elif kind == "hymba":
        window = cfg.sliding_window if cfg.layer_uses_window(layer) else None
        Te = _attn_T_eff(S, T, True, window)
        f += 2 * S * D * (H + 2 * K) * hd + 4 * S * Te * H * hd + 2 * S * H * hd * D
        # mamba head
        Di = H * hd
        st = cfg.ssm.d_state if cfg.ssm else 16
        dtr = max(1, D // 16)
        f += 2 * S * D * 2 * Di + 2 * S * Di * 2 * st
        f += 2 * S * Di * dtr * 2 + 6 * S * Di * st + 2 * S * Di * D
    else:
        raise KeyError(kind)
    # FFN half
    if kind in ("attn_moe", "mla_moe"):
        m = cfg.moe
        f += 2 * S * D * m.n_experts                # router
        f += 6 * S * m.top_k * D * m.d_expert       # routed experts
        if m.n_shared:
            f += 6 * S * D * m.n_shared * (m.d_shared or m.d_expert)
    elif F:
        f += (4 if cfg.mlp_variant == "gelu" else 6) * S * D * F
    return f


def forward_flops(cfg: ModelConfig, S: int, T: int, *, decode: bool = False) -> float:
    """Per-sequence forward FLOPs (S new tokens, T total context)."""
    total = 0.0
    for layer, kind in enumerate(cfg.block_pattern):
        k = "xattn" if (cfg.is_encdec and kind == "attn") else kind
        total += _layer_flops(cfg, k, layer, S, T, decode)
    if cfg.is_encdec:
        Tenc = cfg.encoder.seq_len
        for layer in range(cfg.encoder.n_layers):
            total += _layer_flops(cfg, "attn", layer, Tenc, Tenc, False)
    total += 2 * S * cfg.d_model * cfg.padded_vocab_size  # lm head
    return total


def analytic_step_flops(cfg: ModelConfig, shape_spec: Dict, kind: str) -> float:
    """Whole-step FLOPs across the global batch (all silos)."""
    S, B = shape_spec["seq_len"], shape_spec["global_batch"]
    if kind == "train":
        S_tok = S - cfg.vision_prefix_len
        fwd = forward_flops(cfg, S, S)
        # bwd = 2x fwd; remat recompute ~= +1 fwd
        mult = 3.0 + (1.0 if cfg.remat else 0.0)
        return mult * fwd * B
    if kind == "prefill":
        return forward_flops(cfg, S, S) * B
    return forward_flops(cfg, 1, S, decode=True) * B
