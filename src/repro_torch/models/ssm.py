"""Recurrent blocks of xLSTM: the mLSTM (chunked gated linear attention)
and the sLSTM (scalar memory with exponential gating).  Counterpart of
the mLSTM and sLSTM halves of ``repro.models.ssm``; the Mamba head of
the Hymba block is not ported yet.

The mLSTM's full-sequence path is the chunkwise-parallel scan.  With
``cfg.use_flash_kernel`` and no state asked for (the ``forward`` of
training and scoring), it goes through the ``mlstm_scan`` wrapper: K4 on
the card, its plain version on the CPU.  Prefill asks for the final
state, which the kernel does not return, so it takes the plain chunked
path, as the reference does.  Decode is one recurrent state update.  The
sLSTM is a per-token recurrence in any mode: a Python loop over time,
where the reference has a ``lax.scan``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.mlstm_scan import mlstm_chunked_ref

from .config import ModelConfig
from .layers import rms_norm
from .params import ParamSpec

SLSTMState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): internal up-projection, per-head scalar gates.


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head dim) of the mLSTM."""
    Di = (cfg.ssm.expand if cfg.ssm else 2) * cfg.d_model
    return Di, cfg.n_heads, Di // cfg.n_heads


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    Di, H, _ = _mlstm_dims(cfg)
    s = D ** -0.5
    si = Di ** -0.5
    return {
        "w_up": ParamSpec((D, 2 * Di), s),          # x branch + gate z
        "w_q": ParamSpec((Di, Di), si),
        "w_k": ParamSpec((Di, Di), si),
        "w_v": ParamSpec((Di, Di), si),
        "w_if": ParamSpec((Di, 2 * H), si),         # input & forget gates
        "b_if": ParamSpec((2 * H,), 0.0, init="zeros"),
        "out_ln": ParamSpec((Di,), 1.0, init="ones"),
        "w_down": ParamSpec((Di, D), si),
    }


def _mlstm_gates(p, xu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head log-space gates (float32): log input gate, log forget gate."""
    i_raw, f_raw = (xu @ p["w_if"] + p["b_if"]).float().chunk(2, dim=-1)
    log_f = F.logsigmoid(f_raw)                   # <= 0
    log_i = i_raw - F.softplus(i_raw)             # stabilised log sigmoid(i)
    return log_i, log_f


def _mlstm_out(p, cfg: ModelConfig, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (rms_norm(h, p["out_ln"], cfg.norm_eps) * F.silu(z)) @ p["w_down"]


def mlstm_forward(p, cfg: ModelConfig, x: torch.Tensor, chunk: int = 128, *,
                  return_state: bool = False):
    """x [B, S, D] -> [B, S, D] (and the final ``[B, H, hd, hd]`` state
    with ``return_state``).  Gated linear attention without the mLSTM's
    normaliser, with an RMS output norm instead, as the reference."""
    Di, H, hd = _mlstm_dims(cfg)
    B, S, _ = x.shape
    xu, z = (x @ p["w_up"]).chunk(2, dim=-1)      # [B, S, Di] each
    q = (xu @ p["w_q"]).reshape(B, S, H, hd)
    k = (xu @ p["w_k"]).reshape(B, S, H, hd) * (hd ** -0.5)
    v = (xu @ p["w_v"]).reshape(B, S, H, hd)
    log_i, log_f = _mlstm_gates(p, xu)            # [B, S, H]
    state = None
    if cfg.use_flash_kernel and not return_state:
        h = kops.mlstm_scan(q, k, v, log_i, log_f, chunk=chunk)
    else:
        h, state = mlstm_chunked_ref(q, k, v, log_i, log_f, chunk=chunk, return_state=True)
    out = _mlstm_out(p, cfg, h.reshape(B, S, Di), z)
    return (out, state) if return_state else out


def mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x [B, 1, D], state [B, H, hd, hd] float32 -> (out, state)."""
    Di, H, hd = _mlstm_dims(cfg)
    B = x.shape[0]
    xu, z = (x @ p["w_up"]).chunk(2, dim=-1)
    q = (xu @ p["w_q"]).reshape(B, H, hd).float()
    k = ((xu @ p["w_k"]) * (hd ** -0.5)).reshape(B, H, hd).float()
    v = (xu @ p["w_v"]).reshape(B, H, hd).float()
    log_i, log_f = _mlstm_gates(p, xu)            # [B, 1, H]
    i_g = torch.exp(log_i[:, 0])[..., None, None]
    f_g = torch.exp(log_f[:, 0])[..., None, None]
    state = f_g * state + i_g * torch.einsum("bhd,bhe->bhde", k, v)
    h = torch.einsum("bhd,bhde->bhe", q, state).reshape(B, 1, Di).to(x.dtype)
    return _mlstm_out(p, cfg, h, z), state


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    _, H, hd = _mlstm_dims(cfg)
    return torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                       device=resolve_device(device))


# ---------------------------------------------------------------------------
# sLSTM block: scalar memory, exponential gating, block-diagonal recurrence.


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    s = D ** -0.5
    return {
        "w": ParamSpec((D, 4 * D), s),             # i, f, z, o pre-activations
        "r": ParamSpec((H, dh, 4 * dh), dh ** -0.5),
        "b": ParamSpec((4 * D,), 0.0, init="zeros"),
        "out_ln": ParamSpec((D,), 1.0, init="ones"),
        "w_down": ParamSpec((D, D), s),
    }


def _slstm_step(r: torch.Tensor, pre: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One token: pre [B, 4, H, dh] float32 (input pre-activations),
    state (c, n, h, m) each [B, H, dh] -> the new state."""
    c, n, h, m = state
    B, H, dh = h.shape
    rec = torch.einsum("bhd,hde->bhe", h, r).reshape(B, H, 4, dh)
    zi = pre[:, 0] + rec[:, :, 0]
    zf = pre[:, 1] + rec[:, :, 1]
    zz = pre[:, 2] + rec[:, :, 2]
    zo = pre[:, 3] + rec[:, :, 3]
    # exponential gating with the stabiliser m
    m_new = torch.maximum(zf + m, zi)
    i_g = torch.exp(zi - m_new)
    f_g = torch.exp(zf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(zz)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_forward(p, cfg: ModelConfig, x: torch.Tensor, *, return_state: bool = False):
    """Sequential over time (inherently recurrent): x [B, S, D] ->
    [B, S, D] (and the final (c, n, h, m) with ``return_state``)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    pre = (x @ p["w"] + p["b"]).reshape(B, S, 4, H, dh).float()
    state = init_slstm_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(p["r"], pre[:, t], state)
        hs.append(state[2])
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    out = rms_norm(h, p["out_ln"], cfg.norm_eps) @ p["w_down"]
    return (out, state) if return_state else out


def slstm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One token: x [B, 1, D], state (c, n, h, m) each [B, H, dh] float32."""
    B = x.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    pre = (x @ p["w"] + p["b"]).reshape(B, 4, H, dh).float()
    state = _slstm_step(p["r"], pre, state)
    out = state[2].reshape(B, 1, cfg.d_model).to(x.dtype)
    return rms_norm(out, p["out_ln"], cfg.norm_eps) @ p["w_down"], state


def init_slstm_state(cfg: ModelConfig, batch: int, device: DeviceLike = "cuda") -> SLSTMState:
    H = cfg.n_heads
    z = torch.zeros((batch, H, cfg.d_model // H), dtype=torch.float32,
                    device=resolve_device(device))
    return (z, z, z, z)
