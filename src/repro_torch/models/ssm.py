"""Recurrent blocks: xLSTM's mLSTM (chunked gated linear attention) and
sLSTM (scalar memory with exponential gating), and the Mamba-style
selective SSM head of the Hymba block.  Counterpart of
``repro.models.ssm``.

The mLSTM's full-sequence path is the chunkwise-parallel scan.  With
``cfg.use_flash_kernel`` and no state asked for (the ``forward`` of
training and scoring), it goes through the ``mlstm_scan`` wrapper: K4 on
the card, its plain version on the CPU.  Prefill asks for the final
state, which the kernel does not return, so it takes the plain chunked
path, as the reference does.  Decode is one recurrent state update.  The
sLSTM is a per-token recurrence in any mode: a Python loop over time,
where the reference has a ``lax.scan``.

The Mamba recurrence ``h_t = dA_t * h_{t-1} + dBu_t`` (per channel
``(d, s)``, ``0 < dA_t <= 1``) is a ``lax.scan`` over tokens in the
reference.  Here its full-sequence path is :func:`mamba_scan_chunked`:
each chunk of ``C = ceil(sqrt(S))`` tokens is scanned from a zero state,
every chunk at once (``C`` vectorised steps), the chunks' end states are
then carried across chunks (``S / C`` steps), and each position adds its
chunk's entering state times the decay since the chunk began (a
cumulative product): about ``2 sqrt(S)`` launches of a few kernels each,
where the loop takes ``S``.  Only factors in ``[0, 1]`` are
multiplied, so a strong decay underflows to 0 instead of overflowing,
as the factored form ``exp(L_t) * sum_j exp(-L_j) dBu_j`` would
(``L`` the cumulative ``log dA``).  :func:`mamba_scan_loop`, one step a
token, is its plain version.  Decode is one state update.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (the Hymba block's recurrent head)

MambaState = Tuple[torch.Tensor, torch.Tensor]


def _mamba_state_size(cfg: ModelConfig) -> int:
    return cfg.ssm.d_state if cfg.ssm else 16


def mamba_specs(cfg: ModelConfig, d_inner: int) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    N = _mamba_state_size(cfg)
    dt_rank = max(1, D // 16)
    return {
        "w_in": ParamSpec((D, 2 * d_inner), D ** -0.5),
        "conv_w": ParamSpec((4, d_inner), 0.5),
        "w_bc": ParamSpec((d_inner, 2 * N), d_inner ** -0.5),
        "w_dt1": ParamSpec((d_inner, dt_rank), d_inner ** -0.5),
        "w_dt2": ParamSpec((dt_rank, d_inner), dt_rank ** -0.5),
        "a_log": ParamSpec((d_inner, N), 0.0, init="ones"),
        "d_skip": ParamSpec((d_inner,), 1.0, init="ones"),
        "w_out": ParamSpec((d_inner, D), d_inner ** -0.5),
    }


def _mamba_discretise(p, u: torch.Tensor, d_state: int):
    """Gates and discretisation of the conv output ``u`` [..., Di]:
    ``(C, dA, dBu)`` with ``dA, dBu`` float32 ``[..., Di, N]``."""
    Bmat, Cmat = (u @ p["w_bc"]).split(d_state, dim=-1)          # [..., N] each
    dt = F.softplus((u @ p["w_dt1"]) @ p["w_dt2"])               # [..., Di]
    A = -torch.exp(p["a_log"].float())                           # [Di, N]
    dA = torch.exp(dt.float()[..., None] * A)
    dBu = (dt * u).float()[..., None] * Bmat.float()[..., None, :]
    return Cmat, dA, dBu


def _mamba_scan_inputs(p, x: torch.Tensor, d_inner: int, d_state: int):
    """Shared preprocessing of x [B, S, D]: the depthwise causal conv
    (width 4), gates and discretisation.  Returns ``(u, z, C, dA, dBu)``:
    u, z [B, S, Di], C [B, S, N], dA and dBu float32 [B, S, Di, N]."""
    S = x.shape[1]
    xin, z = (x @ p["w_in"]).split(d_inner, dim=-1)              # [B, S, Di]
    pad = F.pad(xin, (0, 0, 3, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(4))
    u = F.silu(conv)
    Cmat, dA, dBu = _mamba_discretise(p, u, d_state)
    return u, z, Cmat, dA, dBu


def mamba_scan_loop(dA: torch.Tensor, dBu: torch.Tensor, Cmat: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``h_t = dA_t * h_{t-1} + dBu_t`` one token at a
    time (the reference's ``lax.scan``), ``y_t = h_t . C_t``.  dA, dBu
    [B, S, Di, N], C [B, S, N], h0 [B, Di, N] (zeros when None) ->
    (y float32 [B, S, Di], final h float32 [B, Di, N])."""
    B, S, Di, N = dA.shape
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=dA.device) if h0 is None else h0
    Cf = Cmat.float()
    ys = []
    for t in range(S):
        h = dA[:, t] * h + dBu[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_chunk_len(S: int) -> int:
    """The chunk length of :func:`mamba_scan_chunked`: ``ceil(sqrt(S))``,
    which makes the two sequential loops (``C`` and ``S / C`` steps)
    about equal (64 at S = 4096, 8 at S = 64)."""
    return math.isqrt(max(S, 1) - 1) + 1


def mamba_scan_chunked(dA: torch.Tensor, dBu: torch.Tensor, Cmat: torch.Tensor,
                       h0: Optional[torch.Tensor] = None, *,
                       chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan_loop`'s recurrence in chunks of ``chunk`` tokens
    (:func:`mamba_chunk_len` when None; the last chunk padded with
    identity steps, ``dA = 1`` and ``dBu = 0``):

    1. every chunk scanned from a zero state at once, ``chunk`` steps;
    2. the decay since each chunk's start, ``P_t = prod dA`` (cumprod);
    3. the state entering each chunk, carried across the chunks from
       ``h0`` (``S / chunk`` steps on ``[B, Di, N]``);
    4. ``h_t = local_t + P_t * entering``, then ``y_t = h_t . C_t``.

    Every factor lies in [0, 1], so nothing overflows; the result differs
    from the loop's only by rounding.  Same arguments and results as the
    loop."""
    B, S, Di, N = dA.shape
    C = max(1, min(chunk or mamba_chunk_len(S), S))
    n = -(-S // C)
    pad = n * C - S
    if pad:
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBu = F.pad(dBu, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    a = dA.reshape(B, n, C, Di, N)
    # unbind, not an index a step: under autograd an index's backward
    # fills a zero tensor of the whole input for every step
    a_t, b_t = a.unbind(2), dBu.reshape(B, n, C, Di, N).unbind(2)
    h = b_t[0]
    local = [h]
    for t in range(1, C):                       # every chunk at once
        h = torch.addcmul(b_t[t], a_t[t], h)
        local.append(h)
    local_h = torch.stack(local, dim=2)         # [B, n, C, Di, N], from zero states
    del local, a_t, b_t
    decay = torch.cumprod(a, dim=2)             # prod of dA from the chunk's start through t
    state = torch.zeros((B, Di, N), dtype=torch.float32, device=dA.device) if h0 is None else h0
    entering = []
    for end_h, end_decay in zip(local_h[:, :, -1].unbind(1), decay[:, :, -1].unbind(1)):
        entering.append(state)                  # carry across the chunks
        state = torch.addcmul(end_h, end_decay, state)
    h = torch.addcmul(local_h, decay, torch.stack(entering, dim=1)[:, :, None])
    del local_h, decay
    y = torch.einsum("bncds,bncs->bncd", h, Cmat.float().reshape(B, n, C, N))
    return y.reshape(B, n * C, Di)[:, :S], state


def _mamba_out(p, x_dtype: torch.dtype, y: torch.Tensor, u: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    y = y.to(x_dtype) + u * p["d_skip"]
    return (y * F.silu(z)) @ p["w_out"]


def mamba_forward(p, cfg: ModelConfig, x: torch.Tensor, d_inner: int, *,
                  return_state: bool = False):
    """x [B, S, D] -> [B, S, D], through :func:`mamba_scan_chunked` (and
    with ``return_state`` the state ``(h [B, Di, N] float32, conv buffer
    [B, 3, Di])``: the final SSM state and the last 3 pre-conv inputs,
    zero-padded on the left when S < 3)."""
    d_state = _mamba_state_size(cfg)
    u, z, Cmat, dA, dBu = _mamba_scan_inputs(p, x, d_inner, d_state)
    y, h = mamba_scan_chunked(dA, dBu, Cmat)
    del dA, dBu
    out = _mamba_out(p, x.dtype, y, u, z)
    if not return_state:
        return out
    last = x[:, -3:] @ p["w_in"][:, :d_inner]
    return out, (h, F.pad(last, (0, 0, 3 - last.shape[1], 0)))


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor, state: MambaState,
                 d_inner: int) -> Tuple[torch.Tensor, MambaState]:
    """One token: x [B, 1, D], state (h [B, Di, N] float32, conv buffer
    [B, 3, Di]) -> (out [B, 1, D], new state)."""
    d_state = _mamba_state_size(cfg)
    B = x.shape[0]
    h, conv_buf = state
    xin, z = (x @ p["w_in"]).split(d_inner, dim=-1)              # [B, 1, Di]
    win = torch.cat([conv_buf.to(x.dtype), xin.reshape(B, 1, d_inner)], dim=1)
    u = F.silu(torch.einsum("bkd,kd->bd", win, p["conv_w"]))     # [B, Di]
    Cv, dA, dBu = _mamba_discretise(p, u, d_state)
    h = dA * h + dBu
    y = torch.einsum("bds,bs->bd", h, Cv.float())
    out = _mamba_out(p, x.dtype, y, u, z[:, 0])[:, None, :]
    return out, (h, win[:, 1:])


def init_mamba_state(cfg: ModelConfig, batch: int, d_inner: int, dtype=torch.float32,
                     device: DeviceLike = "cuda") -> MambaState:
    """Zero state: the float32 SSM state and the conv ring buffer (``dtype``)."""
    dev = resolve_device(device)
    return (torch.zeros((batch, d_inner, _mamba_state_size(cfg)), dtype=torch.float32,
                        device=dev),
            torch.zeros((batch, 3, d_inner), dtype=dtype, device=dev))
