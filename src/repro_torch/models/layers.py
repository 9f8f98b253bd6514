"""Elementary layers: RMSNorm, RoPE, SwiGLU, GELU MLP, embeddings, the
sinusoidal positions of Whisper's encoder, cross-entropy (plain functions
on tensors; counterparts of ``repro.models.layers``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight).to(dtype)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings.  positions: [...]; returns
    cos, sin of shape [..., dim//2]."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a device-side fill, not torch.tensor(theta, device=...): a copy from
    # the host would wait for the device on every call (every decode step)
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / torch.pow(base, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor, w_down: torch.Tensor,
             b_down: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` is the tanh approximation by
    default; the exact erf form differs from it by up to about 5e-4."""
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def sinusoidal_positions(seq_len: int, dim: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Float32 ``[seq_len, dim]`` table: ``sin`` of ``pos / 10000^(2i/dim)``
    in the first half of the columns, ``cos`` in the second.  The divisor
    is the float32 rounding of a float64 power of the float32 exponent:
    torch's float32 ``pow`` is off by an ulp at some exponents, which the
    angle multiplies by up to ``seq_len`` (3e-5 in the sine at 1500
    frames), while the reference's ``jnp.power`` rounds correctly."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    base = torch.full((), 10000.0, dtype=torch.float64, device=device)
    angle = pos / torch.pow(base, (2 * i / dim).to(torch.float64)).to(torch.float32)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-level CE, mean over all positions. logits [...,V], labels [...]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
