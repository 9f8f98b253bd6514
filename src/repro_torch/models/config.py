"""Model configuration of the dense GQA transformer and the xLSTM stack.

Counterpart of ``repro.models.config.ModelConfig``, cut to the fields a
dense causal attention + SwiGLU stack and an mLSTM/sLSTM stack read,
sliding-window layers and the kernel switch included.  The other block
kinds of the reference (MoE, MLA, Hymba, encoder-decoder) and tied
embeddings are not ported yet; ``block_pattern`` accepts ``"attn"``,
``"mlstm"`` and ``"slstm"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "mlstm", "slstm")


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16        # mamba state size / mLSTM key dim factor
    expand: int = 2          # inner expansion
    d_conv: int = 4          # depthwise conv width (mamba)
    n_ssm_heads: int = 0     # hymba: number of mamba heads in parallel


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ()    # len == n_layers; default "attn"
    sliding_window: Optional[int] = None   # SWA window (danube)
    global_attn_every: int = 0             # every k-th layer full attention
    family: str = "dense"                  # the reference's family tag ("dense", "ssm")
    ssm: Optional[SSMConfig] = None        # xLSTM: the mLSTM up-projection factor
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    n_silos: int = 1
    use_flash_kernel: bool = False         # K3 in attention prefill; K4 in the mLSTM forward
    remat: bool = True                     # recompute each block in backward

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("attn",) * self.n_layers)
        if len(self.block_pattern) != self.n_layers:
            raise ValueError("block_pattern length must equal n_layers")
        if set(self.block_pattern) - set(BLOCK_KINDS):
            raise NotImplementedError(
                f"block kinds {sorted(set(self.block_pattern) - set(BLOCK_KINDS))} "
                "are not ported yet")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 128 (the reference's layout);
        logits are sliced back to ``vocab_size``."""
        return ((self.vocab_size + 127) // 128) * 128

    def layer_uses_window(self, layer: int) -> bool:
        if self.sliding_window is None:
            return False
        if self.global_attn_every and (layer % self.global_attn_every == 0):
            return False
        return True

    def reduced(self, *, n_layers: int = 2, d_model: int = 256) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (the reference's
        ``reduced()`` on the ported fields): the first ``n_layers`` kinds
        of the pattern, except that one of each kind survives when there
        is room, as the reference keeps family diversity."""
        scale = d_model / self.d_model
        n_heads = max(2, min(self.n_heads, d_model // 64))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pattern = self.block_pattern[:n_layers]
        kinds = tuple(dict.fromkeys(self.block_pattern))
        if len(kinds) > 1 and n_layers >= len(kinds):
            pattern = (kinds + pattern[len(kinds):])[:n_layers]
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=0,
            d_ff=max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=min(512, self.vocab_size),
            block_pattern=pattern,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else None,
            use_flash_kernel=False,
        )
