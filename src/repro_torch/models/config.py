"""Model configuration of the transformers (dense GQA/MQA, MoE, DeepSeek
MLA, the vision-prefix backbone, Whisper's encoder-decoder), the xLSTM
stack and the Hymba hybrid.

Counterpart of ``repro.models.config.ModelConfig``, cut to the fields
these stacks read: sliding-window layers, the kernel switch, banded
sliding-window attention, the SwiGLU or GELU MLP, top-k routed and shared
experts (``MoEConfig``), multi-head latent attention (``MLAConfig``), the
recurrent widths (``SSMConfig``), the audio encoder (``EncoderConfig``),
the stub vision prefix (``vision_prefix_len``) and the flash-style
custom VJP of training attention (``flash_vjp``).  Tied embeddings are
not ported yet; ``block_pattern`` accepts ``"attn"``, ``"attn_moe"``, ``"mla"``,
``"mla_moe"``, ``"mlstm"``, ``"slstm"`` and ``"hymba"``.  In an
encoder-decoder config (``is_encdec``) every ``"attn"`` layer of the
pattern is built as the decoder kind ``"xattn"``: causal self-attention,
then cross-attention over the encoder's output, then the MLP.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "attn_moe", "mla", "mla_moe", "mlstm", "slstm", "hymba")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # hidden size of each routed expert
    n_shared: int = 0        # shared (always-on) experts
    d_shared: int = 0        # hidden size of the shared expert MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0     # 0 = no query compression (deepseek-v2-lite)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16        # mamba state size / mLSTM key dim factor
    expand: int = 2          # inner expansion
    d_conv: int = 4          # depthwise conv width (mamba)
    n_ssm_heads: int = 0     # hymba: number of mamba heads in parallel


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder: its convolutional frontend is a stub, as in
    the reference, so its inputs are frame features (``AUDIO_FRONTEND_DIM``
    wide).  The encoder is always bidirectional."""

    n_layers: int = 0
    seq_len: int = 1500      # encoder frames (whisper-large-v3: 1500)


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
    sliding_window: Optional[int] = None   # SWA window (danube/hymba)
    global_attn_every: int = 0             # every k-th layer full attention (hymba)
    family: str = "dense"                  # the reference's family tag ("dense", "moe", "ssm", ...)
    moe: Optional[MoEConfig] = None        # routed experts of "attn_moe" / "mla_moe" layers
    mla: Optional[MLAConfig] = None        # latent attention of "mla" / "mla_moe" layers
    ssm: Optional[SSMConfig] = None        # xLSTM's up-projection; hymba's Mamba state size
    encoder: Optional[EncoderConfig] = None  # whisper's audio encoder (frames -> cross K/V)
    vision_prefix_len: int = 0             # VLM: stub patch embeddings ahead of the tokens
    mlp_variant: str = "swiglu"            # "swiglu" | "gelu" (the dense FFN half)
    tie_embeddings: bool = False           # the tied head is not ported: must be False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    n_silos: int = 1
    use_flash_kernel: bool = False         # K3 in attention prefill; K4 in the mLSTM forward
    remat: bool = True                     # recompute each block in backward
    # banded sliding-window attention: touch only the visible key band of
    # each query block, O(S * window) instead of O(S^2) masked work
    banded_swa: bool = False
    # flash-style custom VJP: the backward recomputes each probability
    # block from the log-sum-exp instead of storing the S x T probabilities
    flash_vjp: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern:
            if self.moe is not None and self.mla is not None:
                kind = "mla_moe"
            elif self.moe is not None:
                kind = "attn_moe"
            elif self.mla is not None:
                kind = "mla"
            else:
                kind = "attn"
            object.__setattr__(self, "block_pattern", (kind,) * self.n_layers)
        if len(self.block_pattern) != self.n_layers:
            raise ValueError("block_pattern length must equal n_layers")
        if set(self.block_pattern) - set(BLOCK_KINDS):
            raise NotImplementedError(
                f"block kinds {sorted(set(self.block_pattern) - set(BLOCK_KINDS))} "
                "are not ported yet")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.mlp_variant not in ("swiglu", "gelu"):
            raise ValueError(f"mlp_variant must be 'swiglu' or 'gelu', got {self.mlp_variant!r}")
        kinds = set(self.block_pattern)
        if self.moe is None and kinds & {"attn_moe", "mla_moe"}:
            raise ValueError("attn_moe / mla_moe layers need a MoEConfig")
        if self.mla is None and kinds & {"mla", "mla_moe"}:
            raise ValueError("mla / mla_moe layers need an MLAConfig")
        if self.tie_embeddings:
            raise NotImplementedError("tied embeddings are not ported yet")

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 128 (the reference's layout);
        logits are sliced back to ``vocab_size``."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None and self.encoder.n_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """True if decode memory is bounded (SWA / recurrent)."""
        kinds = set(self.block_pattern)
        if kinds <= {"mlstm", "slstm"}:
            return True
        if "hymba" in kinds:
            return self.sliding_window is not None
        return self.sliding_window is not None and not self.is_encdec

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
        is room, as the reference keeps family diversity.  Experts shrink
        to at most 4 (top-k at most 2, one shared expert) with a capacity
        factor of ``n_experts``, so that no token is dropped and prefill,
        decode and forward agree exactly; MLA ranks to 64/32/16/32; the
        encoder to at most 2 layers and 64 frames; the vision prefix to at
        most 8 patch embeddings."""
        scale = d_model / self.d_model
        n_heads = max(2, min(self.n_heads, d_model // 64))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = None
        if self.moe is not None:
            n_exp = min(4, self.moe.n_experts)
            moe = dataclasses.replace(
                self.moe,
                n_experts=n_exp,
                top_k=min(2, self.moe.top_k),
                d_expert=max(32, int(self.moe.d_expert * scale)),
                n_shared=min(1, self.moe.n_shared),
                d_shared=max(32, int(self.moe.d_shared * scale)) if self.moe.n_shared else 0,
                capacity_factor=float(n_exp),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                            v_head_dim=32, q_lora_rank=0)
        enc = None
        if self.encoder is not None:
            enc = dataclasses.replace(self.encoder, n_layers=min(2, self.encoder.n_layers),
                                      seq_len=min(64, self.encoder.seq_len))
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
            moe=moe,
            mla=mla,
            encoder=enc,
            vision_prefix_len=min(8, self.vision_prefix_len),
            use_flash_kernel=False,
        )
