"""Architecture registry: ``get_config("<arch-id>", **overrides)``.

Counterpart of ``repro.configs``, with all ten of its configurations:
the dense transformers, the MoE and MLA models, the xLSTM stack, the
Hymba hybrid, the vision-prefix backbone and whisper's encoder-decoder;
and the assignment's four input shapes (``INPUT_SHAPES``) with the gate
that keeps ``long_500k`` to sub-quadratic decode.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models import ModelConfig

_MODULES: Dict[str, str] = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-20b": "granite_20b",
    "mistral-large-123b": "mistral_large_123b",
    "hymba-1.5b": "hymba_1_5b",
    "internvl2-76b": "internvl2_76b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    """The registered config with ``overrides`` applied.  Overriding
    ``n_layers`` alone cuts the depth to the first ``n_layers`` kinds of
    the published block pattern, and ``get_config(arch, use_flash_kernel=True)``
    sends prefill attention through K3 and the mLSTM forward through K4,
    as the reference's override does."""
    key = arch_id.lower()
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    cfg: ModelConfig = mod.CONFIG
    if "n_layers" in overrides and "block_pattern" not in overrides:
        n = overrides["n_layers"]
        if n > cfg.n_layers:
            raise ValueError(f"{arch_id} has {cfg.n_layers} layers; cannot keep {n}")
        overrides["block_pattern"] = cfg.block_pattern[:n]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# ---------------------------------------------------------------------------
# Input shapes of the assignment.

INPUT_SHAPES = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


def long_context_supported(cfg: ModelConfig) -> bool:
    """long_500k requires sub-quadratic decode: a sliding window or a
    recurrent state, so that the cache does not grow with the context."""
    return cfg.is_subquadratic


def shape_supported(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return long_context_supported(cfg)
    return True
