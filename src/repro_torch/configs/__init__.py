"""Architecture registry: ``get_config("<arch-id>", **overrides)``.

Counterpart of ``repro.configs``.  Only the dense configurations the
port can run are registered; the rest of the reference's zoo follows
with their block kinds.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models import ModelConfig

_MODULES: Dict[str, str] = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "internlm2-1.8b": "internlm2_1_8b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    """The registered config with ``overrides`` applied.  Overriding
    ``n_layers`` alone re-derives the (all-``"attn"``) block pattern, so
    ``get_config(arch, n_layers=4)`` cuts the depth, and
    ``get_config(arch, use_flash_kernel=True)`` sends prefill attention
    through the K3 kernel, as the reference's override does."""
    key = arch_id.lower()
    if key not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    cfg: ModelConfig = mod.CONFIG
    if "n_layers" in overrides:
        overrides.setdefault("block_pattern", ())
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
