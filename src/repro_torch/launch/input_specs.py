"""Stand-ins for every (arch x input-shape) combination: meta tensors
(``device="meta"``) with the inputs' shapes and dtypes, so the dry run
sizes a step without allocating.

Counterpart of ``repro.launch.input_specs``'s ``train_input_specs``,
``serve_input_specs`` and ``abstract_cache``, whose ``ShapeDtypeStruct``\\ s
become meta tensors here; token ids are ``torch.long`` and the stub frame
and patch features float32, as the port's entry points take them.  A
shape is a name of ``INPUT_SHAPES`` or a spec dict of the same keys (the
dry run's cut sequence or batch).  The
cache stand-in is the port's own ``init_cache(..., device="meta")`` in
bfloat16, with an encoder-decoder's cross K/V sized as the reference
sizes them (in float32, as the port's prefill leaves them).  :func:`tree_bytes` gives a stand-in tree's bytes.

The reference's sharding helpers (``train_batch_pspecs``, ``cache_pspec*``,
``serve_batch_pspecs``, ``model_param_pspecs``, ``named``,
``abstract_model_params``) lay a step out over a GSPMD device mesh.  They
have no counterpart on one card, nor with one silo per process
(:mod:`repro_torch.launch.mesh`), where each rank holds its own silo's
whole row.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import AUDIO_FRONTEND_DIM

TOKEN_DT = torch.long
FEATURE_DT = torch.float32
VISION_DIM = 1024  # the stub patch embeddings' width


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


Shape = Union[str, Dict[str, Any]]


def _spec(shape: Shape) -> Dict[str, Any]:
    """A shape of ``INPUT_SHAPES`` by name, or a spec dict as it holds."""
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def train_input_specs(cfg: ModelConfig, shape: Shape, *, local_steps: int = 1,
                      accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """DPASGD batch of a training shape: ``[n_silos?, s_local, accum?,
    B_micro, S]``, ``B_micro = global_batch / n_silos / accum_steps``."""
    spec = _spec(shape)
    S, B = spec["seq_len"], spec["global_batch"]
    n = cfg.n_silos
    per = B // max(n, 1)
    assert per % accum_steps == 0, (per, accum_steps)
    micro = per // accum_steps
    lead: Tuple[int, ...] = (local_steps,)
    if accum_steps > 1:
        lead = lead + (accum_steps,)
    if n > 1:
        lead = (n,) + lead
    S_tok = S - cfg.vision_prefix_len  # the vision prefix counts toward the sequence
    out = {"tokens": meta(lead + (micro, S_tok), TOKEN_DT),
           "labels": meta(lead + (micro, S_tok), TOKEN_DT)}
    if cfg.is_encdec:
        out["enc_frames"] = meta(lead + (micro, cfg.encoder.seq_len, AUDIO_FRONTEND_DIM),
                                 FEATURE_DT)
    if cfg.vision_prefix_len:
        out["vision_embeds"] = meta(lead + (micro, cfg.vision_prefix_len, VISION_DIM), FEATURE_DT)
    return out


def serve_input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, Any]:
    """Serving inputs of a shape (prefill or decode) at its global batch."""
    spec = _spec(shape)
    S, B = spec["seq_len"], spec["global_batch"]
    out: Dict[str, Any] = {}
    if spec["kind"] == "prefill":
        out["tokens"] = meta((B, S - cfg.vision_prefix_len), TOKEN_DT)
        if cfg.is_encdec:
            out["enc_frames"] = meta((B, cfg.encoder.seq_len, AUDIO_FRONTEND_DIM), FEATURE_DT)
        if cfg.vision_prefix_len:
            out["vision_embeds"] = meta((B, cfg.vision_prefix_len, VISION_DIM), FEATURE_DT)
    else:  # decode: one new token against a seq_len cache
        out["token"] = meta((B,), TOKEN_DT)
        out["position"] = meta((), TOKEN_DT)
        out["cache"] = abstract_cache(cfg, B, S)
    return out


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The serving cache of ``init_cache`` on the meta device; an
    encoder-decoder's layers carry their cross K/V, ``[batch, frames,
    n_heads, head_dim]`` each, float32: the port's prefill keeps them in
    the encoder output's dtype, whatever ``dtype`` (the reference's
    stand-in has ``dtype``; the shapes are the same)."""
    cache = T.init_cache(cfg, batch, max_len, dtype, device="meta")
    if cfg.is_encdec:
        shape = (batch, cfg.encoder.seq_len, cfg.n_heads, cfg.head_dim)
        for c in cache:
            c["xk"] = meta(shape, FEATURE_DT)
            c["xv"] = meta(shape, FEATURE_DT)
    return cache


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
