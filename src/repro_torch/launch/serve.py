"""Serving launcher: batched prefill + decode with KV caches or recurrent
states, on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --batch 2 --prompt-len 8192 --gen 32 --flash-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --batch 4 --prompt-len 2048 --gen 129
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --reduced --device cpu --batch 2 --prompt-len 16 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 2 --prompt-len 4096 --gen 32 --flash-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \\
        --batch 4 --prompt-len 384 --gen 64 --flash-kernel

Counterpart of ``repro.launch.serve`` for every config of
:mod:`repro_torch.configs` (the dense transformers, the MoE models, MLA,
the xLSTM stack, the Hymba hybrid, the vision-prefix backbone and
whisper's encoder-decoder), with
the same flags plus ``--device`` (default ``cuda``;
``--device cpu`` with ``--reduced`` runs the small variant on the CPU),
``--seed`` (weights and prompts) and ``--flash-kernel``, which sets the
reference's ``use_flash_kernel`` (after ``--reduced``, which turns it
off): prefill attention then runs through the K3 kernel, one launch
per ``attn`` / ``attn_moe`` layer (none for MLA, whose q.k and v widths
differ; deepseek-v2-lite's layers are all MLA).  The mLSTM's
K4 kernel runs only in the full-sequence ``forward``; prefill needs the
final state and decode is one state update, so serving an xLSTM stack
launches it no time, as in the reference.  Hymba's attention heads take
K3 in prefill like any GQA layer.  A VLM (internvl2-76b) is served with
``vision_embeds``, ``[B, vision_prefix_len, 1024]`` stub patch embeddings
(seeded normal draws by default, where the reference's launcher uses
ones): the prefix goes ahead of the prompt, so with ``--flash-kernel``
prefix plus prompt must be a multiple of 128, decode starts at position
``prompt_len + vision_prefix_len``, and the default cache length holds
the prefix too (the reference's ``prompt_len + gen`` would wrap an
unwindowed cache past the prefix).  An encoder-decoder (whisper-large-v3)
is served with ``enc_frames``, ``[B, encoder.seq_len, 128]`` stub frame
features (seeded normal draws by default, where the reference's launcher
uses ones): the prefill encodes them and caches each decoder layer's
cross K/V; K3 runs only in the decoder's causal self-attention (one launch
a decoder layer), so with ``--flash-kernel`` only the prompt must be a
multiple of 128, not the 1500 frames.  Parameters, caches and states are
float32, as in the reference's launcher.  ``main`` parses the flags and
calls :func:`serve`, which scripts call with their own weights, prompts,
embeddings or depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models import ModelConfig, init_params, model_specs
from repro_torch.models import transformer as T


@dataclass
class ServeResult:
    prompts: torch.Tensor            # [B, prompt_len] int64
    vision_embeds: Optional[torch.Tensor]  # [B, vision_prefix_len, 1024] of a VLM, else None
    enc_frames: Optional[torch.Tensor]     # [B, encoder.seq_len, 128] of an encoder-decoder
    ids: torch.Tensor                # [B, gen] generated ids (greedy)
    logits: torch.Tensor             # [B, V] logits of the last step
    prefill_logits: torch.Tensor     # [B, V] last-token logits of the prefill
    prefill_s: float                 # host clock, after a device synchronise
    decode_s: float
    decode_tok_s: float              # B * (gen - 1) / decode_s
    launches: Dict[str, Dict[str, int]]  # kernel launches in "prefill" / "decode"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          max_len: int = 0, seed: int = 0, device: DeviceLike = "cuda",
          params=None, prompts: Optional[np.ndarray] = None,
          vision_embeds: Optional[np.ndarray] = None,
          enc_frames: Optional[np.ndarray] = None,
          log: Callable[[str], None] = print) -> ServeResult:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    greedily to ``gen`` tokens in all.  Weights come from ``init_params``
    with ``seed`` unless ``params`` is given; prompts from a numpy
    generator seeded with ``seed`` unless ``prompts`` is given; a VLM's
    ``vision_embeds`` (float32 ``[B, vision_prefix_len, 1024]``) from a
    normal draw of the same generator after the prompts unless given; an
    encoder-decoder's ``enc_frames`` (float32 ``[B, encoder.seq_len,
    128]``) likewise.  Decode positions are Python ints, so no step waits
    for the device."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long).to(dev)
    B, S = tokens.shape
    prefix = cfg.vision_prefix_len
    if prefix and vision_embeds is None:
        vision_embeds = rng.standard_normal((B, prefix, 1024)).astype(np.float32)
    embeds = (None if not prefix else
              torch.as_tensor(np.asarray(vision_embeds), dtype=torch.float32).to(dev))
    if cfg.is_encdec and enc_frames is None:
        enc_frames = rng.standard_normal((B, cfg.encoder.seq_len, 128)).astype(np.float32)
    frames = (None if not cfg.is_encdec else
              torch.as_tensor(np.asarray(enc_frames), dtype=torch.float32).to(dev))
    k3_layers = set(cfg.block_pattern) & {"attn", "attn_moe", "hymba"}
    if cfg.use_flash_kernel and k3_layers and (prefix + S) % 128:
        raise ValueError(f"use_flash_kernel sends prefill attention through K3, which needs "
                         f"the prefill ({prefix} prefix + {S} prompt tokens) to be a multiple "
                         f"of 128")
    max_len = max_len or (prefix + S + gen)
    if params is None:
        params = init_params(model_specs(cfg), seed=seed, device=dev)
    with torch.no_grad():
        _sync(dev)
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, tokens, max_len, cache_dtype=torch.float32,
                                  vision_embeds=embeds, enc_frames=frames)
        tok = logits.argmax(-1)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        mid = dict(LAUNCHES)
        extra = (f" + {prefix} patches" if prefix else
                 f" + {frames.shape[1]} frames" if frames is not None else "")
        log(f"prefill[{B}x{S}{extra}] in {prefill_s:.2f}s")
        prefill_logits = logits
        out: List[torch.Tensor] = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = T.decode_step(params, cfg, tok, cache, prefix + S + i)
            tok = logits.argmax(-1)
            out.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    after = dict(LAUNCHES)
    toks = B * (gen - 1)
    tok_s = toks / max(decode_s, 1e-9)
    log(f"decode {gen - 1} steps x batch {B}: {decode_s:.2f}s ({tok_s:.1f} tok/s on {dev.type})")
    ids = torch.stack(out, dim=1)
    log(f"generated ids[0]: {ids[0, :16].tolist()}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    return ServeResult(
        prompts=tokens, vision_embeds=embeds, enc_frames=frames, ids=ids, logits=logits,
        prefill_logits=prefill_logits, prefill_s=prefill_s, decode_s=decode_s, decode_tok_s=tok_s,
        launches={"prefill": {k: mid[k] - before[k] for k in before},
                  "decode": {k: after[k] - mid[k] for k in before}})


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flash-kernel", action="store_true",
                    help="use_flash_kernel: attention prefill through K3 (a VLM's prefix "
                         "plus prompt-len a multiple of 128); the mLSTM's K4 runs only in "
                         "forward, so xlstm serving is unchanged by it")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.flash_kernel:
        cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          max_len=args.max_len, seed=args.seed, device=args.device,
          log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
