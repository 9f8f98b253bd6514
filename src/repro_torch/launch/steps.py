"""Step functions of the training and serving paths, built from a config.

Counterpart of ``repro.launch.steps``: :func:`build_train_step` returns the
DPASGD step of :func:`repro_torch.fed.make_train_step` (AdamW at 1e-4 by
default, the ring plan when there are several silos and no plan is
given), :func:`build_prefill_step` and :func:`build_decode_step` the
serving steps over a ``batch`` dict.  ``mesh`` is passed on to
``make_train_step`` as the reference passes its device mesh: with a
:class:`~repro_torch.launch.mesh.SiloMesh` (one silo per process) the
step trains this rank's row and gossips over the process group.  The
reference's ``silo_axis`` and ``grad_pspecs`` are GSPMD layout arguments
(the silo axis of a device mesh, sharding specs of the gradient
accumulators) with no counterpart in that process layout, so they are
not taken here.

K3 and K4 have no backward, in either package, so a config with
``use_flash_kernel`` cannot be trained: :func:`build_train_step` refuses
it up front.  ``flash_vjp`` is training attention's memory-saving path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.fed import DPASGDConfig, GossipPlan, make_train_step
from repro_torch.fed.topology_runtime import plan_for_n_silos
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adamw


def build_train_step(cfg: ModelConfig, *, optimizer: Optional[Optimizer] = None,
                     gossip_impl: str = "ppermute", plan: Optional[GossipPlan] = None,
                     mesh=None, local_steps: int = 1, accum_steps: int = 1) -> Callable:
    """``step_fn(state, batch) -> (state, {"loss"})`` for a state from
    :func:`repro_torch.fed.init_state` with the same optimizer (default
    ``adamw(1e-4)``) and the same ``mesh``: with one, the state is this
    rank's row and the batch its silo's ``[s, B, S]`` microbatches.
    Raises ``RuntimeError`` for ``cfg.use_flash_kernel``: the kernels are
    forward-only."""
    if cfg.use_flash_kernel:
        raise RuntimeError(
            "use_flash_kernel sends attention through flash_attention (K3) and the mLSTM "
            "through mlstm_scan (K4), which have no backward (their Pallas counterparts have "
            "none either): train on the chunked path or with flash_vjp=True")
    optimizer = optimizer or adamw(1e-4)
    fed = DPASGDConfig(local_steps=local_steps, gossip_impl=gossip_impl,
                       accum_steps=accum_steps)
    if cfg.n_silos > 1 and plan is None:
        plan = plan_for_n_silos("ring", cfg.n_silos)
    return make_train_step(cfg, fed, optimizer, plan, mesh=mesh)


def build_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """``prefill_step(params, batch) -> (last-token logits, cache)`` for
    ``batch = {"tokens", "enc_frames"?, "vision_embeds"?}``, caches in
    bfloat16 as the reference's; under ``torch.no_grad()``."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Any]):
        return T.prefill(params, cfg, batch["tokens"], max_len,
                         enc_frames=batch.get("enc_frames"),
                         vision_embeds=batch.get("vision_embeds"))

    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    """``decode_fn(params, batch) -> (logits, cache)`` for ``batch =
    {"token", "cache", "position"}`` (the position an int or a 0-d
    tensor); under ``torch.no_grad()``."""

    @torch.no_grad()
    def decode_fn(params, batch: Dict[str, Any]):
        return T.decode_step(params, cfg, batch["token"], batch["cache"],
                             int(batch["position"]))

    return decode_fn
