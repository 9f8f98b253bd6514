"""Roofline terms of one step on one H100, and what the card measured.

Counterpart of ``repro.launch.hlo_analysis``'s ``Roofline``,
``make_roofline`` and ``model_flops_estimate`` and of the TPU constants of
``repro.launch.mesh``.  There is no compiled HLO to read: the compute term
is the analytic FLOP count (:mod:`repro_torch.launch.analytic_model`), the
memory term the bytes a step must move with each read once, and the
collective term the bytes a rank received, from the
:class:`~repro_torch.launch.mesh.SiloMesh`'s own counters.

* **compute** = FLOPs / 67 TFLOP/s: the port's products run in float32
  with TF32 off, outside the tensor cores.  The TF32 term (495 TFLOP/s)
  stands beside it; ``compute_rate`` names the rate the bound used.
* **memory** = bytes / 3.35 TB/s: the step's inputs read once and its
  outputs written once (weights, optimizer state, caches, tokens, logits).
* **collective** = received bytes / 450 GB/s (NVLink 4, one direction).

Rates are NVIDIA's data sheet for the H100 SXM.  The measured fields
(step seconds, and device-busy seconds, the idle share and device time
by part from :func:`repro_torch.launch.profile_round.device_profile`)
are filled only on the card; elsewhere they hold ``"not measured"``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

PEAK_FLOPS_F32 = 67e12     # float32 outside the tensor cores
PEAK_FLOPS_TF32 = 495e12   # TF32 tensor cores, dense
PEAK_FLOPS_BF16 = 989e12   # bfloat16 tensor cores, dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction
HBM_BYTES = 80e9           # one card's memory
CHIPS = 1

NOT_MEASURED = "not measured"
COMPUTE_RATE = "float32 67 TFLOP/s (TF32 off)"


@dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    batch: int                 # sequences in the step that ran (a micro-batch for training)
    analytic_gflops: float     # exact matmul accounting of that step
    compute_ms: float          # at the float32 rate
    compute_tf32_ms: float     # the same FLOPs at the TF32 rate
    compute_rate: str
    gbytes: float              # bytes moved, each read or written once
    memory_ms: float
    coll_gbytes: float         # bytes a rank received
    collective_ms: float
    bottleneck: str
    bound_ms: float            # the largest term
    model_gflops: float        # 6*N*D (or 2*N*D) useful FLOPs
    useful_flop_ratio: float   # model / analytic
    step_s: Any = NOT_MEASURED
    device_busy_s: Any = NOT_MEASURED
    idle_share: Any = NOT_MEASURED
    parts_s: Any = NOT_MEASURED
    share: Any = NOT_MEASURED  # bound_ms / step time

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


def make_roofline(*, arch: str, shape: str, batch: int, flops: float, bytes_moved: float,
                  model_flops: float, coll_bytes: float = 0.0,
                  measured: Optional[Dict[str, Any]] = None) -> Roofline:
    """The three terms, the bottleneck and, from ``measured`` (card runs
    only: ``step_s`` and, from one profiler window, ``device_busy_s``,
    ``idle_share`` and ``parts_s``), the share of the bound the step
    reached."""
    terms = {"compute": flops / PEAK_FLOPS_F32, "memory": bytes_moved / HBM_BW,
             "collective": coll_bytes / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    roof = Roofline(
        arch=arch, shape=shape, chips=CHIPS, batch=batch,
        analytic_gflops=flops / 1e9,
        compute_ms=terms["compute"] * 1e3,
        compute_tf32_ms=flops / PEAK_FLOPS_TF32 * 1e3,
        compute_rate=COMPUTE_RATE,
        gbytes=bytes_moved / 1e9,
        memory_ms=terms["memory"] * 1e3,
        coll_gbytes=coll_bytes / 1e9,
        collective_ms=terms["collective"] * 1e3,
        bottleneck=bottleneck,
        bound_ms=terms[bottleneck] * 1e3,
        model_gflops=model_flops / 1e9,
        useful_flop_ratio=(model_flops / flops) if flops else 0.0,
    )
    if measured:
        step_s = measured["step_s"]
        roof.step_s = step_s
        roof.share = roof.bound_ms / (step_s * 1e3)
        if measured.get("idle_share") is not None:
            roof.device_busy_s = measured["device_busy_s"]
            roof.idle_share = measured["idle_share"]
            roof.parts_s = measured["parts_s"]
    return roof


def model_flops_estimate(shape_spec: Dict, n_params_active: float, kind: str) -> float:
    """6*N*D for training, 2*N*D for a forward (per step)."""
    if kind == "train":
        tokens = shape_spec["seq_len"] * shape_spec["global_batch"]
        return 6.0 * n_params_active * tokens
    if kind == "prefill":
        tokens = shape_spec["seq_len"] * shape_spec["global_batch"]
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape_spec["global_batch"]
