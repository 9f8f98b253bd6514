"""PyTorch/CUDA port of the federated-learning topology runtime.

A second package beside the JAX reference (``src/repro``), written for
one or more NVIDIA H100s.  It imports ``torch`` and numpy only, never
JAX and never the JAX package: what it needs of the reference's numpy
host code (Birkhoff decomposition, consensus matrices, the synthetic
data stream) it keeps as its own copy.

Layout mirrors the reference so each module has an obvious
counterpart: ``core`` (plans' host math), ``kernels`` (hand-written
Hopper kernels and their plain PyTorch versions), ``fed`` (gossip
lowerings, DPASGD), ``models`` (the dense GQA transformer), ``configs``,
``optim``, ``data``, ``obs`` (spans, metrics and the flight recorder)
and ``launch`` (the training entry point).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that explicit request they raise
(:func:`repro_torch.device.resolve_device`).
"""

__all__ = ["device"]
