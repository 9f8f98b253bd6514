"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  A CUDA
request on a machine without a usable GPU raises instead of quietly
running on the CPU: the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
