"""Static analysis and runtime-contract tooling for the port (the
reference's ``repro.analysis``, retargeted at ``src/repro_torch``).

Kept import-light: the engine modules import ``contracts`` at module
load, so nothing here may pull in numpy/torch or the lint machinery.
``repro_torch.analysis.lint`` and ``repro_torch.analysis.recompile``
are imported on demand by their consumers
(``python -m repro_torch.analysis.lint``, tests, ``chip_smoke.py``).
"""

from .contracts import ContractError, contract, checking_enabled

__all__ = ["contract", "ContractError", "checking_enabled"]
