"""The control on the card, at each cell's own size: the program's check
rounds pass the cell's limits, and the same rounds with the matrix
products in TF32 (the nearest precision below the configurations'
float32) do not.  Skips without a CUDA device."""

from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import core

    seed = 6_000_000_017
    ok = core.run_cell(cell, seed, 0, False, options={"check_only": True})
    assert core.judge(ok["checks"]), ok["checks"]
    control = core.run_cell(cell, seed, 0, False, options={"check_only": True, "control": "tf32"})
    assert not core.judge(control["checks"]), control["checks"]
