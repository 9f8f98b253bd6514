"""Fixtures of the benchmark's tests: the repository on the path, and a
copy of ``BENCHMARK.json`` whose configurations are cut to a size the
CPU runs in seconds (every width small, the structure the same)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)   # several workers share the CPU

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256)


def make_tiny_root(dest: Path) -> Path:
    """A benchmark root at ``dest``: ``BENCHMARK.json`` as committed, each
    configuration at :data:`TINY` sizes (a window of 16), each cell at
    32-token sequences and 12 window rounds."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "portbench" / "configs").mkdir(parents=True)
    (dest / "portbench" / "workloads").mkdir(parents=True)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(TINY)
        if "sliding_window" in conf:
            conf["sliding_window"] = 16
        (dest / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        cell = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        t = cell["traffic"]
        if "seq_len" in t:
            t["seq_len"] = 32
        else:
            t["train"]["seq_len"] = 32
            t["rounds_per_second"] = 1
        (dest / "portbench" / "workloads" / f"{w['name']}.json").write_text(json.dumps(cell))
    return dest


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    from portbench import core

    root = make_tiny_root(tmp_path)
    monkeypatch.setattr(core, "ROOT", root)
    return root
