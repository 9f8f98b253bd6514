"""A cell, a configuration and a per-layer metric added as new files are
found by name, with no edit to a file that is there."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT, make_tiny_root


def test_new_files_are_found(tmp_path):
    root = make_tiny_root(tmp_path / "repo")
    shutil.copytree(ROOT / "portbench", root / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("configs", "workloads", "__pycache__", ".cache"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / bench["configs"][0]["file"]).read_text())
    (root / "portbench" / "configs" / "tiny-new.json").write_text(json.dumps(conf))
    cell = json.loads((root / "portbench" / "workloads" /
                       f"{bench['workloads'][0]['name']}.json").read_text())
    cell["traffic"]["silos"] = 2
    (root / "portbench" / "workloads" / "tiny-new.two.json").write_text(json.dumps(cell))
    (root / "portbench" / "metrics" / "rounds_seen.py").write_text(
        "def read(rec):\n    return len(rec.get('round_s') or []) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny-new",
                                 file="portbench/configs/tiny-new.json"))
    bench["workloads"].append({"name": "tiny-new.two", "config": "tiny-new", "traffic": "two",
                               "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "rounds_seen", "unit": "rounds", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-new.two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from portbench import core;"
            "rec = core.run_cell('tiny-new.two', 5, 0.5, False, device='cpu');"
            "print(json.dumps({'m': rec['metrics'], 'ok': core.judge(rec['checks'])}))")
    out = subprocess.run([sys.executable, "-c", code, str(root), str(ROOT / "src")],
                         capture_output=True, text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"]
    assert res["m"]["rounds_seen"]["value"] >= 1
    assert set(res["m"]) == {"train_tokens_per_s", "peak_mem_gib", "setup_s",
                             "rounds_seen"} - {"peak_mem_gib"}   # no device peak on the CPU
