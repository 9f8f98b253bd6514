"""Nothing the harness loads is JAX, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the
program), and no source under ``portbench/`` imports them."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_harness_import_path_loads_no_jax(tmp_path):
    code = (
        "import json, sys, importlib, pkgutil; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
        "import portbench.run, portbench.calibrate;"
        "from portbench import core, entries, metrics, reference;"
        "from portbench.tests.conftest import make_tiny_root;"
        "import pathlib;"
        "[importlib.import_module(f'{p.__name__}.{m.name}') for p in (entries, metrics, reference)"
        " for m in pkgutil.iter_modules(p.__path__)];"
        "core.ROOT = make_tiny_root(pathlib.Path(sys.argv[2]));"
        "[core.run_cell(w['name'], 7, 0.2, False, device='cpu', options={'check_only': True})"
        " for w in core.benchmark()['workloads']];"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tmp_path / "root")],
                         capture_output=True, text=True, timeout=900, check=True, env=env)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_source_imports_jax():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".", 1)[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import core

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in core.forbidden_modules() or "repro" in {
        m.split(".", 1)[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in core.forbidden_modules()
