"""The port stands alone: importing it (the step functions and the
optimizers included) loads neither JAX nor the JAX package, no file of
it (or chip_smoke.py) imports either, its entry
points refuse to fall back to the CPU, and chip_smoke.py fails without
a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    TrainingParams,
    design_overlay,
    design_schedule,
    make_underlay,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fed import init_state  # noqa: E402
from repro_torch.launch.mesh import init_silo_mesh  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import from_jax_params, init_params, model_specs  # noqa: E402
from repro_torch.optim import momentum  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dynamics_and_checkpoint_load_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.dynamics, repro_torch.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    scanned = {p.relative_to(REPO).parts[:3] for p in PORT_FILES}
    assert ("src", "repro_torch", "dynamics") in scanned
    assert ("src", "repro_torch", "checkpoint") in scanned


def test_moe_and_mla_load_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.models.moe, repro_torch.models.attention\n"
        "import repro_torch.configs as C\n"
        "C.get_config('deepseek-v2-lite-16b')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert REPO / "src" / "repro_torch" / "models" / "moe.py" in PORT_FILES


def test_whisper_and_simulator_load_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.core.simulator, repro_torch.models.transformer\n"
        "import repro_torch.configs as C, repro_torch.core as P\n"
        "C.get_config('whisper-large-v3').reduced()\n"
        "P.brute_force_mct, P.simulate_overlay\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for rel in ("core/simulator.py", "configs/whisper_large_v3.py"):
        assert REPO / "src" / "repro_torch" / rel in PORT_FILES


def test_steps_and_optim_load_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.launch.steps, repro_torch.optim\n"
        "from repro_torch.optim import adamw, inverse_sqrt_decay\n"
        "adamw(inverse_sqrt_decay(1e-4, 10))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert REPO / "src" / "repro_torch" / "launch" / "steps.py" in PORT_FILES


def test_obs_loads_neither_jax_nor_reference_nor_torch():
    code = (
        "import sys, repro_torch.obs\n"
        "from repro_torch.obs import events, log, metrics, report, spans\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'torch'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("__init__", "spans", "metrics", "events", "log", "report"):
        assert REPO / "src" / "repro_torch" / "obs" / f"{name}.py" in PORT_FILES


def test_mesh_loads_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.launch.mesh\n"
        "from repro_torch.fed.gossip import mix_rank\n"
        "from repro_torch.fed.dpasgd import migrate_rank_state\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert REPO / "src" / "repro_torch" / "launch" / "mesh.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_or_jax_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


def _cfg():
    return get_config("internlm2-1.8b").reduced()


def _controller():
    from repro_torch.core import ring_overlay
    from repro_torch.dynamics import OnlineTopologyController

    gc, tp = make_underlay("gaia").connectivity_graph(25.4), TrainingParams(42.88)
    return OnlineTopologyController(gc, tp, ring_overlay(gc, tp))


@pytest.mark.parametrize("call", [
    lambda: resolve_device(),
    lambda: init_state(_cfg(), momentum(0.05)),
    lambda: init_params(model_specs(_cfg())),
    lambda: from_jax_params({"w": [[1.0]]}),
    lambda: train(_cfg(), steps=1),
    lambda: design_overlay("sparse_rewire", make_underlay("gaia").connectivity_graph(25.4),
                           TrainingParams(42.88)),
    lambda: serve(_cfg(), batch=1, gen=2),
    lambda: design_schedule("matcha", make_underlay("gaia").connectivity_graph(25.4),
                            TrainingParams(42.88)),
    lambda: _controller(),
    lambda: train(_cfg(), dynamic=True, steps=1),
    lambda: serve(get_config("qwen3-moe-30b-a3b").reduced(), batch=1, gen=2),
    lambda: serve(get_config("whisper-large-v3").reduced(), batch=1, gen=2),
    lambda: init_silo_mesh(0, 1, "file:///nonexistent/store"),
], ids=["resolve_device", "init_state", "init_params", "from_jax_params", "train",
        "design_overlay", "serve", "design_schedule", "OnlineTopologyController",
        "train_dynamic", "serve_moe", "serve_whisper", "init_silo_mesh"])
def test_entry_points_refuse_cpu_fallback(no_gpu, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_chip_smoke_fails_without_gpu(no_gpu):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
