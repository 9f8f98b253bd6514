"""The port's checkpoints against the JAX package's, on the CPU.

The port writes the reference's format (msgpack, path-keyed leaves, a
``.meta.json`` beside the file): a checkpoint the port writes loads with
``repro.checkpoint.load_checkpoint`` and one the reference writes loads
with the port's, leaf for leaf; the bytes of a tree are the same in both
packages; ``state_to_tree`` inverts ``from_jax_params``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.checkpoint as RC  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fed import init_state as j_init_state  # noqa: E402
from repro.fed.dpasgd import slice_silo_row as j_slice  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
import repro_torch.checkpoint as PC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import slice_silo_row  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs, state_to_tree  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default of one thread per core in each
    makes these small eager loops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_state(n, opt="momentum"):
    cfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=n)
    optimizer = j_momentum(0.05, 0.9) if opt == "momentum" else j_sgd(0.05)
    return jax.device_get(j_init_state(cfg, optimizer, jax.random.PRNGKey(3)))


def _layout():
    return ParamLayout(model_specs(get_config("internlm2-1.8b").reduced()))


def _assert_same_leaves(a, b):
    la = jax.tree_util.tree_flatten_with_path(a)[0]
    lb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), p


@pytest.mark.parametrize("n,opt", [(3, "momentum"), (1, "momentum"), (2, "sgd")])
def test_state_to_tree_inverts_from_jax_params(n, opt):
    ref = _ref_state(n, opt)
    tree = state_to_tree(from_jax_params(ref, device="cpu"), _layout())
    _assert_same_leaves(tree, ref)
    assert tree["step"].dtype == np.int32


@pytest.mark.parametrize("opt", ["momentum", "sgd"])
def test_tree_bytes_equal_reference(opt):
    ref = _ref_state(3, opt)
    port_tree = state_to_tree(from_jax_params(ref, device="cpu"), _layout())
    assert PC.tree_to_bytes(port_tree) == RC.tree_to_bytes(ref)


def test_port_checkpoint_loads_in_reference(tmp_path):
    ref = _ref_state(3)
    state = from_jax_params(ref, device="cpu")
    path = str(tmp_path / "sub" / "state.msgpack")
    PC.save_checkpoint(path, state_to_tree(state, _layout()), step=7)
    _assert_same_leaves(RC.load_checkpoint(path, ref), ref)
    assert json.loads(Path(path + ".meta.json").read_text())["step"] == 7
    assert sorted(os.listdir(tmp_path / "sub")) == ["state.msgpack", "state.msgpack.meta.json"]


def test_reference_checkpoint_loads_in_port(tmp_path):
    ref = _ref_state(3)
    path = str(tmp_path / "state.msgpack")
    RC.save_checkpoint(path, ref, step=2)
    like = state_to_tree(from_jax_params(_ref_state(3, "momentum"), device="cpu"), _layout())
    got = PC.load_checkpoint(path, like)
    assert isinstance(got["params"]["embed"], torch.Tensor)
    _assert_same_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got), ref)
    back = from_jax_params(jax.tree_util.tree_map(lambda t: t.numpy(), got), device="cpu")
    expect = from_jax_params(ref, device="cpu")
    assert torch.equal(back["params"], expect["params"])
    assert torch.equal(back["opt_state"], expect["opt_state"])


def test_silo_checkpoints_cross_load(tmp_path):
    """A leaver's row written by either package loads in the other."""
    ref = _ref_state(4)
    state = from_jax_params(ref, device="cpu")
    active = (0, 3, 5, 9)
    row = slice_silo_row(state, active, 5, _layout())
    j_row = j_slice(ref, active, 5)
    p_path = PC.save_silo_checkpoint(str(tmp_path / "port"), 5, row, step=11)
    r_path = RC.save_silo_checkpoint(str(tmp_path / "ref"), 5, j_row, step=11)
    assert os.path.basename(p_path) == os.path.basename(r_path) == "silo5_step11.msgpack"
    _assert_same_leaves(RC.load_checkpoint(p_path, j_row), j_row)
    got = PC.load_checkpoint(r_path, row)
    _assert_same_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got), j_row)
    assert Path(p_path).read_bytes() == Path(r_path).read_bytes()


def test_load_refuses_missing_and_misshapen_leaves(tmp_path):
    path = str(tmp_path / "w.msgpack")
    PC.save_checkpoint(path, {"w": np.zeros((2, 3), np.float32)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        PC.load_checkpoint(path, {"v": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch at w"):
        PC.load_checkpoint(path, {"w": np.zeros((3, 2), np.float32)})
    got = PC.load_checkpoint(path, {"w": torch.ones((2, 3), dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and not got["w"].any()


def test_msgpack_is_imported_lazily():
    code = ("import sys, repro_torch.checkpoint, repro_torch.launch.train\n"
            "sys.exit(1 if 'msgpack' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
