"""The port's optimizers and its two-slot optimizer state against the JAX
package, on the CPU.

* ``adam``, ``adamw`` (with and without weight decay, with a schedule),
  ``sgd`` and ``momentum`` under ``inverse_sqrt_decay``: 50 updates from
  the same numpy parameters and gradients, params and every slot within
  1e-6 relative of ``repro.optim``'s after each step; ``clip_by_global_norm``
  (clipping and not) and ``inverse_sqrt_decay`` (with and without warm-up)
  within 1e-6; the reference's optimizer tests (tests/test_substrate.py)
  mirrored on flat rows.
* The step counter: a schedule, Adam and AdamW refuse an update without
  one; SGD and momentum with a constant rate do not need it.
* The AdamW state ``{"mu": buf, "nu": buf}``: ``init_state`` stacks both
  slots; ``from_jax_params`` / ``state_to_tree`` carry a reference AdamW
  train state over and back bit for bit, its bytes equal the reference's,
  and checkpoints written by either package load in the other;
  ``migrate_silo_state`` keeps survivors bit-identical in every slot and
  puts joiners at the float64 consensus, equal to the reference's
  migration bit for bit; ``slice_silo_row`` equals the reference's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as RC  # noqa: E402
import repro.optim as JO  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fed import init_state as j_init_state  # noqa: E402
from repro.fed.dpasgd import migrate_silo_state as j_migrate  # noqa: E402
from repro.fed.dpasgd import slice_silo_row as j_slice  # noqa: E402
from repro.optim.optimizers import inverse_sqrt_decay as j_inverse_sqrt_decay  # noqa: E402
import repro_torch.checkpoint as PC  # noqa: E402
import repro_torch.optim as PO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import init_state, migrate_silo_state, slice_silo_row  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs, state_to_tree  # noqa: E402

P = 1031  # one flat row: not a multiple of any vector width


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OPTIMIZERS = {
    "adam": lambda O, S: O.adam(1e-3),
    "adamw_decay": lambda O, S: O.adamw(3e-3, weight_decay=0.1),
    "adamw_no_decay": lambda O, S: O.adamw(3e-3, b1=0.8, b2=0.99, eps=1e-6),
    "adamw_schedule": lambda O, S: O.adamw(S(1e-3, warmup=10), weight_decay=0.01),
    "sgd_schedule": lambda O, S: O.sgd(S(0.1, warmup=5)),
    "momentum_schedule": lambda O, S: O.momentum(S(0.05), 0.9),
}


def _j_slots(state):
    """The reference's optimizer state of a ``{"w": row}`` tree by slot
    name, as numpy: ``()`` (SGD), ``{"w": m}`` (momentum) or ``{"mu":
    {"w": ...}, "nu": {"w": ...}}`` (Adam)."""
    if isinstance(state, tuple):
        return {}
    if set(state) == {"w"}:
        return {"m": np.asarray(state["w"])}
    return {k: np.asarray(v["w"]) for k, v in state.items()}


def _t_slots(state):
    if state is None:
        return {}
    if isinstance(state, torch.Tensor):
        return {"m": state.numpy()}
    return {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_fifty_updates_match_reference(name):
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(P).astype(np.float32)
    grads = rng.standard_normal((50, P)).astype(np.float32)
    grads[:, ::17] *= 1e-6  # near-zero gradients: Adam's first steps are +-lr there
    grads[3, ::5] = 0.0
    j_opt = OPTIMIZERS[name](JO, j_inverse_sqrt_decay)
    t_opt = OPTIMIZERS[name](PO, PO.inverse_sqrt_decay)
    jp = {"w": jnp.asarray(p0)}
    jstate = j_opt.init(jp)
    tp = torch.from_numpy(p0.copy())
    tstate = t_opt.init(tp)
    for step in range(50):
        jp, jstate = j_opt.update({"w": jnp.asarray(grads[step])}, jstate, jp, jnp.int32(step))
        t_opt.update(torch.from_numpy(grads[step]), tstate, tp, step)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-9)
        t_slots, j_slots = _t_slots(tstate), _j_slots(jstate)
        assert sorted(t_slots) == sorted(j_slots)
        for k in j_slots:
            np.testing.assert_allclose(t_slots[k], j_slots[k], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = np.random.default_rng(1).standard_normal(P).astype(np.float32) * 3
    j_clipped, j_norm = JO.clip_by_global_norm({"w": jnp.asarray(g)}, max_norm)
    clipped, norm = PO.clip_by_global_norm(torch.from_numpy(g), max_norm)
    np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
    np.testing.assert_allclose(clipped.numpy(), np.asarray(j_clipped["w"]), rtol=1e-6)
    assert (max_norm > float(norm)) == bool(torch.equal(clipped, torch.from_numpy(g)))


@pytest.mark.parametrize("warmup", [0, 10])
def test_inverse_sqrt_decay_matches_reference(warmup):
    j_lr, t_lr = j_inverse_sqrt_decay(0.3, warmup), PO.inverse_sqrt_decay(0.3, warmup)
    for step in range(50):
        np.testing.assert_allclose(t_lr(step), float(j_lr(jnp.int32(step))), rtol=1e-6)


# the reference's optimizer tests (tests/test_substrate.py), on flat rows


@pytest.mark.parametrize("make_opt", [
    lambda: PO.sgd(0.1),
    lambda: PO.momentum(0.05, 0.9),
    lambda: PO.adam(0.5),
    lambda: PO.adamw(0.5, weight_decay=0.0),
], ids=["sgd", "momentum", "adam", "adamw"])
def test_optimizers_minimize_quadratic(make_opt):
    opt = make_opt()
    p = torch.zeros(4)
    state = opt.init(p)
    for step in range(200):
        opt.update(2 * (p - 3.0), state, p, step)
    np.testing.assert_allclose(p.numpy(), 3.0, atol=0.05)


def test_adamw_weight_decay_shrinks():
    opt = PO.adamw(0.1, weight_decay=0.5)
    p = torch.ones(4) * 10.0
    state = opt.init(p)
    for step in range(50):
        opt.update(torch.zeros(4), state, p, step)
    assert float(p.abs().max()) < 10.0


def test_clip_by_global_norm():
    clipped, norm = PO.clip_by_global_norm(torch.ones(100) * 10.0, 1.0)
    assert float(torch.linalg.vector_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(100.0, rel=1e-5)


def test_inverse_sqrt_decay():
    lr = PO.inverse_sqrt_decay(0.1)
    assert lr(1) == pytest.approx(0.1)
    assert lr(100) == pytest.approx(0.01)


def test_step_counter_required_where_read():
    g, p = torch.ones(4), torch.zeros(4)
    for opt in (PO.adam(0.1), PO.adamw(0.1), PO.sgd(PO.inverse_sqrt_decay(0.1)),
                PO.momentum(PO.inverse_sqrt_decay(0.1))):
        with pytest.raises(ValueError, match="step"):
            opt.update(g, opt.init(p), p)
    assert not p.any()
    for opt in (PO.sgd(0.5), PO.momentum(0.5)):
        opt.update(g, opt.init(p), p)
    assert torch.equal(p, torch.full((4,), -1.0))


# the two-slot state


def _ref_state(n, seed=3):
    cfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=n)
    state = j_init_state(cfg, JO.adamw(1e-3), jax.random.PRNGKey(seed))
    # slots that differ from silo to silo and from each other
    rng = np.random.default_rng(seed)
    state = jax.device_get(state)
    state["opt_state"] = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), state["opt_state"])
    state["step"] = np.int32(5)
    return state


def _layout():
    return ParamLayout(model_specs(get_config("internlm2-1.8b").reduced()))


def _same_leaves(a, b):
    la = jax.tree_util.tree_flatten_with_path(a)[0]
    lb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)
               for (_, x), (_, y) in zip(la, lb))


def test_init_state_stacks_both_slots():
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=3)
    state = init_state(cfg, PO.adamw(1e-4), device="cpu")
    P_ = _layout().size
    assert set(state["opt_state"]) == {"mu", "nu"}
    for buf in state["opt_state"].values():
        assert buf.shape == (3, P_) and buf.dtype == torch.float32 and not buf.any()


@pytest.mark.parametrize("n", [1, 3])
def test_adamw_state_round_trips_and_bytes_equal_reference(n):
    ref = _ref_state(n)
    state = from_jax_params(ref, device="cpu")
    assert set(state["opt_state"]) == {"mu", "nu"} and state["step"] == 5
    lead = (n,) if n > 1 else ()
    assert all(b.shape == lead + (_layout().size,) for b in state["opt_state"].values())
    tree = state_to_tree(state, _layout())
    assert _same_leaves(tree, ref)
    assert PC.tree_to_bytes(tree) == RC.tree_to_bytes(ref)
    keys = [k for k, _ in PC.io._leaves_with_keys(tree)]
    assert "opt_state/mu/layers/0/attn/wq" in keys and "opt_state/nu/embed" in keys


def test_adamw_checkpoints_cross_load(tmp_path):
    ref = _ref_state(3)
    state = from_jax_params(ref, device="cpu")
    like = state_to_tree(state, _layout())
    r_path, p_path = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    RC.save_checkpoint(r_path, ref, step=5)
    PC.save_checkpoint(p_path, like, step=5)
    got = jax.tree_util.tree_map(lambda t: t.numpy(), PC.load_checkpoint(r_path, like))
    assert _same_leaves(got, ref)
    back = from_jax_params(got, device="cpu")
    for k in ("mu", "nu"):
        assert torch.equal(back["opt_state"][k], state["opt_state"][k])
    assert _same_leaves(RC.load_checkpoint(p_path, ref), ref)
    assert open(p_path, "rb").read() == open(r_path, "rb").read()


@pytest.mark.parametrize("old,new", [((0, 3, 5, 9), (0, 3, 9)), ((0, 3, 9), (0, 3, 5, 9)),
                                     ((0, 3, 9), (3, 4)), ((2, 7), (7,))])
def test_migration_carries_both_slots(old, new):
    ref = _ref_state(len(old))
    state = from_jax_params(ref, device="cpu")
    got, joined, left = migrate_silo_state(state, old, new)
    j_got, j_joined, j_left = j_migrate(ref, old, new)
    assert (joined, left) == (tuple(j_joined), tuple(j_left))
    expect = from_jax_params(jax.device_get(j_got), device="cpu")
    assert torch.equal(got["params"], expect["params"]) and got["step"] == 5
    for k in ("mu", "nu"):
        assert torch.equal(got["opt_state"][k], expect["opt_state"][k])
        o = state["opt_state"][k].view(len(old), -1)
        w = got["opt_state"][k].view(len(new), -1)
        for v in new:
            if v in old:
                assert torch.equal(w[new.index(v)], o[old.index(v)])
            else:
                rows = [old.index(u) for u in new if u in old]
                mean = o[rows].double().sum(0).div(len(rows)).float()
                assert torch.equal(w[new.index(v)], mean)


def test_slice_silo_row_carries_both_slots():
    ref = _ref_state(4)
    active = (0, 3, 5, 9)
    row = slice_silo_row(from_jax_params(ref, device="cpu"), active, 5, _layout())
    assert set(row["opt_state"]) == {"mu", "nu"}
    assert _same_leaves(row, j_slice(ref, active, 5))
