"""Elastic membership in the port, against the JAX package, on the CPU.

* :class:`MembershipSlot` — the reference's contract and its refusals;
* :func:`migrate_silo_state` / :func:`slice_silo_row` on port states
  carried over with ``from_jax_params`` from a reference state: the
  reference's bits, with leavers, joiners and both at once;
* one migration and one DPASGD round after it, port against the
  reference's ``migrate_silo_state`` and step from the same state;
* one DPASGD round of the reduced h2o-danube-1.8b (sliding-window
  attention) against the reference, at the tolerance of the internlm2
  rounds (2e-5)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.fed import DPASGDConfig as JFed  # noqa: E402
from repro.fed import init_state as j_init_state  # noqa: E402
from repro.fed import make_train_step as j_make_train_step  # noqa: E402
from repro.fed.dpasgd import migrate_silo_state as j_migrate  # noqa: E402
from repro.fed.dpasgd import slice_silo_row as j_slice  # noqa: E402
from repro.fed.topology_runtime import plan_for_n_silos as j_plan  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.fed import (DPASGDConfig, MembershipSlot, make_train_step,  # noqa: E402
                             migrate_silo_state, plan_for_n_silos, slice_silo_row)
from repro_torch.launch.train import batch_to_device  # noqa: E402
from repro_torch.checkpoint.io import _leaves_with_keys  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs, state_to_tree  # noqa: E402
from repro_torch.optim import momentum  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default of one thread per core in each
    makes these small eager loops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# MembershipSlot


def test_membership_slot_swap_contract():
    slot = MembershipSlot(range(5), 5)
    assert slot.active == (0, 1, 2, 3, 4)
    assert slot.n_active == 5 and slot.n_universe == 5
    seen = []
    slot.on_swap(lambda active, version: seen.append((active, version)))
    v = slot.swap((0, 1, 3, 4), label="silo 2 left")
    assert v == 1 and slot.active == (0, 1, 3, 4)
    assert seen == [((0, 1, 3, 4), 1)]
    assert slot.history[-1] == (1, "silo 2 left")
    # unchanged set (any order) is a no-op: version does not move
    assert slot.swap((4, 3, 1, 0)) == 1 and slot.version == 1
    v = slot.swap(range(5), label="silo 2 rejoined")
    assert v == 2 and slot.active == (0, 1, 2, 3, 4)


@pytest.mark.parametrize("bad", [(), (0, 0, 1), (0, 4)], ids=["empty", "duplicate", "outside"])
def test_membership_slot_rejects_bad_sets(bad):
    slot = MembershipSlot(range(4), 4)
    with pytest.raises(ValueError):
        slot.swap(bad)
    assert slot.version == 0 and slot.active == (0, 1, 2, 3)  # failed swaps change nothing
    with pytest.raises(ValueError):
        MembershipSlot((-1, 0), 4)


# ---------------------------------------------------------------------------
# Migration and the leaver's row


def _reference_state(n, opt="momentum", arch="internlm2-1.8b"):
    cfg = dataclasses.replace(j_get_config(arch).reduced(), n_silos=n)
    optimizer = j_momentum(0.05, 0.9) if opt == "momentum" else j_sgd(0.05)
    return jax.device_get(j_init_state(cfg, optimizer, jax.random.PRNGKey(n)))


def _layout(arch="internlm2-1.8b"):
    return ParamLayout(model_specs(get_config(arch).reduced()))


def _assert_tree_equal(port_tree, ref_tree):
    """Leaf for leaf, bits and dtypes (the reference's tree flattened in
    its own path order, the port's in the same order)."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = _leaves_with_keys(port_tree)
    assert len(port_leaves) == len(ref_leaves)
    for (pp, pv), (rp, rv) in zip(port_leaves, ref_leaves):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in rp)
        assert pp == key
        rv = np.asarray(rv)
        assert pv.dtype == rv.dtype and pv.shape == rv.shape, key
        assert np.array_equal(pv, rv), key


CASES = {
    "leaver": ((0, 1, 2, 3), (0, 1, 3)),
    "joiner": ((0, 1, 3), (0, 1, 2, 3)),
    "both": ((0, 1, 2, 3), (0, 2, 3, 5)),
    "two-joiners": ((1, 4, 6), (0, 1, 2, 4, 6)),
}


@pytest.mark.parametrize("opt", ["momentum", "sgd"])
@pytest.mark.parametrize("case", list(CASES))
def test_migration_equals_reference_bit_for_bit(case, opt):
    old, new = CASES[case]
    ref_state = _reference_state(len(old), opt)
    state = from_jax_params(ref_state, device="cpu")
    kept = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
    got, joined, left = migrate_silo_state(state, old, new)
    want, j_joined, j_left = j_migrate(ref_state, old, new)
    assert (joined, left) == (j_joined, j_left)
    assert got["params"].shape == (len(new), _layout().size)
    assert (got["opt_state"] is None) == (opt == "sgd")
    _assert_tree_equal(state_to_tree(got, _layout()), want)
    expect = from_jax_params(want, device="cpu")
    for k in kept:
        assert torch.equal(got[k], expect[k])
        assert torch.equal(state[k], kept[k])  # the old buffers are untouched
    assert got["step"] == state["step"]


def test_migration_to_and_from_one_silo():
    state = from_jax_params(_reference_state(3), device="cpu")
    one, joined, left = migrate_silo_state(state, (0, 4, 7), (4,))
    assert (joined, left) == ((), (0, 7)) and one["params"].shape == (_layout().size,)
    assert torch.equal(one["params"], state["params"][1])
    two, joined, _ = migrate_silo_state(one, (4,), (2, 4))
    assert joined == (2,) and two["params"].shape == (2, _layout().size)
    assert torch.equal(two["params"][0], one["params"])  # the mean of one row is that row
    assert torch.equal(two["params"][1], one["params"])


def test_migration_requires_a_surviving_silo():
    state = from_jax_params(_reference_state(3), device="cpu")
    with pytest.raises(ValueError, match="no surviving silos"):
        migrate_silo_state(state, (0, 1, 2), (3, 4))


@pytest.mark.parametrize("opt", ["momentum", "sgd"])
def test_slice_silo_row_equals_reference(opt):
    ref_state = _reference_state(4, opt)
    state = from_jax_params(ref_state, device="cpu")
    active = (0, 2, 5, 7)
    row = slice_silo_row(state, active, 5, _layout())  # label 5 = row 2
    _assert_tree_equal(row, j_slice(ref_state, active, 5))
    with pytest.raises(ValueError):
        slice_silo_row(state, active, 9, _layout())  # not an active label


# ---------------------------------------------------------------------------
# DPASGD rounds against the reference


def _round_pair(arch, old_active, new_active, universe, seq, rounds_before=1):
    """The reference and the port from one JAX-initialised state:
    ``rounds_before`` rounds over ``old_active``, a migration to
    ``new_active`` (when it differs) and one round after it.  Returns the
    per-round losses and final states of both."""
    S_LOCAL, B = 2, 2
    opt = j_momentum(0.05, 0.9)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), n_silos=len(old_active))
    jstate = j_init_state(jcfg, opt, jax.random.PRNGKey(1))
    init = jax.device_get(jstate)
    jbatcher = JBatcher(JStream(jcfg.vocab_size, seq, n_silos=universe), S_LOCAL, B)
    pcfg = dataclasses.replace(get_config(arch).reduced(), n_silos=len(old_active))
    pbatcher = FederatedBatcher(SyntheticLMStream(pcfg.vocab_size, seq, n_silos=universe),
                                S_LOCAL, B)
    fed = DPASGDConfig(local_steps=S_LOCAL, gossip_impl="pallas")
    state = from_jax_params(init, device="cpu")
    j_losses, p_losses = [], []
    plan = [(old_active, k) for k in range(rounds_before)] + [(new_active, rounds_before)]
    prev = old_active
    for active, r in plan:
        n = len(active)
        if active != prev:
            jstate, _, _ = j_migrate(jax.device_get(jstate), prev, active)
            state, _, _ = migrate_silo_state(state, prev, active)
            prev = active
        jc = dataclasses.replace(jcfg, n_silos=n)
        jstep = jax.jit(j_make_train_step(jc, JFed(local_steps=S_LOCAL, gossip_impl="einsum"),
                                          opt, j_plan("ring", n)))
        raw = jbatcher.batch(r, silos=active)
        praw = pbatcher.batch(r, silos=active)
        assert all(np.array_equal(praw[k], raw[k]) for k in raw)
        jstate, jm = jstep(jax.tree_util.tree_map(jax.numpy.asarray, jstate),
                           {k: jax.numpy.asarray(v) for k, v in raw.items()})
        j_losses.append(float(jm["loss"]))
        step = make_train_step(dataclasses.replace(pcfg, n_silos=n), fed, momentum(0.05, 0.9),
                               plan_for_n_silos("ring", n))
        state, pm = step(state, batch_to_device(praw, CPU))
        p_losses.append(float(pm["loss"]))
    return j_losses, p_losses, from_jax_params(jax.device_get(jstate), device="cpu"), state


@pytest.mark.parametrize("new_active", [(0, 1, 3, 4), (0, 1, 3)], ids=["both", "leaver"])
def test_round_after_migration_matches_reference(new_active):
    j_losses, p_losses, expect, got = _round_pair("internlm2-1.8b", (0, 1, 2, 3), new_active,
                                                  universe=5, seq=16)
    np.testing.assert_allclose(p_losses, j_losses, atol=2e-5)
    assert got["params"].shape[0] == len(new_active) and got["step"] == expect["step"] == 4
    np.testing.assert_allclose(got["params"].numpy(), expect["params"].numpy(), atol=2e-5)
    np.testing.assert_allclose(got["opt_state"].numpy(), expect["opt_state"].numpy(), atol=2e-5)


def test_danube_round_matches_reference():
    """One DPASGD round of the reduced h2o-danube-1.8b on 4 silos, 48
    tokens past its 32-token window."""
    j_losses, p_losses, expect, got = _round_pair("h2o-danube-1.8b", (0, 1, 2, 3),
                                                  (0, 1, 2, 3), universe=4, seq=48,
                                                  rounds_before=0)
    np.testing.assert_allclose(p_losses, j_losses, atol=2e-5)
    np.testing.assert_allclose(got["params"].numpy(), expect["params"].numpy(), atol=2e-5)
    np.testing.assert_allclose(got["opt_state"].numpy(), expect["opt_state"].numpy(), atol=2e-5)
