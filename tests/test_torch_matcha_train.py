"""Static ``--designer matcha`` training with the port against the JAX
package, on the CPU: the ``ScheduleSlot``'s per-round plans and
matrices, its rollback, ``masked_consensus``, one ``consensus_arg``
DPASGD round of the reduced internlm2 against the reference's jitted
step on the same matrix (2e-5, as tests/test_torch_design.py), and the
CLI's ``matcha:`` line."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.fed.dpasgd import masked_consensus as j_masked_consensus  # noqa: E402
from repro.fed.gossip import ScheduleSlot as JScheduleSlot  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.fed import ScheduleSlot, masked_consensus  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _homogeneous(pkg, n, budget=0.5, seed=0):
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return pkg.MatchaSchedule(
        matchings=tuple(tuple(m) for m in pkg.greedy_edge_coloring(pairs)),
        budget=budget, sample_seed=seed)


@pytest.mark.parametrize("n", [4, 5, 6, 7, 8])
def test_schedule_slot_plans_equal_reference(n):
    slot = ScheduleSlot(_homogeneous(P, n, 0.4, seed=n), n)
    ref = JScheduleSlot(_homogeneous(R, n, 0.4, seed=n), n)
    for k in range(50):
        got, want = slot.plan_for_round(k), ref.plan_for_round(k)
        assert got.terms == want.terms and got.n_silos == want.n_silos
        np.testing.assert_array_equal(slot.matrix_for_round(k), ref.matrix_for_round(k))
    assert slot.version == 0


def test_schedule_slot_cache_is_fifo_bounded_and_labels_map():
    silos = ("a", "b", "c", "d")
    sched = P.MatchaSchedule(matchings=((("a", "b"), ("c", "d")), (("a", "c"),), (("b", "d"),)),
                             budget=0.5)
    slot = ScheduleSlot(sched, 4, silos=silos, max_cached_plans=2)
    for k in range(30):
        slot.plan_for_round(k)
        assert len(slot._plan_cache) <= 2
    ref = JScheduleSlot(R.MatchaSchedule(matchings=sched.matchings, budget=0.5), 4, silos=silos)
    np.testing.assert_array_equal(slot.matrix_for_round(7), ref.matrix_for_round(7))


def test_swap_schedule_rolls_back_on_a_raising_callback():
    slot = ScheduleSlot(_homogeneous(P, 4), 4)
    old_sched, old_plan, old_hist = slot.schedule, slot.plan, list(slot.history)
    seen = []
    slot.on_swap(lambda plan, version: seen.append(version))
    assert slot.swap_schedule(_homogeneous(P, 4, 0.9), label="ok") == 1
    assert seen == [1] and slot.schedule.budget == 0.9

    def boom(plan, version):
        raise RuntimeError("callback failed")

    slot.on_swap(boom)
    before = (slot.schedule, slot.plan, slot.version, list(slot.history))
    with pytest.raises(RuntimeError, match="callback failed"):
        slot.swap_schedule(_homogeneous(P, 5), label="bad", silos=range(5))
    assert (slot.schedule, slot.plan, slot.version, list(slot.history)) == before
    assert slot.plan_for_round(0).n_silos == 4
    assert old_sched is not slot.schedule and old_plan.n_silos == 4 and old_hist == [(0, "init")]


def test_masked_consensus_equals_reference():
    A = ScheduleSlot(_homogeneous(P, 6, 0.7), 6).matrix_for_round(3)
    for mask in ([1, 1, 0, 1, 1, 1], [0, 0, 0, 0, 0, 1], [1] * 6):
        got = masked_consensus(torch.from_numpy(A), mask)
        want = np.asarray(j_masked_consensus(jnp.asarray(A), jnp.asarray(mask)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
        np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-12)


def test_consensus_arg_refuses_a_plan_lowering():
    from repro_torch.configs import get_config
    from repro_torch.fed import DPASGDConfig, make_train_step
    from repro_torch.optim import momentum

    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=4)
    for impl in ("pallas", "ppermute"):
        with pytest.raises(ValueError, match="consensus_arg"):
            make_train_step(cfg, DPASGDConfig(gossip_impl=impl), momentum(0.05), None,
                            consensus_arg=True)


def test_consensus_arg_round_matches_reference():
    """One DPASGD round of the reduced internlm2 on 4 silos with MATCHA's
    round-2 matrix as the step input, against the reference's jitted
    ``consensus_arg`` step on the same matrix, state and batch (2e-5)."""
    from repro.configs import get_config as j_get_config
    from repro.data import FederatedBatcher as JBatcher
    from repro.data import SyntheticLMStream as JStream
    from repro.fed import DPASGDConfig as JFed
    from repro.fed import init_state as j_init_state
    from repro.fed import make_train_step as j_make_train_step
    from repro.optim import momentum as j_momentum
    from repro_torch.configs import get_config
    from repro_torch.fed import DPASGDConfig, make_train_step
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import from_jax_params
    from repro_torch.optim import momentum

    n = 4
    A = ScheduleSlot(_homogeneous(P, n), n).matrix_for_round(2)
    np.testing.assert_array_equal(A, JScheduleSlot(_homogeneous(R, n), n).matrix_for_round(2))
    jcfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=n)
    jopt = j_momentum(0.05, 0.9)
    state = j_init_state(jcfg, jopt, jax.random.PRNGKey(0))
    init_np = jax.device_get(state)
    raw = JBatcher(JStream(jcfg.vocab_size, 16, n_silos=n), 2, 2).batch(0)
    jstep = jax.jit(j_make_train_step(jcfg, JFed(local_steps=2, gossip_impl="einsum"), jopt,
                                      None, consensus_arg=True))
    j_state, j_metrics = jstep(state, {k: jnp.asarray(v) for k, v in raw.items()},
                               jnp.asarray(A))

    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=n)
    step = make_train_step(cfg, DPASGDConfig(local_steps=2, gossip_impl="einsum"),
                           momentum(0.05, 0.9), None, consensus_arg=True)
    before = dict(LAUNCHES)
    port_state, metrics = step(from_jax_params(init_np, device="cpu"),
                               batch_to_device(raw, CPU), A)
    assert LAUNCHES == before
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), atol=2e-5)
    expect = from_jax_params(jax.device_get(j_state), device="cpu")
    np.testing.assert_allclose(port_state["params"].numpy(), expect["params"].numpy(),
                               atol=2e-5)


def test_train_cli_prints_the_reference_matcha_line():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--designer", "matcha", "--steps", "2", "--seq-len", "16", "--batch-per-silo", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = _homogeneous(R, 4)
    line = (f"matcha: homogeneous K_4 base graph, {ref.num_matchings} matchings, "
            f"C_b={ref.budget:g} (per-round sampled plans)")
    assert line in proc.stdout.splitlines()
    assert "gossip-impl-override" in proc.stdout
    losses = [float(ln.split()[3]) for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_records_each_rounds_matrix():
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    res = train(get_config("internlm2-1.8b").reduced(), silos=4, designer="matcha",
                gossip_impl="einsum", matcha_budget=0.3, scenario_seed=2, steps=3,
                seq_len=16, batch_per_silo=2, device="cpu", log=lambda line: None)
    host = ScheduleSlot(_homogeneous(P, 4, 0.3, seed=2), 4)
    assert len(res.consensus) == 3 and res.plan is None
    for i, A in enumerate(res.consensus):
        np.testing.assert_array_equal(A, host.matrix_for_round(i))
    assert all(np.isfinite(res.losses))
