"""The whole slice: DPASGD rounds of the port against the JAX package.

Two rounds with 4 silos on a ring, s=2 local steps and momentum(0.05,
0.9), from the same JAX-initialised state carried over with
``from_jax_params``: the reference runs its ``einsum`` lowering (one
device, no mesh), the port its ``pallas``, ``ppermute`` and ``einsum``
lowerings on the CPU.  Params, optimizer slots and losses agree to atol
2e-5: the same f32 arithmetic with sums taken in a different order.  One
round of the reduced qwen3-moe-30b-a3b (MoE layers: the loss carries the
router's load-balance term) is held to the reference's the same way."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.fed import DPASGDConfig as JFed  # noqa: E402
from repro.fed import init_state as j_init_state  # noqa: E402
from repro.fed import make_train_step as j_make_train_step  # noqa: E402
from repro.fed.topology_runtime import plan_for_n_silos as j_plan  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_for_n_silos  # noqa: E402
from repro_torch.launch.train import batch_to_device, main, train  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.optim import momentum  # noqa: E402

N_SILOS, S_LOCAL, B, SEQ, ROUNDS = 4, 2, 2, 16, 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's initial state, batches and per-round results."""
    cfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=N_SILOS)
    opt = j_momentum(0.05, 0.9)
    state = j_init_state(cfg, opt, jax.random.PRNGKey(0))
    init_np = jax.device_get(state)
    step = jax.jit(j_make_train_step(cfg, JFed(local_steps=S_LOCAL, gossip_impl="einsum"),
                                     opt, j_plan("ring", N_SILOS)))
    batcher = JBatcher(JStream(cfg.vocab_size, SEQ, n_silos=N_SILOS), S_LOCAL, B)
    batches = [batcher.batch(r) for r in range(ROUNDS)]
    losses = []
    for b in batches:
        state, metrics = step(state, {k: jax.numpy.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return init_np, batches, losses, jax.device_get(state)


def _port_cfg():
    return dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=N_SILOS)


@pytest.mark.parametrize("impl", ["pallas", "ppermute", "einsum"])
def test_two_rounds_match_reference(reference, impl):
    init_np, batches, ref_losses, final_np = reference
    state = from_jax_params(init_np, device="cpu")
    assert state["params"].shape[0] == N_SILOS and state["step"] == 0
    step = make_train_step(_port_cfg(), DPASGDConfig(local_steps=S_LOCAL, gossip_impl=impl),
                           momentum(0.05, 0.9), plan_for_n_silos("ring", N_SILOS))
    port_batcher = FederatedBatcher(SyntheticLMStream(512, SEQ, n_silos=N_SILOS), S_LOCAL, B)
    for r, ref_batch in enumerate(batches):
        raw = port_batcher.batch(r)
        assert all(np.array_equal(raw[k], ref_batch[k]) for k in raw)
        state, metrics = step(state, batch_to_device(raw, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), ref_losses[r], atol=2e-5)
    expect = from_jax_params(final_np, device="cpu")
    assert state["step"] == expect["step"] == ROUNDS * S_LOCAL
    np.testing.assert_allclose(state["params"].numpy(), expect["params"].numpy(), atol=2e-5)
    np.testing.assert_allclose(state["opt_state"].numpy(), expect["opt_state"].numpy(), atol=2e-5)


def test_accumulation_matches_full_batch():
    cfg = _port_cfg()
    opt = momentum(0.05, 0.9)
    plan = plan_for_n_silos("ring", N_SILOS)
    raw = FederatedBatcher(SyntheticLMStream(512, SEQ, n_silos=N_SILOS), S_LOCAL, 4).batch(0)
    full = batch_to_device(raw, CPU)
    split = {k: v.reshape(N_SILOS, S_LOCAL, 2, 2, SEQ) for k, v in full.items()}
    results = []
    for accum, batch in [(1, full), (2, split)]:
        state = init_state(cfg, opt, seed=1, device="cpu")
        step = make_train_step(cfg, DPASGDConfig(S_LOCAL, "pallas", accum_steps=accum), opt, plan)
        state, metrics = step(state, batch)
        results.append((state["params"], float(metrics["loss"])))
    np.testing.assert_allclose(results[1][0].numpy(), results[0][0].numpy(), atol=1e-6)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)


def test_train_entry_point_runs_and_learns(capsys):
    res = train(get_config("internlm2-1.8b").reduced(), silos=2, gossip_impl="pallas",
                local_steps=2, batch_per_silo=2, seq_len=16, steps=6, device="cpu")
    assert len(res.losses) == 6 and np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    assert res.state["step"] == 12 and res.plan.num_transfers == 1
    capsys.readouterr()
    assert main(["--reduced", "--device", "cpu", "--silos", "1", "--steps", "2",
                 "--seq-len", "8", "--batch-per-silo", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and lines[0].startswith("step    0 loss ")


def test_profile_round_reports_without_device_events():
    from repro_torch.launch.profile_round import kernel_part, profile_round, report

    res = train(get_config("internlm2-1.8b").reduced(), silos=2, gossip_impl="pallas",
                local_steps=1, batch_per_silo=1, seq_len=8, steps=1, device="cpu",
                log=lambda line: None)
    prof = profile_round(res, 1)
    assert prof["wall_s"] > 0 and prof["idle_share"] is None and res.state["step"] == 2
    assert report(prof)[1].startswith("device time: not measured")
    assert kernel_part("void (anonymous namespace)::gossip_mix_kernel<float, true>") \
        == "gossip_mix kernel"
    assert kernel_part("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n") == "matrix products"
    assert kernel_part("Memcpy DtoD (Device -> Device)") == "copies and fills"


def test_moe_round_matches_reference():
    """One round of the reduced qwen3-moe-30b-a3b, 2 silos on a ring,
    ``pallas`` mix, from the reference's initial state."""
    n, arch = 2, "qwen3-moe-30b-a3b"
    cfg_j = dataclasses.replace(j_get_config(arch).reduced(), n_silos=n)
    state_j = j_init_state(cfg_j, j_momentum(0.05, 0.9), jax.random.PRNGKey(3))
    init_np = jax.device_get(state_j)
    raw = JBatcher(JStream(cfg_j.vocab_size, SEQ, n_silos=n), S_LOCAL, B).batch(0)
    step_j = jax.jit(j_make_train_step(cfg_j, JFed(local_steps=S_LOCAL, gossip_impl="einsum"),
                                       j_momentum(0.05, 0.9), j_plan("ring", n)))
    state_j, metrics_j = step_j(state_j, {k: jax.numpy.asarray(v) for k, v in raw.items()})
    cfg_t = dataclasses.replace(get_config(arch).reduced(), n_silos=n)
    step = make_train_step(cfg_t, DPASGDConfig(local_steps=S_LOCAL, gossip_impl="pallas"),
                           momentum(0.05, 0.9), plan_for_n_silos("ring", n))
    state, metrics = step(from_jax_params(init_np, device="cpu"), batch_to_device(raw, CPU))
    np.testing.assert_allclose(float(metrics["loss"]), float(metrics_j["loss"]), atol=2e-5)
    expect = from_jax_params(jax.device_get(state_j), device="cpu")
    np.testing.assert_allclose(state["params"].numpy(), expect["params"].numpy(), atol=2e-5)
    np.testing.assert_allclose(state["opt_state"].numpy(), expect["opt_state"].numpy(), atol=2e-5)
