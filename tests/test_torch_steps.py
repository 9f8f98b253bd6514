"""The port's step functions (``repro_torch.launch.steps``) and the zoo's
training side, on the CPU, against the JAX package where it has the same
function.

* The ten archs, reduced: ``forward`` with ``flash_vjp`` within 2e-3 of
  the default path (the reference's
  ``test_model_forward_same_with_flash_vjp``); one ``build_train_step``
  round under AdamW with ``flash_vjp`` (``enc_frames`` and
  ``vision_embeds`` in the batch where the arch needs them) whose loss is
  finite and falls on the same batch (tests/test_archs_smoke.py); three
  ``build_decode_step`` calls from an empty cache, as the reference's
  ``test_reduced_decode_step``; and, for internlm2, internvl2 and whisper,
  ``build_prefill_step`` (1e-5) and two ``build_decode_step`` calls (1e-5
  on float32 caches) against the reference's step functions on the same
  weights; the reference's decode step refuses its own prefill step's
  bfloat16 cache beside float32 weights, the port's takes it.
* Two reduced internlm2-1.8b rounds (2 silos on a ring, AdamW,
  ``flash_vjp``) from the reference's state carried over by
  ``from_jax_params``: losses within 1e-5 of the reference's
  ``make_train_step``; params within 2·lr·steps, the bound that Adam's
  sign-like first steps allow (a gradient near 0 that differs in its last
  bits can flip a step of size lr), and the moments within 1e-5.
* The K3/K4 gradient fault: both wrappers raise under autograd on the
  CPU (the card's behaviour), pass under ``no_grad``; ``build_train_step``
  refuses ``use_flash_kernel``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.fed import init_state as j_init_state  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_for_n_silos  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step,
    build_prefill_step,
    build_train_step,
)
from repro_torch.launch.train import batch_to_device  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, init_params, model_specs  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, momentum  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _extras(cfg, B, seed=0):
    """The stub inputs an arch needs beside its tokens, seeded normal draws."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal((B, cfg.encoder.seq_len, 128)).astype(np.float32)
    if cfg.vision_prefix_len:
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_prefix_len, 1024)).astype(np.float32)
    return out


def _t(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_same_with_flash_vjp(arch):
    assert get_config(arch, flash_vjp=True).reduced().flash_vjp  # as the reference's reduced()
    assert j_get_config(arch, flash_vjp=True).reduced().flash_vjp
    cfg = get_config(arch).reduced()
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)))
    extras = _t(_extras(cfg, 2))
    with torch.no_grad():
        base = T.forward(params, cfg, tokens, **extras)
        new = T.forward(params, dataclasses.replace(cfg, flash_vjp=True), tokens, **extras)
    assert bool(torch.isfinite(new).all())
    np.testing.assert_allclose(new.numpy(), base.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_adamw_flash_vjp_lowers_loss(arch):
    """One round of two local AdamW steps (optimizer steps 0 and 1)
    through ``build_train_step``; the loss on the round's first batch
    falls."""
    cfg = dataclasses.replace(get_config(arch).reduced(), flash_vjp=True)
    opt = adamw(3e-3)
    state = init_state(cfg, opt, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 16)))
    batch = {"tokens": tokens, "labels": tokens}
    batch.update({k: torch.from_numpy(np.stack([v, v])) for k, v in _extras(cfg, 2).items()})
    first = {k: v[0] for k, v in batch.items()}
    layout = ParamLayout(model_specs(cfg))
    with torch.no_grad():
        l0 = float(T.loss_fn(layout.views(state["params"]), cfg, first))
    step = build_train_step(cfg, optimizer=opt, local_steps=2)
    state, metrics = step(state, batch)
    with torch.no_grad():
        l1 = float(T.loss_fn(layout.views(state["params"]), cfg, first))
    assert state["step"] == 2 and set(state["opt_state"]) == {"mu", "nu"}
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(l1)
    assert l1 < l0, f"{arch}: loss {l0} -> {l1}"


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if not get_config(a).vision_prefix_len])
def test_reduced_decode_step(arch):
    """The reference's ``test_reduced_decode_step`` through
    ``build_decode_step`` (the VLM decodes behind a prefill: see
    ``test_prefill_and_decode_steps_match_reference``)."""
    cfg = get_config(arch).reduced()
    params = init_params(model_specs(cfg), seed=2, device="cpu")
    B = 2
    cache = T.init_cache(cfg, B, 64, torch.float32, device="cpu")
    if cfg.is_encdec:
        enc = T.encode(params, cfg, torch.from_numpy(_extras(cfg, B)["enc_frames"]))
        for c, (xk, xv) in zip(cache, T.prefill_cross_cache(params, cfg, enc)):
            c["xk"], c["xv"] = xk, xv
    decode = build_decode_step(cfg)
    tok = torch.zeros(B, dtype=torch.long)
    for pos in range(3):
        logits, cache = decode(params, {"token": tok, "cache": cache, "position": torch.tensor(pos)})
        assert logits.shape == (B, cfg.vocab_size) and not logits.requires_grad
        assert bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-76b", "whisper-large-v3"])
def test_prefill_and_decode_steps_match_reference(arch):
    """The step functions on both sides from the same weights and inputs.  The
    prefill steps (bfloat16 caches, their default) give logits within
    1e-5.  The reference's decode step refuses its own prefill's bfloat16
    cache beside float32 weights (``dynamic_update_slice`` takes one
    dtype), where the port's casts each token's K/V to the cache's dtype;
    so the decode steps are held to each other on float32 caches: two
    greedy steps within 1e-5."""
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(4), JT.model_specs(cfg_j)))
    params = from_jax_params(params_np, device="cpu")
    B, S = 2, 16
    tokens = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    extras = _extras(cfg_t, B, seed=6)
    j_extras = {k: jnp.asarray(v) for k, v in extras.items()}
    max_len = cfg_t.vision_prefix_len + S + 4
    pos = cfg_t.vision_prefix_len + S
    j_logits, j_cache = jax.jit(JS.build_prefill_step(cfg_j, max_len))(
        params_np, {"tokens": jnp.asarray(tokens), **j_extras})
    logits, cache = build_prefill_step(cfg_t, max_len)(
        params, {"tokens": torch.from_numpy(tokens).long(), **_t(extras)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=1e-5)
    kv = cache[0]["kv"] if cfg_t.is_encdec else cache[0]
    assert kv["k"].dtype == torch.bfloat16 and not logits.requires_grad
    tok = logits.argmax(-1)
    j_decode, decode = JS.build_decode_step(cfg_j), build_decode_step(cfg_t)
    with pytest.raises(TypeError, match="same dtypes"):
        j_decode(params_np, {"token": jnp.asarray(tok.numpy(), jnp.int32), "cache": j_cache,
                             "position": jnp.int32(pos)})
    assert bool(torch.isfinite(decode(params, {"token": tok, "cache": cache,
                                               "position": pos})[0]).all())
    _, j_cache = JT.prefill(params_np, cfg_j, jnp.asarray(tokens), max_len,
                            cache_dtype=jnp.float32, **j_extras)
    with torch.no_grad():
        _, cache = T.prefill(params, cfg_t, torch.from_numpy(tokens).long(), max_len,
                             cache_dtype=torch.float32, **_t(extras))
    j_decode = jax.jit(j_decode)
    for i in range(2):
        j_logits, j_cache = j_decode(params_np, {"token": jnp.asarray(tok.numpy(), jnp.int32),
                                                 "cache": j_cache, "position": jnp.int32(pos + i)})
        logits, cache = decode(params, {"token": tok, "cache": cache, "position": pos + i})
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=1e-5)
        tok = logits.argmax(-1)


N_SILOS, ROUNDS, LR = 2, 2, 1e-4


def test_two_internlm2_rounds_match_reference():
    """Two rounds of the reduced internlm2-1.8b, 2 silos on a ring, AdamW
    at 1e-4 with ``flash_vjp``, s = 1: the reference through its
    ``build_train_step`` (einsum lowering, one device), the port through
    its own (``pallas``)."""
    cfg_j = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), n_silos=N_SILOS,
                                flash_vjp=True)
    cfg_t = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=N_SILOS,
                                flash_vjp=True)
    state_j = j_init_state(cfg_j, j_adamw(LR), jax.random.PRNGKey(0))
    state = from_jax_params(jax.device_get(state_j), device="cpu")
    assert set(state["opt_state"]) == {"mu", "nu"}
    step_j = jax.jit(JS.build_train_step(cfg_j, gossip_impl="einsum", silo_axis=None))
    step = build_train_step(cfg_t, gossip_impl="pallas")
    j_batcher = JBatcher(JStream(cfg_j.vocab_size, 32, n_silos=N_SILOS), 1, 2)
    batcher = FederatedBatcher(SyntheticLMStream(cfg_t.vocab_size, 32, n_silos=N_SILOS), 1, 2)
    for r in range(ROUNDS):
        raw = batcher.batch(r)
        state_j, metrics_j = step_j(state_j, {k: jnp.asarray(v) for k, v in j_batcher.batch(r).items()})
        state, metrics = step(state, batch_to_device(raw, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), float(metrics_j["loss"]), atol=1e-5)
    expect = from_jax_params(jax.device_get(state_j), device="cpu")
    assert state["step"] == expect["step"] == ROUNDS
    diff = float((state["params"] - expect["params"]).abs().max())
    assert diff <= 2 * LR * ROUNDS, diff
    for k in ("mu", "nu"):
        np.testing.assert_allclose(state["opt_state"][k].numpy(), expect["opt_state"][k].numpy(),
                                   atol=1e-5)


def test_build_train_step_defaults_to_adamw_on_a_ring():
    """No optimizer and no plan: the same bits as ``make_train_step`` with
    ``adamw(1e-4)`` and the ring plan; the step counter is required."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=3)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 1, 1, 8)))
    batch = {"tokens": tokens, "labels": tokens}
    explicit = make_train_step(cfg, DPASGDConfig(1, "einsum"), adamw(1e-4),
                               plan_for_n_silos("ring", 3))
    results = []
    for step in (build_train_step(cfg, gossip_impl="einsum"), explicit):
        state = init_state(cfg, adamw(1e-4), seed=0, device="cpu")
        state, metrics = step(state, batch)
        results.append((state, float(metrics["loss"])))
    (a, la), (b, lb) = results
    assert la == lb and a["step"] == b["step"] == 1 and np.isfinite(la)
    assert torch.equal(a["params"], b["params"])
    assert all(torch.equal(a["opt_state"][k], b["opt_state"][k]) for k in ("mu", "nu"))
    with pytest.raises(ValueError, match="step counter"):
        build_train_step(cfg, gossip_impl="einsum")({**a, "step": None}, batch)


def test_kernels_refuse_gradients_and_training_refuses_the_kernel_switch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 2, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 32)).astype(np.float32))
            for _ in range(2))
    gates = [torch.from_numpy(rng.standard_normal((1, 128, 2)).astype(np.float32))
             for _ in range(2)]
    qs = q[:, :, :, 0]
    for name, call, args in (("flash_attention", kops.flash_attention, (q, k, v)),
                             ("mlstm_scan", kops.mlstm_scan, (qs, k, v, *gates))):
        for i in range(len(args)):
            grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
            with pytest.raises(RuntimeError, match=f"{name} has no backward"):
                call(*grad_args)
            with torch.no_grad():
                assert call(*grad_args).shape == args[0].shape
        assert not call(*args).requires_grad  # no input requires grad
    # a training step through the switch reaches the wrappers with grad on
    cfg = get_config("xlstm-350m").reduced()
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    for _, leaf in tree_leaves_with_path(params):
        leaf.requires_grad_()
    with pytest.raises(RuntimeError, match="mlstm_scan has no backward"):
        T.forward(params, dataclasses.replace(cfg, use_flash_kernel=True),
                  torch.zeros((1, 128), dtype=torch.long))
    for arch in ("internlm2-1.8b", "xlstm-350m"):
        flash = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
        with pytest.raises(RuntimeError, match="no backward"):
            build_train_step(flash)
        with pytest.raises(RuntimeError, match="no backward"):
            build_train_step(flash, optimizer=momentum(0.1))
