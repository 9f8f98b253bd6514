"""The port's ``flash_attention_vjp`` (a ``torch.autograd.Function``)
against the JAX package's custom-VJP function, on the CPU, from the same
numpy inputs.

* Forward within 2e-5 and ``dq``, ``dk``, ``dv`` within 2e-4 (atol and
  rtol: the reference's own tolerances, tests/test_perf_features.py) of
  ``jax.grad`` through the reference's ``flash_attention_vjp``: causal
  with window None and 48, ``causal=False``, G in {1, 2, 8}, and key
  lengths that leave a padded last block (T = 100 over 64-key blocks,
  T = 1500 over 1024-key blocks as whisper's encoder has) or none.
* A float64 ``torch.autograd.gradcheck`` on a tiny shape.
* The reference's tests mirrored: forward within 2e-5 of the chunked path,
  gradients within 2e-4 of autograd through it.
* Under ``torch.utils.checkpoint(use_reentrant=False)`` (``cfg.remat``)
  the gradients equal those without it.
* ``attn_forward`` takes it under ``flash_vjp`` in the reference's order:
  the kernel switch first, then the banded path, then ``flash_vjp``, and
  it reaches bidirectional attention too."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.models.attention import flash_attention_vjp as j_flash_vjp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.attention import chunked_attention, flash_attention_vjp  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B, S, T, K, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)  # the loss's cotangent
    # the queries are the last S of the T positions, as in a causal layer
    return q, k, v, w, np.arange(T - S, T, dtype=np.int32), np.arange(T, dtype=np.int32)


CASES = {  # B, S, T, K, G, hd, causal, window, kv_block
    "causal": (2, 128, 128, 2, 2, 32, True, None, 64),
    "window48": (2, 128, 128, 2, 2, 32, True, 48, 64),
    "bidirectional_padded": (1, 96, 100, 2, 8, 16, False, None, 64),
    "mha_padded_window": (2, 80, 100, 4, 1, 16, True, 48, 64),
    "g8_causal_padded": (1, 100, 100, 1, 8, 16, True, None, 32),
    "encoder_1500_frames": (1, 1500, 1500, 1, 2, 8, False, None, 1024),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_grads_match_reference(case):
    B, S, T, K, G, hd, causal, window, kb = CASES[case]
    q, k, v, w, qp, kp = _inputs(sum(map(ord, case)), B, S, T, K, G, hd)

    def j_loss(q, k, v):
        out = j_flash_vjp(q, k, v, jnp.asarray(qp), jnp.asarray(kp), causal, window, kb)
        return (out * w).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention_vjp(tq, tk, tv, torch.from_numpy(qp).long(),
                              torch.from_numpy(kp).long(), causal, window, kb)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5, rtol=2e-5)
    for t, ref in zip((tq, tk, tv), j_grads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, None)])
def test_gradcheck_float64(causal, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((1, 6, 2, 2, 4), (1, 10, 2, 4), (1, 10, 2, 4)))
    qp, kp = torch.arange(4, 10), torch.arange(10)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention_vjp(q, k, v, qp, kp, causal, window, 4), (q, k, v))


@pytest.mark.parametrize("window", [None, 48])
def test_forward_matches_chunked(window):
    q, k, v, _, qp, kp = _inputs(0, 2, 128, 128, 2, 2, 32)
    q, k, v = map(torch.from_numpy, (q, k, v))
    pos = torch.from_numpy(qp).long()
    a = flash_attention_vjp(q, k, v, pos, pos, True, window, 64)
    b = chunked_attention(q, k, v, pos, pos, causal=True, window=window, kv_block=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("window", [None, 48])
def test_grads_match_autodiff_through_chunked(window):
    q, k, v, _, qp, _ = _inputs(1, 2, 128, 128, 2, 2, 32)
    pos = torch.from_numpy(qp).long()
    grads = []
    for f in (lambda q, k, v: chunked_attention(q, k, v, pos, pos, causal=True, window=window,
                                                kv_block=64),
              lambda q, k, v: flash_attention_vjp(q, k, v, pos, pos, True, window, 64)):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (f(*ts) ** 2).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4, rtol=2e-4)


def test_grads_under_non_reentrant_checkpoint_equal_plain():
    q, k, v, w, qp, kp = _inputs(2, 1, 64, 64, 2, 2, 16)
    pos = torch.from_numpy(qp).long()

    def f(q, k, v):
        return flash_attention_vjp(q, k, v, pos, pos, True, None, 16)

    grads = []
    for wrap in (lambda *a: f(*a), lambda *a: checkpoint(f, *a, use_reentrant=False)):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (wrap(*ts) * torch.from_numpy(w)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_attn_forward_dispatch_order(monkeypatch):
    """``flash_vjp`` sends causal and bidirectional attention through
    ``flash_attention_vjp`` at 1024-key blocks; ``banded_swa`` (with a
    window under half the sequence) and the kernel switch come first."""
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), flash_vjp=True)
    calls = []
    monkeypatch.setattr(TA, "flash_attention_vjp",
                        lambda *a: calls.append(("vjp", a[5], a[6], a[7])) or chunked_attention(
                            *a[:5], causal=a[5], window=a[6]))
    monkeypatch.setattr(TA, "banded_swa_attention",
                        lambda q, *a, **kw: calls.append(("banded",)) or torch.zeros_like(q))
    monkeypatch.setattr(TA.kops, "flash_attention",
                        lambda q, *a, **kw: calls.append(("kernel",)) or torch.zeros_like(q))
    from repro_torch.models import init_params, model_specs
    p = init_params(model_specs(cfg), device="cpu")["layers"][0]["attn"]
    x = torch.randn(1, 80, cfg.d_model)
    pos = torch.arange(80)
    TA.attn_forward(p, cfg, x, pos, causal=True, window=32)
    TA.attn_forward(p, cfg, x, pos, causal=False)
    TA.attn_forward(p, dataclasses.replace(cfg, banded_swa=True), x, pos, causal=True, window=32)
    TA.attn_forward(p, dataclasses.replace(cfg, use_flash_kernel=True), x, pos, causal=True)
    TA.attn_forward(p, dataclasses.replace(cfg, use_flash_kernel=True), x, pos, causal=False)
    assert calls == [("vjp", True, 32, 1024), ("vjp", False, None, 1024), ("banded",),
                     ("kernel",), ("vjp", False, None, 1024)]
