"""The port's Hymba hybrid (parallel attention and Mamba heads) against the
JAX package, on the CPU, from numpy inputs and JAX-initialised weights
carried over with ``from_jax_params``, at the reduced hymba-1.5b (2
layers: layer 0 global, layer 1 under a 32-token window; d_model 256, 4
heads, Mamba width 256, state 16).

* The Mamba head: ``mamba_forward``'s output, final state and conv
  buffer, and ``mamba_decode``, within 1e-5 of the reference (the same
  ops; the chunked scan sums in another order than the reference's
  ``lax.scan``).
* The block: ``hymba_forward`` and ``hymba_decode`` within 1e-5.
* The whole model: forward, loss and gradients within 1e-5 (tighter than
  the 2e-3 the serving checks allow: the same ops); prefill and its
  caches within 1e-5; decode continuations within 1e-5 of the JAX decode
  and 5e-3 of the full forward (the reference's serving tolerance,
  tests/test_serving_consistency.py), also past twice the window (S = 72),
  where the ring buffer wraps, which the reference's tests never reach.
* The chunked scan against the per-token loop (its plain version) within
  1e-5, over chunk lengths and sequence lengths that are not multiples of
  the chunk, and under a strong decay (``a_log = 3``, large ``dt``)
  where the factored form ``exp(L_t) sum_j exp(-L_j) dBu_j`` overflows:
  the chunked scan stays finite and equal to the loop."""

import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402

ARCH = "hymba-1.5b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    cfg_j = j_get_config(ARCH).reduced()
    cfg_t = get_config(ARCH).reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(3), JT.model_specs(cfg_j)))
    return cfg_j, cfg_t, params_np, from_jax_params(params_np, device="cpu")


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=msg)


def _j_prefill(cfg, params, tokens, max_len):
    return jax.jit(lambda p, t: JT.prefill(p, cfg, t, max_len, cache_dtype=jnp.float32))(
        params, jnp.asarray(tokens))


def _t_prefill(cfg, params, tokens, max_len):
    with torch.no_grad():
        return TT.prefill(params, cfg, torch.from_numpy(tokens).long(), max_len,
                          cache_dtype=torch.float32)


def _assert_caches_equal(got, ref, atol):
    assert len(got) == len(ref)
    for layer, (c, r) in enumerate(zip(got, ref)):
        assert torch.equal(c["kv"]["pos"], torch.from_numpy(np.array(r["kv"]["pos"])).int())
        for key in ("k", "v"):
            _close(c["kv"][key], r["kv"][key], atol, f"layer {layer} {key}")
        for i, name in enumerate(("h", "conv buffer")):
            _close(c["ssm"][i], r["ssm"][i], atol, f"layer {layer} {name}")


def test_reduced_config_cache_and_specs_match(model):
    cfg_j, cfg_t, params_np, _ = model
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab_size", "block_pattern", "sliding_window",
              "global_attn_every", "vision_prefix_len", "banded_swa", "use_flash_kernel"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert dataclasses.asdict(cfg_t.ssm) == dataclasses.asdict(cfg_j.ssm)
    assert [cfg_t.layer_uses_window(i) for i in range(2)] == [False, True]
    ref = {p: tuple(np.shape(a)) for p, a in tree_leaves_with_path(params_np)}
    got = {p: s.shape for p, s in tree_leaves_with_path(TT.model_specs(cfg_t))}
    assert ref == got
    jc = JT.init_cache(cfg_j, 2, 48, jnp.float32)
    tc = TT.init_cache(cfg_t, 2, 48, torch.float32, device="cpu")
    for c, r in zip(tc, jc):
        assert {k: tuple(v.shape) for k, v in c["kv"].items()} == \
            {k: tuple(np.shape(v)) for k, v in r["kv"].items()}
        assert [tuple(t.shape) for t in c["ssm"]] == [tuple(np.shape(t)) for t in r["ssm"]]
        assert c["ssm"][0].dtype == torch.float32


@pytest.mark.parametrize("S", [2, 24, 70])
def test_mamba_forward_matches_jax(model, S):
    """Output, final SSM state and conv buffer (zero-padded when S < 3);
    at S = 70 the chunked scan runs 8 chunks of 9 tokens, the last ragged."""
    cfg_j, cfg_t, params_np, params = model
    di = TH.hymba_d_inner(cfg_t)
    p_np, p = params_np["layers"][0]["hymba"]["mamba"], params["layers"][0]["hymba"]["mamba"]
    x = _x(S, 2, S, cfg_t.d_model)
    ref, (ref_h, ref_buf) = JS.mamba_forward(p_np, cfg_j, jnp.asarray(x), di, return_state=True)
    out, (h, buf) = TS.mamba_forward(p, cfg_t, torch.from_numpy(x), di, return_state=True)
    _close(out, ref, 1e-5, "output")
    _close(h, ref_h, 1e-5, "state")
    _close(buf, ref_buf, 1e-5, "conv buffer")
    assert h.dtype == torch.float32 and buf.shape == (2, 3, di)
    _close(TS.mamba_forward(p, cfg_t, torch.from_numpy(x), di), ref, 1e-5, "no state")


def test_mamba_decode_matches_jax(model):
    cfg_j, cfg_t, params_np, params = model
    di = TH.hymba_d_inner(cfg_t)
    p_np, p = params_np["layers"][1]["hymba"]["mamba"], params["layers"][1]["hymba"]["mamba"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg_t.d_model)).astype(np.float32)
    h = rng.standard_normal((2, di, 16)).astype(np.float32)
    buf = rng.standard_normal((2, 3, di)).astype(np.float32)
    ref, (ref_h, ref_buf) = JS.mamba_decode(p_np, cfg_j, jnp.asarray(x),
                                            (jnp.asarray(h), jnp.asarray(buf)), di)
    out, (got_h, got_buf) = TS.mamba_decode(p, cfg_t, torch.from_numpy(x),
                                            (torch.from_numpy(h), torch.from_numpy(buf)), di)
    _close(out, ref, 1e-5, "output")
    _close(got_h, ref_h, 1e-5, "state")
    _close(got_buf, ref_buf, 1e-5, "conv buffer")


@pytest.mark.parametrize("layer", [0, 1], ids=["global", "window"])
def test_hymba_block_forward_and_decode_match_jax(model, layer):
    cfg_j, cfg_t, params_np, params = model
    p_np, p = params_np["layers"][layer]["hymba"], params["layers"][layer]["hymba"]
    S = 40
    x = _x(layer, 2, S, cfg_t.d_model)
    pos = np.arange(S, dtype=np.int32)
    ref, ((rk, rv), (rh, rbuf)) = JH.hymba_forward(p_np, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                                                    layer, return_cache=True)
    out, ((k, v), (h, buf)) = TH.hymba_forward(p, cfg_t, torch.from_numpy(x),
                                               torch.from_numpy(pos).long(), layer,
                                               return_cache=True)
    for got, want, name in ((out, ref, "out"), (k, rk, "k"), (v, rv, "v"), (h, rh, "h"),
                            (buf, rbuf, "conv buffer")):
        _close(got, want, 1e-5, name)
    _close(TH.hymba_forward(p, cfg_t, torch.from_numpy(x), torch.from_numpy(pos).long(), layer),
           ref, 1e-5, "no cache")
    # one decode step from a cache of the first S tokens
    jc = JH.init_hymba_cache(cfg_j, 2, 64, layer, jnp.float32)
    jc = {"kv": JT.A.fill_kv_cache(cfg_j, jc["kv"], rk, rv, jnp.asarray(pos),
                                   cfg_j.sliding_window if layer else None),
          "ssm": (rh, rbuf)}
    tc = TH.init_hymba_cache(cfg_t, 2, 64, layer, torch.float32, device="cpu")
    TT.A.fill_kv_cache(tc["kv"], k, v, torch.from_numpy(pos).long())
    tc["ssm"] = (h, buf)
    xd = _x(7, 2, 1, cfg_t.d_model)
    ref, jc = JH.hymba_decode(p_np, cfg_j, jnp.asarray(xd), jc, jnp.int32(S), layer)
    with torch.no_grad():
        out, tc = TH.hymba_decode(p, cfg_t, torch.from_numpy(xd), tc, S, layer)
    _close(out, ref, 1e-5, "decode")
    _assert_caches_equal([tc], [jc], 1e-5)


def test_forward_loss_and_gradients_match_jax(model):
    cfg_j, cfg_t, params_np, params = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab_size, (2, 40)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits_j, _ = jax.jit(lambda p: JT.forward(p, cfg_j, batch_j["tokens"]))(params_np)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, cfg_j, batch_j)))(
        params_np)
    p = from_jax_params(params_np, device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_leaves_with_path(p)]
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    logits = TT.forward(p, dataclasses.replace(cfg_t, remat=False), batch["tokens"])
    _close(logits, logits_j, 1e-5, "logits")
    loss = TT.loss_fn(p, cfg_t, batch)  # remat: each block recomputed in backward
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    loss.backward()
    ref = dict(tree_leaves_with_path(jax.device_get(grads_j)))
    for (path, _), leaf in zip(tree_leaves_with_path(p), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), ref[path], atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("S", [24, 40])
def test_prefill_matches_jax(model, S):
    """Last-token logits and every layer's KV cache, SSM state and conv
    buffer; at S = 40 the windowed layer's 32 slots hold the last 32."""
    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(S, 2, S, cfg_t.vocab_size)
    ref_logits, ref_cache = _j_prefill(cfg_j, params_np, tokens, 64)
    logits, cache = _t_prefill(cfg_t, params, tokens, 64)
    _close(logits, ref_logits, 1e-5)
    _assert_caches_equal(cache, ref_cache, 1e-5)


@pytest.mark.parametrize("B,S,n", [(2, 20, 14), (1, 72, 8)], ids=["continue", "ring-wrap"])
def test_decode_continuation_matches_jax_and_forward(model, B, S, n):
    """Prefill n tokens, then decode to S: each step within 1e-5 of the JAX
    decode and 5e-3 of the full forward.  At S = 72, more than twice the
    32-token window, the windowed layer's ring buffer wraps twice."""
    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(S, B, S, cfg_t.vocab_size)
    _, jcache = _j_prefill(cfg_j, params_np, tokens[:, :n], S)
    _, cache = _t_prefill(cfg_t, params, tokens[:, :n], S)
    with torch.no_grad():
        full = TT.forward(params, dataclasses.replace(cfg_t, remat=False),
                          torch.from_numpy(tokens).long())
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(p, cfg_j, tok, c, pos))
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        _close(logits, jlogits, 1e-5, f"decode at {pos}")
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=5e-3, rtol=5e-3)
    _assert_caches_equal(cache, jcache, 1e-5)
    if S > 2 * cfg_t.sliding_window:
        assert sorted(cache[1]["kv"]["pos"].tolist()) == list(range(S - 32, S))


def test_flash_kernel_prefill_takes_the_plain_version_on_the_cpu(model):
    """``use_flash_kernel=True`` at S = 128: on CPU tensors the K3 wrapper
    takes its plain version (no launch), within 2e-5 of the JAX prefill
    on the chunked path (the kernels' float32 tolerance)."""
    from repro_torch.kernels import LAUNCHES

    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(5, 1, 128, cfg_t.vocab_size)
    ref_logits, ref_cache = _j_prefill(cfg_j, params_np, tokens, 160)
    before = LAUNCHES["flash_attention"]
    logits, cache = _t_prefill(dataclasses.replace(cfg_t, use_flash_kernel=True), params,
                               tokens, 160)
    assert LAUNCHES["flash_attention"] == before
    _close(logits, ref_logits, 2e-5)
    _assert_caches_equal(cache, ref_cache, 2e-5)


# ---------------------------------------------------------------------------
# the chunked scan against its plain version


def _scan_inputs(seed, B, S, Di, N, log_decay=(-3.0, 0.0)):
    rng = np.random.default_rng(seed)
    dA = np.exp(rng.uniform(*log_decay, (B, S, Di, N))).astype(np.float32)
    dBu = rng.standard_normal((B, S, Di, N)).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, Di, N)).astype(np.float32)
    return [torch.from_numpy(a) for a in (dA, dBu, C, h0)]


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 90), st.sampled_from([1, 3, 8, 16, 64]),
       st.booleans())
def test_chunked_scan_matches_loop(seed, S, chunk, with_h0):
    """Outputs and final state within 1e-5, for any S (a multiple of the
    chunk or not) and chunk length, from a zero or a given state."""
    dA, dBu, C, h0 = _scan_inputs(seed, 2, S, 5, 4)
    h0 = h0 if with_h0 else None
    y, h = TS.mamba_scan_chunked(dA, dBu, C, h0, chunk=chunk)
    y_ref, h_ref = TS.mamba_scan_loop(dA, dBu, C, h0)
    assert y.shape == (2, S, 5) and h.shape == (2, 5, 4)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-5)


def test_chunked_scan_stays_finite_under_strong_decay(model):
    """``a_log = 3`` (A = -e^3, about -20) and the dt projection scaled by
    40: half the channels decay by e^-20 or more a token (some to an exact
    0), so ``exp(-L_j)`` of the factored form passes float32's range
    within a few tokens; the chunked scan multiplies only factors in
    [0, 1], stays finite and equals the loop (1e-5)."""
    cfg_j, cfg_t, params_np, params = model
    di = TH.hymba_d_inner(cfg_t)
    p = dict(params["layers"][0]["hymba"]["mamba"])
    p["a_log"] = torch.full_like(p["a_log"], 3.0)
    p["w_dt2"] = p["w_dt2"] * 40.0
    x = torch.from_numpy(_x(11, 2, 96, cfg_t.d_model))
    u, z, C, dA, dBu = TS._mamba_scan_inputs(p, x, di, 16)
    log_dA = torch.log(dA.double())
    assert float((log_dA < -20).double().mean()) > 0.4
    factored = torch.exp(-torch.cumsum(log_dA, dim=1)).float()
    assert not bool(torch.isfinite(factored).all())
    y, h = TS.mamba_scan_chunked(dA, dBu, C)
    y_ref, h_ref = TS.mamba_scan_loop(dA, dBu, C)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-5)
    out = TS.mamba_forward(p, cfg_t, x, di)
    assert bool(torch.isfinite(out).all())


def test_chunked_scan_gradients_match_loop():
    """The backward of the chunked scan (training takes it) against the
    loop's, 1e-5."""
    dA, dBu, C, h0 = _scan_inputs(3, 2, 37, 3, 4)
    grads = []
    for scan in (lambda *a: TS.mamba_scan_chunked(*a, chunk=8), TS.mamba_scan_loop):
        inputs = [t.clone().requires_grad_() for t in (dA, dBu, C, h0)]
        y, h = scan(*inputs)
        ((y ** 2).sum() + (h * h0).sum()).backward()
        grads.append([t.grad for t in inputs])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
