"""The port's vision-prefix backbone (internvl2-76b) and banded
sliding-window attention against the JAX package, on the CPU, from numpy
inputs and JAX-initialised weights carried over with ``from_jax_params``.

* The full configs of hymba-1.5b and internvl2-76b: the reference's
  dimensions and parameter counts (1,403,752,000 and 70,562,095,104).
* Reduced internvl2 (2 layers, an 8-patch prefix of seeded embeddings):
  forward, loss and gradients (``vision_proj`` included) within 1e-5 (the
  same ops); prefill and its caches within 1e-5 and ``decode_step``
  within 1e-5 of the JAX package's own ``prefill`` and ``decode_step``
  (its smoke test skips VLM decode) and 5e-3 of the full forward (the
  reference's serving tolerance); the serve entry point.
* A VLM call without embeddings raises ``ValueError``, and ``train``
  refuses a config with a vision prefix.
* ``banded_swa_attention`` against naive attention (3e-5, the
  reference's tolerance, tests/test_perf_features.py) and against the
  JAX package's banded path (1e-5), and a whole model with
  ``banded_swa=True`` against one without (2e-3, the reference's)."""

import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402

ARCH = "internvl2-76b"
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab_size", "padded_vocab_size", "block_pattern", "sliding_window",
          "global_attn_every", "vision_prefix_len", "banded_swa", "mlp_variant",
          "tie_embeddings", "rope_theta", "norm_eps", "use_flash_kernel")


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
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(6), JT.model_specs(cfg_j)))
    return cfg_j, cfg_t, params_np, from_jax_params(params_np, device="cpu")


def _embeds(seed, B, P):
    return np.random.default_rng(seed).standard_normal((B, P, 1024)).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("arch,P", [("hymba-1.5b", 1_403_752_000),
                                    ("internvl2-76b", 70_562_095_104)])
def test_full_config_dimensions_and_parameter_count(arch, P):
    cfg_t, cfg_j = get_config(arch), j_get_config(arch)
    for f in FIELDS:
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert (cfg_t.ssm is None) == (cfg_j.ssm is None)
    if cfg_j.ssm is not None:
        assert dataclasses.asdict(cfg_t.ssm) == dataclasses.asdict(cfg_j.ssm)
    ref = {p: tuple(s.shape) for p, s in tree_leaves_with_path(JT.model_specs(cfg_j))}
    got = {p: s.shape for p, s in tree_leaves_with_path(model_specs(cfg_t))}
    assert got == ref
    assert ParamLayout(model_specs(cfg_t)).size == P == sum(int(np.prod(s)) for s in ref.values())
    cut = get_config(arch, n_layers=4)
    assert cut.block_pattern == cfg_j.block_pattern[:4]


def test_forward_loss_and_gradients_match_jax(model):
    cfg_j, cfg_t, params_np, _ = model
    assert cfg_t.vision_prefix_len == 8 and "vision_proj" in params_np
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
    embeds = _embeds(3, 2, 8)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
               "vision_embeds": jnp.asarray(embeds)}
    logits_j, _ = jax.jit(lambda p: JT.forward(p, cfg_j, batch_j["tokens"],
                                               vision_embeds=batch_j["vision_embeds"]))(params_np)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, cfg_j, batch_j)))(
        params_np)
    p = from_jax_params(params_np, device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_leaves_with_path(p)]
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "vision_embeds": torch.from_numpy(embeds)}
    logits = TT.forward(p, dataclasses.replace(cfg_t, remat=False), batch["tokens"],
                        vision_embeds=batch["vision_embeds"])
    assert logits.shape == (2, 24, cfg_t.vocab_size)
    _close(logits, logits_j, 1e-5, "logits")
    loss = TT.loss_fn(p, cfg_t, batch)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    loss.backward()
    ref = dict(tree_leaves_with_path(jax.device_get(grads_j)))
    for (path, _), leaf in zip(tree_leaves_with_path(p), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), ref[path], atol=1e-5, err_msg=str(path))
    assert float(p["vision_proj"].grad.abs().max()) > 0


def test_prefill_and_decode_match_jax_and_forward(model):
    """The JAX package's own ``prefill`` and ``decode_step``, called
    directly: the prefix takes positions 0..7, decode continues at 8 + n."""
    cfg_j, cfg_t, params_np, params = model
    B, S, n, P = 2, 20, 12, cfg_t.vision_prefix_len
    tokens = _tokens(5, B, S, cfg_t.vocab_size)
    embeds = _embeds(6, B, P)
    max_len = P + S
    ref_logits, jcache = jax.jit(lambda p, t, e: JT.prefill(
        p, cfg_j, t, max_len, cache_dtype=jnp.float32, vision_embeds=e))(
        params_np, jnp.asarray(tokens[:, :n]), jnp.asarray(embeds))
    with torch.no_grad():
        logits, cache = TT.prefill(params, cfg_t, torch.from_numpy(tokens[:, :n]).long(), max_len,
                                   cache_dtype=torch.float32,
                                   vision_embeds=torch.from_numpy(embeds))
        full = TT.forward(params, dataclasses.replace(cfg_t, remat=False),
                          torch.from_numpy(tokens).long(), vision_embeds=torch.from_numpy(embeds))
    _close(logits, ref_logits, 1e-5, "prefill")
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].numpy(), atol=2e-3, rtol=2e-3)
    for c, r in zip(cache, jcache):
        assert c["pos"].tolist() == np.asarray(r["pos"]).tolist()
        assert c["pos"].tolist()[:P + n] == list(range(P + n))
        _close(c["k"], r["k"], 1e-5)
        _close(c["v"], r["v"], 1e-5)
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(p, cfg_j, tok, c, pos))
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache,
                                 jnp.int32(P + pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, P + pos)
        _close(logits, jlogits, 1e-5, f"decode at {pos}")
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=5e-3, rtol=5e-3)


def test_missing_vision_embeds_raise(model):
    _, cfg_t, _, params = model
    tokens = torch.from_numpy(_tokens(1, 1, 8, cfg_t.vocab_size)).long()
    with pytest.raises(ValueError, match="vision_embeds"):
        TT.forward(params, cfg_t, tokens)
    with pytest.raises(ValueError, match="vision_embeds"):
        TT.prefill(params, cfg_t, tokens, 32)
    with pytest.raises(ValueError, match="vision_embeds"):
        TT.loss_fn(params, cfg_t, {"tokens": tokens, "labels": tokens})
    with pytest.raises(ValueError, match="vision_embeds"):
        train(cfg_t, silos=2, steps=1, device="cpu", log=lambda line: None)


def test_serve_decodes_after_the_prefix(model):
    """``serve`` draws seeded embeddings, starts decode at prefix + prompt,
    and generates greedily; a prefix plus prompt off a multiple of 128
    is refused under ``use_flash_kernel``."""
    _, cfg_t, _, params = model
    res = serve_mod.serve(cfg_t, batch=2, prompt_len=12, gen=5, seed=3, device="cpu",
                          params=params, log=lambda line: None)
    assert res.vision_embeds.shape == (2, 8, 1024)
    assert torch.equal(res.ids[:, 0], res.prefill_logits.argmax(-1))
    seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
    with torch.no_grad():
        full = TT.forward(params, dataclasses.replace(cfg_t, remat=False), seq,
                          vision_embeds=res.vision_embeds)
    np.testing.assert_allclose(res.logits.numpy(), full[:, -1].numpy(), atol=5e-3, rtol=5e-3)
    with pytest.raises(ValueError, match="multiple of 128"):
        serve_mod.serve(dataclasses.replace(cfg_t, use_flash_kernel=True), batch=1,
                        prompt_len=128, gen=2, device="cpu", params=params,
                        log=lambda line: None)


@pytest.mark.parametrize("argv", [
    ["--arch", "hymba-1.5b", "--reduced", "--device", "cpu", "--batch", "2", "--gen", "4"],
    ["--arch", "internvl2-76b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "120", "--gen", "3", "--flash-kernel"],
], ids=["hymba", "internvl2-flash"])
def test_serve_cli_runs_in_process(argv, capsys):
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "prefill[" in out and "tok/s on cpu" in out and "generated ids[0]:" in out


# ---------------------------------------------------------------------------
# banded sliding-window attention


def _qkv(seed, B, S, K, G, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd))]


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 6), st.sampled_from([64, 100, 256]), st.sampled_from([64, 128, 96]))
def test_banded_swa_matches_naive_and_jax(seed, window, q_block):
    """q_block 96 does not divide S = 512: the block shrinks to 64, as in
    the reference."""
    q, k, v = _qkv(seed, 1, 512, 2, 1, 32)
    pos = np.arange(512, dtype=np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    got = TA.banded_swa_attention(tq, tk, tv, tpos.long(), window=window, q_block=q_block)
    naive = TA.naive_attention(tq, tk, tv, tpos.long(), tpos.long(), causal=True, window=window)
    torch.testing.assert_close(got, naive, atol=3e-5, rtol=3e-5)
    ref = JA.banded_swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), window=window, q_block=q_block)
    _close(got, ref, 1e-5)
    assert TA.math_gcd_block(512, q_block) == JA.math_gcd_block(512, q_block)


def test_model_forward_same_with_banded_swa():
    """Reduced danube (32-token window) at 128 tokens: ``banded_swa``
    takes the banded path (S > 2 * window) and changes the logits by at
    most 2e-3; equal to the JAX package's banded forward within 1e-5."""
    cfg_j = dataclasses.replace(j_get_config("h2o-danube-1.8b").reduced(), banded_swa=True)
    cfg_t = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), banded_swa=True,
                                remat=False)
    assert cfg_t.sliding_window == 32
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(0), JT.model_specs(cfg_j)))
    params = from_jax_params(params_np, device="cpu")
    tokens = _tokens(1, 1, 128, cfg_t.vocab_size)
    calls = []
    orig = TA.banded_swa_attention
    TA.banded_swa_attention = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        with torch.no_grad():
            banded = TT.forward(params, cfg_t, torch.from_numpy(tokens).long())
    finally:
        TA.banded_swa_attention = orig
    assert len(calls) == cfg_t.n_layers
    with torch.no_grad():
        base = TT.forward(params, dataclasses.replace(cfg_t, banded_swa=False),
                          torch.from_numpy(tokens).long())
    torch.testing.assert_close(banded, base, atol=2e-3, rtol=2e-3)
    ref, _ = jax.jit(lambda p: JT.forward(p, cfg_j, jnp.asarray(tokens)))(params_np)
    _close(banded, ref, 1e-5)
