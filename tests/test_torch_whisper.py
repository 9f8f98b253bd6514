"""The port's encoder-decoder (whisper-large-v3) against the JAX package,
on the CPU, from numpy inputs and JAX-initialised weights carried over
with ``from_jax_params``.

* The full config: the reference's fields and its parameter count,
  1,601,825,280 (32 decoder + 32 encoder layers at width 1280), with the
  same leaves (``frontend``, ``enc_layers``, ``enc_final_ln``, each
  decoder layer's ``lnx`` and ``xattn``).
* ``sinusoidal_positions`` within 1e-6; ``encode`` and
  ``cross_attn_forward`` within 1e-5 at the reduced 64 frames and at
  whisper's 1500, which is a multiple of neither 128 nor the 1024-key
  chunk (the last chunk is 476 keys long).
* Reduced whisper (2 + 2 layers, 64 frames of seeded features):
  ``forward``, ``loss_fn`` and every gradient (the encoder's included)
  within 1e-5; ``prefill``'s logits and every cache key (``kv``, ``xk``,
  ``xv``) and each ``decode_step`` within 1e-5 of the JAX package's own;
  the reference's encoder-decoder consistency test mirrored (prefill 8,
  decode to 12, 5e-3 against the full forward) and its
  ``init_cache`` + ``prefill_cross_cache`` decode; a prefill with
  ``use_flash_kernel`` within 2e-5 of the JAX prefill through the Pallas
  kernel in interpret mode (the kernels' float32 tolerance) and 2e-3 of
  the port's plain prefill, launching no kernel on the CPU.
* ``local_sgd_steps`` on a batch that carries ``enc_frames``: the loss
  falls, as in the reference's zoo test; a call without ``enc_frames``
  raises ``ValueError``; ``train`` refuses whisper; ``serve`` and its CLI
  run in-process."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.dpasgd import local_sgd_steps, make_loss_fn  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

ARCH = "whisper-large-v3"
P_FULL = 1_601_825_280
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab_size", "padded_vocab_size", "block_pattern", "sliding_window",
          "vision_prefix_len", "mlp_variant", "tie_embeddings", "rope_theta", "norm_eps",
          "use_flash_kernel", "is_encdec")


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
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(7), JT.model_specs(cfg_j)))
    return cfg_j, cfg_t, params_np, from_jax_params(params_np, device="cpu")


def _frames(seed, B, T, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, T, 128)) * scale).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=msg)


def _plain(cfg):
    return dataclasses.replace(cfg, remat=False)


def test_full_config_dimensions_and_parameter_count():
    cfg_t, cfg_j = get_config(ARCH), j_get_config(ARCH)
    for f in FIELDS:
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    for f in ("n_layers", "seq_len"):
        assert getattr(cfg_t.encoder, f) == getattr(cfg_j.encoder, f), f
    assert cfg_j.encoder.is_causal is False  # the port's encoder is always bidirectional
    assert cfg_t.encoder.n_layers == 32 and cfg_t.encoder.seq_len == 1500
    assert cfg_t.padded_vocab_size == 51968
    ref = {p: tuple(s.shape) for p, s in tree_leaves_with_path(JT.model_specs(cfg_j))}
    got = {p: s.shape for p, s in tree_leaves_with_path(model_specs(cfg_t))}
    assert got == ref
    assert [p for p, _ in tree_leaves_with_path(model_specs(cfg_t))] == list(ref)
    assert ParamLayout(model_specs(cfg_t)).size == P_FULL == j_count_params(JT.model_specs(cfg_j))
    assert set(model_specs(cfg_t)["layers"][0]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    small = get_config(ARCH).reduced()
    assert (small.encoder.n_layers, small.encoder.seq_len) == (2, 64)
    ref_small = cfg_j.reduced().encoder
    assert (small.encoder.n_layers, small.encoder.seq_len) == (ref_small.n_layers,
                                                                ref_small.seq_len)
    assert get_config(ARCH, n_layers=4).block_pattern == ("attn",) * 4


@pytest.mark.parametrize("T,D", [(64, 256), (1500, 1280), (7, 10)])
def test_sinusoidal_positions_match_jax(T, D):
    got = TL.sinusoidal_positions(T, D)
    assert got.shape == (T, D) and got.dtype == torch.float32
    _close(got, JL.sinusoidal_positions(T, D), 1e-6)


@pytest.mark.parametrize("T", [64, 1500])
def test_encode_and_cross_attention_match_jax(model, T):
    """At T = 1500 the keys run in a 1024 chunk and a 476 one."""
    cfg_j, cfg_t, params_np, params = model
    frames = _frames(T, 2, T)
    ref = jax.jit(lambda p, f: JT.encode(p, cfg_j, f))(params_np, jnp.asarray(frames))
    with torch.no_grad():
        enc = TT.encode(params, _plain(cfg_t), torch.from_numpy(frames))
    assert enc.shape == (2, T, cfg_t.d_model)
    _close(enc, ref, 1e-5, "encode")
    x = np.random.default_rng(1).standard_normal((2, 24, cfg_t.d_model)).astype(np.float32)
    p_np = params_np["layers"][1]["xattn"]
    ref_x = JA.cross_attn_forward(p_np, cfg_j, jnp.asarray(x), ref)
    with torch.no_grad():
        got, (xk, xv) = TA.cross_attn_forward(params["layers"][1]["xattn"], cfg_t,
                                              torch.from_numpy(x), enc, return_kv=True)
    _close(got, ref_x, 1e-5, "cross_attn_forward")
    assert xk.shape == xv.shape == (2, T, cfg_t.n_heads, cfg_t.head_dim)


def test_forward_loss_and_gradients_match_jax(model):
    cfg_j, cfg_t, params_np, _ = model
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
    frames = _frames(3, 2, 64)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
               "enc_frames": jnp.asarray(frames)}
    logits_j, _ = jax.jit(lambda p: JT.forward(p, cfg_j, batch_j["tokens"],
                                               enc_frames=batch_j["enc_frames"]))(params_np)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, cfg_j, batch_j)))(
        params_np)
    p = from_jax_params(params_np, device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_leaves_with_path(p)]
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "enc_frames": torch.from_numpy(frames)}
    logits = TT.forward(p, _plain(cfg_t), batch["tokens"], enc_frames=batch["enc_frames"])
    assert logits.shape == (2, 16, cfg_t.vocab_size)
    _close(logits, logits_j, 1e-5, "logits")
    loss = TT.loss_fn(p, cfg_t, batch)  # remat on: checkpointed decoder and encoder blocks
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    loss.backward()
    ref = dict(tree_leaves_with_path(jax.device_get(grads_j)))
    for (path, _), leaf in zip(tree_leaves_with_path(p), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), ref[path], atol=1e-5, err_msg=str(path))
    for key in ("frontend", "enc_final_ln"):
        assert float(p[key].grad.abs().max()) > 0, key


def test_prefill_caches_and_decode_match_jax(model):
    """The JAX package's own ``prefill`` and ``decode_step``: logits, the
    self-attention cache and the cross K/V of every layer."""
    cfg_j, cfg_t, params_np, params = model
    B, S, n = 2, 20, 12
    tokens = _tokens(5, B, S, cfg_t.vocab_size)
    frames = _frames(6, B, 64)
    ref_logits, jcache = jax.jit(lambda p, t, f: JT.prefill(
        p, cfg_j, t, S, cache_dtype=jnp.float32, enc_frames=f))(
        params_np, jnp.asarray(tokens[:, :n]), jnp.asarray(frames))
    with torch.no_grad():
        logits, cache = TT.prefill(params, cfg_t, torch.from_numpy(tokens[:, :n]).long(), S,
                                   cache_dtype=torch.float32,
                                   enc_frames=torch.from_numpy(frames))
    _close(logits, ref_logits, 1e-5, "prefill")
    assert len(cache) == len(jcache) == cfg_t.n_layers
    for layer, (c, r) in enumerate(zip(cache, jcache)):
        assert c.keys() == r.keys() == {"kv", "xk", "xv"}
        assert c["kv"]["pos"].tolist() == np.asarray(r["kv"]["pos"]).tolist()
        assert c["kv"]["pos"].tolist() == list(range(n)) + [-1] * (S - n)
        for key in ("k", "v"):
            _close(c["kv"][key], r["kv"][key], 1e-5, f"layer {layer} kv {key}")
        for key in ("xk", "xv"):
            assert c[key].shape == (B, 64, cfg_t.n_heads, cfg_t.head_dim)
            _close(c[key], r[key], 1e-5, f"layer {layer} {key}")
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(p, cfg_j, tok, c, pos))
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        _close(logits, jlogits, 1e-5, f"decode at {pos}")
    for c, r in zip(cache, jcache):
        _close(c["kv"]["k"], r["kv"]["k"], 1e-5)


def test_whisper_encdec_decode_consistency(model):
    """tests/test_serving_consistency.py's encoder-decoder test on the
    port: prefill 8 tokens, decode to 12, the last logits within 5e-3 of
    the full forward."""
    _, cfg_t, _, params = model
    B, S = 2, 12
    frames = torch.from_numpy(_frames(3, B, cfg_t.encoder.seq_len, scale=0.1))
    tokens = torch.from_numpy(_tokens(3, B, S, cfg_t.vocab_size)).long()
    with torch.no_grad():
        full = TT.forward(params, _plain(cfg_t), tokens, enc_frames=frames)
        _, cache = TT.prefill(params, cfg_t, tokens[:, :8], 32, cache_dtype=torch.float32,
                              enc_frames=frames)
        for pos in range(8, S):
            logits, cache = TT.decode_step(params, cfg_t, tokens[:, pos], cache, pos)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=5e-3, rtol=5e-3)


def test_decode_from_init_cache_and_cross_cache_matches_jax(model):
    """tests/test_archs_smoke.py's ``test_reduced_decode_step`` on both
    packages: ``init_cache`` leaves the cross K/V empty,
    ``prefill_cross_cache`` fills them from ``encode`` of ones, and three
    greedy decode steps from token 0 agree within 1e-5."""
    cfg_j, cfg_t, params_np, params = model
    B = 2
    frames = np.ones((B, cfg_t.encoder.seq_len, 128), np.float32)
    jcache = JT.init_cache(cfg_j, B, 64, jnp.float32)
    cache = TT.init_cache(cfg_t, B, 64, torch.float32, device="cpu")
    assert [set(c) for c in cache] == [set(c) for c in jcache]
    assert all(c["xk"] is None and c["xv"] is None for c in cache)
    jenc = jax.jit(lambda p, f: JT.encode(p, cfg_j, f))(params_np, jnp.asarray(frames))
    cross = jax.jit(lambda p, e: JT.prefill_cross_cache(p, cfg_j, e))(params_np, jenc)
    for i, (xk, xv) in enumerate(cross):
        jcache[i]["xk"], jcache[i]["xv"] = xk, xv
    with torch.no_grad():
        enc = TT.encode(params, cfg_t, torch.from_numpy(frames))
        for i, (xk, xv) in enumerate(TT.prefill_cross_cache(params, cfg_t, enc)):
            cache[i]["xk"], cache[i]["xv"] = xk, xv
            _close(xk, jcache[i]["xk"], 1e-5)
    jtok = jnp.zeros((B,), jnp.int32)
    tok = torch.zeros((B,), dtype=torch.long)
    decode = jax.jit(lambda p, t, c, pos: JT.decode_step(p, cfg_j, t, c, pos))
    for pos in range(3):
        jlogits, jcache = decode(params_np, jtok, jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, tok, cache, pos)
        assert logits.shape == (B, cfg_t.vocab_size) and bool(torch.isfinite(logits).all())
        _close(logits, jlogits, 1e-5, f"step {pos}")
        jtok = jlogits.argmax(-1).astype(jnp.int32)
        tok = logits.argmax(-1)
        assert tok.tolist() == np.asarray(jtok).tolist()


def test_flash_kernel_prefill_matches_jax_pallas_interpret_and_plain(model):
    """``use_flash_kernel=True`` at S = 128: the port's CPU wrapper (plain
    version) in the decoder's self-attention against the Pallas kernel in
    interpret mode (2e-5), and against the port's prefill without the
    flag (2e-3); the encoder and cross-attention stay on the chunked path
    in both."""
    cfg_j, cfg_t, params_np, params = model
    cfg_jf = dataclasses.replace(cfg_j, use_flash_kernel=True)
    cfg_tf = dataclasses.replace(cfg_t, use_flash_kernel=True)
    tokens = _tokens(8, 1, 128, cfg_t.vocab_size)
    frames = _frames(9, 1, 64)
    ref_logits, ref_cache = jax.jit(lambda p, t, f: JT.prefill(
        p, cfg_jf, t, 160, cache_dtype=jnp.float32, enc_frames=f))(
        params_np, jnp.asarray(tokens), jnp.asarray(frames))
    before = dict(LAUNCHES)
    with torch.no_grad():
        logits, cache = TT.prefill(params, cfg_tf, torch.from_numpy(tokens).long(), 160,
                                   cache_dtype=torch.float32,
                                   enc_frames=torch.from_numpy(frames))
        plain, _ = TT.prefill(params, cfg_t, torch.from_numpy(tokens).long(), 160,
                              cache_dtype=torch.float32, enc_frames=torch.from_numpy(frames))
    assert dict(LAUNCHES) == before  # CPU tensors: the plain version
    _close(logits, ref_logits, 2e-5, "kernel prefill vs Pallas interpret")
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=2e-3, rtol=2e-3)
    for c, r in zip(cache, ref_cache):
        for key in ("xk", "xv"):
            _close(c[key], r[key], 1e-5)
        _close(c["kv"]["k"], r["kv"]["k"], 1e-5)


def test_local_sgd_steps_on_a_whisper_batch_lowers_the_loss(model):
    """tests/test_archs_smoke.py's ``test_reduced_train_step_decreases_loss``
    for whisper on the port: sgd(0.1), one silo, a batch that carries
    ``enc_frames`` of ones, five calls of one local step."""
    _, cfg_t, params_np, _ = model
    layout = ParamLayout(model_specs(cfg_t))
    params = layout.flatten_into(params_np, torch.empty(layout.size))
    opt = sgd(0.1)
    tokens = torch.from_numpy(_tokens(1, 2, 16, cfg_t.vocab_size)).long()[None]
    batch = {"tokens": tokens, "labels": tokens,
             "enc_frames": torch.ones((1, 2, cfg_t.encoder.seq_len, 128))}
    loss_fn = make_loss_fn(cfg_t)
    with torch.no_grad():
        l0 = float(loss_fn(layout.views(params), {k: v[0] for k, v in batch.items()}))
    for _ in range(5):
        l2 = float(local_sgd_steps(loss_fn, opt, params, None, batch, layout=layout))
    assert np.isfinite(l2) and l2 < l0


def test_missing_enc_frames_raise_and_train_refuses(model):
    _, cfg_t, _, params = model
    tokens = torch.from_numpy(_tokens(1, 1, 8, cfg_t.vocab_size)).long()
    with pytest.raises(ValueError, match="enc_frames"):
        TT.forward(params, cfg_t, tokens)
    with pytest.raises(ValueError, match="enc_frames"):
        TT.prefill(params, cfg_t, tokens, 32)
    with pytest.raises(ValueError, match="enc_frames"):
        TT.loss_fn(params, cfg_t, {"tokens": tokens, "labels": tokens})
    with pytest.raises(ValueError, match="encoder-decoder"):
        train(cfg_t, silos=2, steps=1, device="cpu", log=lambda line: None)


def test_serve_draws_frames_and_decodes(model):
    """``serve`` draws seeded frames after the prompts, caches the cross
    K/V and decodes greedily, equal to a teacher-forced forward (5e-3);
    the multiple-of-128 check of the kernel looks at the prompt only."""
    _, cfg_t, _, params = model
    res = serve_mod.serve(cfg_t, batch=2, prompt_len=12, gen=5, seed=3, device="cpu",
                          params=params, log=lambda line: None)
    assert res.enc_frames.shape == (2, 64, 128) and res.vision_embeds is None
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg_t.vocab_size, (2, 12))
    np.testing.assert_array_equal(res.prompts.numpy(), prompts)
    np.testing.assert_array_equal(res.enc_frames.numpy(),
                                  rng.standard_normal((2, 64, 128)).astype(np.float32))
    assert torch.equal(res.ids[:, 0], res.prefill_logits.argmax(-1))
    seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
    with torch.no_grad():
        full = TT.forward(params, _plain(cfg_t), seq, enc_frames=res.enc_frames)
    np.testing.assert_allclose(res.logits.numpy(), full[:, -1].numpy(), atol=5e-3, rtol=5e-3)
    flash = dataclasses.replace(cfg_t, use_flash_kernel=True)
    ok = serve_mod.serve(flash, batch=1, prompt_len=128, gen=2, device="cpu", params=params,
                         log=lambda line: None)
    assert ok.launches["prefill"]["flash_attention"] == 0  # the CPU's plain version
    with pytest.raises(ValueError, match="multiple of 128"):
        serve_mod.serve(flash, batch=1, prompt_len=64, gen=2, device="cpu", params=params,
                        log=lambda line: None)


def test_serve_cli_runs_in_process(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--gen", "3"]
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "prefill[2x32 + 64 frames]" in out and "tok/s on cpu" in out
    assert "generated ids[0]:" in out
