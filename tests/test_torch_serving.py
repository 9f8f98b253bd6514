"""The port's serving path (prefill, decode, KV caches, the serve entry
point) against the JAX package, on JAX-initialised weights carried over
with ``from_jax_params``, for internlm2-1.8b (no window) and
h2o-danube-1.8b (sliding window, ring-buffer cache) reduced, and for the
reduced MoE (qwen3-moe-30b-a3b; deepseek-v2-lite-16b, whose MLA layers
cache their latents) and the last dense configs (granite-20b's MQA and
GELU MLP, mistral-large-123b); the reduced MoE configs are dropless, so
decode continues the prefill as the full forward does.

Tolerances: logits and float32 caches 1e-5 (as tests/test_torch_model.py:
float32 sums in another order); decode continuations 1e-5 against the JAX
decode and 5e-3 against the full forward (the reference's own serving
tolerance, tests/test_serving_consistency.py); the prefill through the
flash-attention kernel 2e-5 against the JAX prefill through the Pallas
kernel in interpret mode (the kernels' float32 tolerance)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["internlm2-1.8b", "h2o-danube-1.8b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
         "granite-20b", "mistral-large-123b"]
CFG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab_size", "block_pattern", "sliding_window",
              "global_attn_every", "use_flash_kernel", "rope_theta", "norm_eps")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j = j_get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(3), JT.model_specs(cfg_j)))
    return arch, cfg_j, cfg_t, params_np, from_jax_params(params_np, device="cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _j_prefill(cfg, params, tokens, max_len):
    return jax.jit(lambda p, t: JT.prefill(p, cfg, t, max_len, cache_dtype=jnp.float32))(
        params, jnp.asarray(tokens))


def _j_decode(cfg):
    return jax.jit(lambda p, tok, c, pos: JT.decode_step(p, cfg, tok, c, pos))


def _t_prefill(cfg, params, tokens, max_len):
    with torch.no_grad():
        return TT.prefill(params, cfg, torch.from_numpy(tokens).long(), max_len,
                          cache_dtype=torch.float32)


def _assert_caches_equal(got, ref, atol):
    assert len(got) == len(ref)
    for layer, (c, r) in enumerate(zip(got, ref)):
        assert torch.equal(c["pos"], torch.from_numpy(np.array(r["pos"])).int()), layer
        assert c.keys() == r.keys(), layer
        for key in sorted(set(c) - {"pos"}):  # k, v; or an MLA layer's c_kv, k_rope
            np.testing.assert_allclose(c[key].numpy(), np.asarray(r[key]), atol=atol,
                                       rtol=atol, err_msg=f"layer {layer} {key}")


def test_config_fields_and_cache_shapes_match(model):
    arch, cfg_j, cfg_t, _, _ = model
    for f in CFG_FIELDS:
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert [cfg_t.layer_uses_window(i) for i in range(cfg_t.n_layers)] == \
        [cfg_j.layer_uses_window(i) for i in range(cfg_j.n_layers)]
    for max_len in (20, 64):
        ref = JT.init_cache(cfg_j, 2, max_len, jnp.float32)
        got = TT.init_cache(cfg_t, 2, max_len, torch.float32, device="cpu")
        assert [{k: tuple(v.shape) for k, v in c.items()} for c in got] == \
            [{k: tuple(np.shape(v)) for k, v in c.items()} for c in ref]
        assert all(bool((c["pos"] == -1).all()) and c["pos"].dtype == torch.int32 for c in got)
    full_j = j_get_config(arch, use_flash_kernel=True)
    full_t = get_config(arch, use_flash_kernel=True)
    for f in CFG_FIELDS:
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert full_t.use_flash_kernel and not full_t.reduced().use_flash_kernel


@pytest.mark.parametrize("S", [24, 40])
def test_prefill_matches_jax(model, S):
    """Last-token logits and every layer's cache; at S=40 danube's
    32-slot ring buffer holds only the last 32 positions."""
    _, cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(S, 2, S, cfg_t.vocab_size)
    ref_logits, ref_cache = _j_prefill(cfg_j, params_np, tokens, 64)
    logits, cache = _t_prefill(cfg_t, params, tokens, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5, rtol=1e-5)
    _assert_caches_equal(cache, ref_cache, 1e-5)


def test_decode_continuation_matches_jax_and_forward(model):
    _, cfg_j, cfg_t, params_np, params = model
    B, S, n = 2, 20, 14
    tokens = _tokens(1, B, S, cfg_t.vocab_size)
    _, jcache = _j_prefill(cfg_j, params_np, tokens[:, :n], 64)
    _, cache = _t_prefill(cfg_t, params, tokens[:, :n], 64)
    full = TT.forward(params, dataclasses.replace(cfg_t, remat=False),
                      torch.from_numpy(tokens).long())
    decode = _j_decode(cfg_j)
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].detach().numpy(),
                                   atol=5e-3, rtol=5e-3)
    _assert_caches_equal(cache, jcache, 1e-5)


def test_sliding_window_ring_buffer_wraps_like_jax():
    """tests/test_serving_consistency.py's wrap case: decode far past the
    window; the ring buffer forgets old positions as the windowed full
    forward does, and equals the JAX decode step by step."""
    cfg_j = j_get_config("h2o-danube-1.8b").reduced()
    cfg_t = get_config("h2o-danube-1.8b").reduced()
    assert cfg_t.sliding_window == 32
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(2), JT.model_specs(cfg_j)))
    params = from_jax_params(params_np, device="cpu")
    B, S, n = 1, 72, 8
    tokens = _tokens(2, B, S, cfg_t.vocab_size)
    _, jcache = _j_prefill(cfg_j, params_np, tokens[:, :n], S)
    _, cache = _t_prefill(cfg_t, params, tokens[:, :n], S)
    decode = _j_decode(cfg_j)
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    _assert_caches_equal(cache, jcache, 1e-5)
    full = TT.forward(params, dataclasses.replace(cfg_t, remat=False),
                      torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.numpy(), full[:, -1].detach().numpy(), atol=5e-3, rtol=5e-3)


def test_decode_past_unwindowed_cache_clamps_like_jax():
    """Without a window the slot is the position itself; past the cache's
    end the reference's dynamic_update_slice clamps it to the last slot."""
    cfg_j = j_get_config("internlm2-1.8b").reduced()
    cfg_t = get_config("internlm2-1.8b").reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(4), JT.model_specs(cfg_j)))
    params = from_jax_params(params_np, device="cpu")
    tokens = _tokens(4, 2, 13, cfg_t.vocab_size)
    _, jcache = _j_prefill(cfg_j, params_np, tokens[:, :8], 10)
    _, cache = _t_prefill(cfg_t, params, tokens[:, :8], 10)
    decode = _j_decode(cfg_j)
    for pos in range(8, 13):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    assert cache[0]["pos"].tolist()[-1] == 12
    _assert_caches_equal(cache, jcache, 1e-5)


def test_flash_kernel_prefill_matches_jax_pallas_interpret(model):
    """``use_flash_kernel=True`` on both sides at S=128: the port's CPU
    wrapper (plain version) against the Pallas kernel in interpret mode."""
    _, cfg_j, cfg_t, params_np, params = model
    cfg_j = dataclasses.replace(cfg_j, use_flash_kernel=True)
    cfg_t = dataclasses.replace(cfg_t, use_flash_kernel=True)
    tokens = _tokens(5, 1, 128, cfg_t.vocab_size)
    ref_logits, ref_cache = _j_prefill(cfg_j, params_np, tokens, 160)
    before = LAUNCHES["flash_attention"]
    logits, cache = _t_prefill(cfg_t, params, tokens, 160)
    assert LAUNCHES["flash_attention"] == before  # CPU tensors: the plain version
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-5, rtol=2e-5)
    _assert_caches_equal(cache, ref_cache, 1e-5)


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--batch", "2", "--gen", "4"],
    ["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu", "--batch", "1",
     "--prompt-len", "128", "--gen", "3", "--flash-kernel"],
    ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "16", "--gen", "3"],
], ids=["internlm2", "danube-flash", "qwen3-moe"])
def test_serve_cli_runs_in_process(argv, capsys):
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "prefill[" in out and "tok/s on cpu" in out and "generated ids[0]:" in out


def test_serve_returns_ids_logits_and_launches():
    cfg = get_config("h2o-danube-1.8b").reduced()
    res = serve_mod.serve(cfg, batch=2, prompt_len=40, gen=5, seed=1, device="cpu",
                          log=lambda line: None)
    assert res.ids.shape == (2, 5) and res.logits.shape == (2, cfg.vocab_size)
    assert res.prompts.shape == (2, 40) and res.prefill_s > 0 and res.decode_tok_s > 0
    assert res.launches["prefill"]["flash_attention"] == 0
    assert res.launches["decode"] == {k: 0 for k in LAUNCHES}
    # greedy: every generated id is the argmax of the step before
    assert torch.equal(res.ids[:, 0], res.prefill_logits.argmax(-1))
    assert torch.equal(res.ids[:, -1], res.logits.argmax(-1))
    again = serve_mod.serve(cfg, batch=2, prompt_len=40, gen=5, seed=1, device="cpu",
                            log=lambda line: None)
    assert torch.equal(again.ids, res.ids) and torch.equal(again.prompts, res.prompts)
