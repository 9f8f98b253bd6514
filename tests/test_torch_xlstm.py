"""The port's xLSTM stack (mLSTM + sLSTM blocks) against the JAX package:
reduced xlstm-350m's config, forward, serving prefill (logits and every
layer's recurrent state), decode, the forward through the mLSTM kernel
switch, and the registry's depth cut.  JAX weights are carried over with
``from_jax_params``; token ids come from numpy seeds.

Tolerances: logits and the mLSTM's float32 state 1e-5 (float32 sums in
another order, as tests/test_torch_model.py); the sLSTM's (c, n, h, m)
2e-5 of each tensor's largest magnitude: c and n are unnormalised sums
over the sequence with exponential gates, so float32 rounding in another
order moves them in proportion to their scale (up to about 12 here), not
by a fixed amount; decode continuations 1e-5 against
the JAX decode and 5e-3 against the full forward (the reference's own
serving tolerance, tests/test_serving_consistency.py); the forward with
``use_flash_kernel`` 1e-4 against the JAX forward through the Pallas
kernel in interpret mode (the kernel tolerance of
tests/test_torch_mlstm_scan.py)."""

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
from repro_torch.models import from_jax_params, init_params, model_specs  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "xlstm-350m"
CFG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab_size", "block_pattern", "family", "ssm",
              "use_flash_kernel", "norm_eps")


@pytest.fixture(scope="module")
def model():
    cfg_j = j_get_config(ARCH).reduced()
    cfg_t = get_config(ARCH).reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(0), JT.model_specs(cfg_j)))
    return cfg_j, cfg_t, params_np, from_jax_params(params_np, device="cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _j_forward(cfg, params, tokens):
    return np.asarray(jax.jit(lambda p, t: JT.forward(p, cfg, t)[0])(params, jnp.asarray(tokens)))


def _t_forward(cfg, params, tokens):
    with torch.no_grad():
        return TT.forward(params, dataclasses.replace(cfg, remat=False),
                          torch.from_numpy(tokens).long())


def _j_prefill(cfg, params, tokens, max_len):
    return jax.jit(lambda p, t: JT.prefill(p, cfg, t, max_len, cache_dtype=jnp.float32))(
        params, jnp.asarray(tokens))


def _t_prefill(cfg, params, tokens, max_len):
    with torch.no_grad():
        return TT.prefill(params, cfg, torch.from_numpy(tokens).long(), max_len,
                          cache_dtype=torch.float32)


def _assert_states_equal(got, ref):
    """Each layer's state: the mLSTM's [B,H,hd,hd] matrix at 1e-5, or the
    sLSTM's (c, n, h, m) at 2e-5 of each tensor's scale (module docstring)."""
    assert len(got) == len(ref)
    for layer, (g, r) in enumerate(zip(got, ref)):
        if not isinstance(g, tuple):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                       err_msg=f"layer {layer} mLSTM state")
            continue
        assert len(g) == len(r) == 4, layer
        for name, a, b in zip("cnhm", g, r):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, atol=2e-5 * np.abs(b).max(), rtol=0,
                                       err_msg=f"layer {layer} sLSTM {name}")


def _field(cfg, name):
    value = getattr(cfg, name)
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value


def test_config_fields_and_cache_shapes_match(model):
    cfg_j, cfg_t, _, _ = model
    for f in CFG_FIELDS:
        assert _field(cfg_t, f) == _field(cfg_j, f), f
    assert cfg_t.block_pattern == ("mlstm", "slstm") and cfg_t.family == "ssm"
    assert cfg_t.ssm.expand == 2 and cfg_t.ssm.d_state == 16
    ref = JT.init_cache(cfg_j, 2, 64, jnp.float32)
    got = TT.init_cache(cfg_t, 2, 64, torch.float32, device="cpu")
    assert tuple(got[0].shape) == np.shape(ref[0]) == (2, 4, 128, 128)  # mLSTM hd 128
    assert [tuple(t.shape) for t in got[1]] == [np.shape(t) for t in ref[1]]
    assert all(t.dtype == torch.float32 and not bool(t.any()) for t in (got[0], *got[1]))
    full_j, full_t = j_get_config(ARCH), get_config(ARCH)
    for f in CFG_FIELDS:
        assert _field(full_t, f) == _field(full_j, f), f
    assert full_t.block_pattern.count("slstm") == 4
    assert [i for i, k in enumerate(full_t.block_pattern) if k == "slstm"] == [3, 9, 15, 21]


def test_params_carry_over_with_the_reference_tree(model):
    cfg_j, cfg_t, params_np, params = model
    specs = model_specs(cfg_t)
    assert params["layers"][1]["slstm"]["r"].shape == (4, 64, 256)  # [H, dh, 4 dh]
    assert params["layers"][0]["mlstm"]["b_if"].shape == (8,)
    np.testing.assert_array_equal(params["layers"][1]["slstm"]["r"].numpy(),
                                  np.asarray(params_np["layers"][1]["slstm"]["r"]))
    mine = init_params(specs, seed=0, device="cpu")
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_equal(tuple(a.shape), np.shape(b)),
                           mine, params_np)


@pytest.mark.parametrize("S", [24, 64])
def test_forward_matches_jax(model, S):
    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(S, 2, S, cfg_t.vocab_size)
    np.testing.assert_allclose(_t_forward(cfg_t, params, tokens).numpy(),
                               _j_forward(cfg_j, params_np, tokens), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [24, 64])
def test_prefill_matches_jax(model, S):
    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(100 + S, 2, S, cfg_t.vocab_size)
    ref_logits, ref_cache = _j_prefill(cfg_j, params_np, tokens, 96)
    logits, cache = _t_prefill(cfg_t, params, tokens, 96)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5, rtol=1e-5)
    _assert_states_equal(cache, ref_cache)


def test_decode_continuation_matches_jax_and_forward(model):
    cfg_j, cfg_t, params_np, params = model
    B, S, n = 2, 20, 14
    tokens = _tokens(1, B, S, cfg_t.vocab_size)
    _, jcache = _j_prefill(cfg_j, params_np, tokens[:, :n], 64)
    _, cache = _t_prefill(cfg_t, params, tokens[:, :n], 64)
    full = _t_forward(cfg_t, params, tokens)
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(p, cfg_j, tok, c, pos))
    for pos in range(n, S):
        jlogits, jcache = decode(params_np, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with torch.no_grad():
            logits, cache = TT.decode_step(params, cfg_t, torch.from_numpy(tokens[:, pos]).long(),
                                           cache, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=5e-3, rtol=5e-3)
    _assert_states_equal(cache, jcache)


def test_kernel_forward_matches_jax_pallas_and_reference_plain_path_is_nan(model):
    """``use_flash_kernel=True`` at S=128: the port's CPU wrapper (plain
    version) against the JAX forward through the Pallas kernel in
    interpret mode.  At this length, with ``init_params(PRNGKey(0))``'s
    weights, the reference's own plain forward and prefill are NaN (the
    chunked-path fault of tests/test_torch_mlstm_scan.py); the port's are
    finite and agree with the kernel-switch forward."""
    cfg_j, cfg_t, params_np, params = model
    tokens = _tokens(128, 2, 128, cfg_t.vocab_size)
    ref_kernel = _j_forward(dataclasses.replace(cfg_j, use_flash_kernel=True), params_np, tokens)
    before = dict(LAUNCHES)
    got = _t_forward(dataclasses.replace(cfg_t, use_flash_kernel=True), params, tokens)
    assert LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), ref_kernel, atol=1e-4, rtol=1e-4)
    assert np.isnan(_j_forward(cfg_j, params_np, tokens)).any()
    plain = _t_forward(cfg_t, params, tokens)
    assert bool(torch.isfinite(plain).all())
    np.testing.assert_allclose(plain.numpy(), got.numpy(), atol=1e-5, rtol=1e-5)
    assert np.isnan(np.asarray(_j_prefill(cfg_j, params_np, tokens, 160)[0])).any()
    logits, _ = _t_prefill(cfg_t, params, tokens, 160)
    np.testing.assert_allclose(logits.numpy(), got[:, -1].numpy(), atol=1e-5, rtol=1e-5)


def test_forward_through_kernel_switch_needs_whole_chunks(model):
    _, cfg_t, _, params = model
    tokens = _tokens(2, 1, 96, cfg_t.vocab_size)
    with pytest.raises(ValueError, match="multiple of chunk"):
        _t_forward(dataclasses.replace(cfg_t, use_flash_kernel=True), params, tokens)


def test_remat_forward_and_loss_backward_run(model):
    """The training path (``remat`` checkpoints, gradients through both
    recurrent blocks) runs and is finite; the forward equals the
    un-checkpointed one."""
    _, cfg_t, _, params = model
    tokens = torch.from_numpy(_tokens(9, 2, 16, cfg_t.vocab_size)).long()
    leaves = {id(t): t.detach().clone().requires_grad_(True)
              for t in jax.tree_util.tree_leaves(params)}
    p = jax.tree_util.tree_map(lambda t: leaves[id(t)], params)
    loss = TT.loss_fn(p, cfg_t, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves.values())
    with torch.no_grad():
        torch.testing.assert_close(TT.forward(params, cfg_t, tokens),
                                   _t_forward(cfg_t, params, tokens.numpy()))


def test_serve_runs_reduced_xlstm_on_cpu(capsys):
    cfg = get_config(ARCH).reduced()
    res = serve_mod.serve(cfg, batch=2, prompt_len=40, gen=5, seed=1, device="cpu",
                          log=lambda line: None)
    assert res.ids.shape == (2, 5) and res.logits.shape == (2, cfg.vocab_size)
    assert res.launches["prefill"] == res.launches["decode"] == {k: 0 for k in LAUNCHES}
    assert torch.equal(res.ids[:, 0], res.prefill_logits.argmax(-1))
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "1",
                           "--prompt-len", "128", "--gen", "3", "--flash-kernel"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_registry_depth_cut_keeps_published_pattern():
    cfg = get_config(ARCH, n_layers=6)
    assert cfg.block_pattern == ("mlstm", "mlstm", "mlstm", "slstm", "mlstm", "mlstm")
    assert get_config(ARCH, n_layers=3).block_pattern == ("mlstm",) * 3
    assert get_config("internlm2-1.8b", n_layers=4).block_pattern == ("attn",) * 4
    with pytest.raises(ValueError, match="24 layers"):
        get_config(ARCH, n_layers=25)


@pytest.mark.parametrize("arch,n_layers", [("xlstm-350m", 2), ("xlstm-350m", 3),
                                           ("xlstm-350m", 1), ("h2o-danube-1.8b", 2)])
def test_reduced_pattern_matches_reference(arch, n_layers):
    """``reduced()`` keeps one of each block kind when there is room, as
    the reference does."""
    assert get_config(arch).reduced(n_layers=n_layers).block_pattern == \
        j_get_config(arch).reduced(n_layers=n_layers).block_pattern
