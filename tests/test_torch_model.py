"""The port's dense transformer, optimizers and data stream against the
JAX package, on JAX-initialised weights carried over with
``from_jax_params``.  Logits and loss to rtol 1e-5, gradients to atol
1e-5 (f32 sums taken in another order; logits near zero also get atol
1e-5, the size of those reordered sums at O(1) logits); batches
bit-identical."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro.optim import momentum as j_momentum  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ParamLayout,
    from_jax_params,
    init_params,
    model_specs,
)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.params import _silo_count, tree_leaves_with_path  # noqa: E402
from repro_torch.optim import momentum, sgd  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg_j = j_get_config("internlm2-1.8b").reduced()
    cfg_t = get_config("internlm2-1.8b").reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(1), JT.model_specs(cfg_j)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, size=(2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab_size, size=(2, 24)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits_j = jax.jit(lambda p: JT.forward(p, cfg_j, batch_j["tokens"])[0])(params_np)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, cfg_j, batch_j)))(params_np)
    ref = {"logits": np.asarray(logits_j), "loss": float(loss_j), "grads": jax.device_get(grads_j)}
    return cfg_j, cfg_t, params_np, tokens, labels, ref


def test_reduced_config_and_specs_match(setup):
    cfg_j, cfg_t, params_np, _, _, _ = setup
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab_size", "block_pattern", "rope_theta", "norm_eps"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    ref = {p: tuple(np.shape(a)) for p, a in tree_leaves_with_path(params_np)}
    got = {p: s.shape for p, s in tree_leaves_with_path(model_specs(cfg_t))}
    assert ref == got
    assert ParamLayout(model_specs(cfg_t)).size == sum(int(np.prod(s)) for s in ref.values())


def test_full_width_config_matches():
    full_j = j_get_config("internlm2-1.8b", n_layers=4, block_pattern=("attn",) * 4)
    full_t = get_config("internlm2-1.8b", n_layers=4)
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size"):
        assert getattr(full_t, f) == getattr(full_j, f)
    assert ParamLayout(model_specs(full_t)).size == 630_736_896


@pytest.mark.parametrize("remat", [True, False])
def test_forward_and_loss_match(setup, remat):
    _, cfg_t, params_np, tokens, labels, ref = setup
    cfg_t = dataclasses.replace(cfg_t, remat=remat)
    params = from_jax_params(params_np, device="cpu")
    logits = TT.forward(params, cfg_t, torch.from_numpy(tokens).long())
    loss = TT.loss_fn(params, cfg_t, {"tokens": torch.from_numpy(tokens).long(),
                                      "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


def test_gradients_match(setup):
    _, cfg_t, params_np, tokens, labels, ref_out = setup
    params = from_jax_params(params_np, device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_leaves_with_path(params)]
    loss = TT.loss_fn(params, cfg_t, {"tokens": torch.from_numpy(tokens).long(),
                                      "labels": torch.from_numpy(labels).long()})
    loss.backward()
    ref = dict(tree_leaves_with_path(ref_out["grads"]))
    for (path, _), leaf in zip(tree_leaves_with_path(params), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), ref[path], atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kv_block", [8, 1024])
def test_chunked_attention_matches(window, kv_block):
    rng = np.random.default_rng(7)
    B, S, K, G, hd = 2, 24, 2, 2, 16
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    ref = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                    jnp.asarray(pos), causal=True, window=window, kv_block=kv_block)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(pos).long(), torch.from_numpy(pos).long(),
                            causal=True, window=window, kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_optimizer_step_matches(name):
    rng = np.random.default_rng(11)
    p = rng.standard_normal(300).astype(np.float32)
    grads = [rng.standard_normal(300).astype(np.float32) for _ in range(3)]
    j_opt, t_opt = (j_sgd(0.05), sgd(0.05)) if name == "sgd" else (j_momentum(0.05, 0.9), momentum(0.05, 0.9))
    jp, jstate = jnp.asarray(p), None
    jstate = j_opt.init(jp)
    tp = torch.from_numpy(p.copy())
    tstate = t_opt.init(tp)
    for s, g in enumerate(grads):
        jp, jstate = j_opt.update(jnp.asarray(g), jstate, jp, jnp.int32(s))
        t_opt.update(torch.from_numpy(g), tstate, tp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)


@pytest.mark.parametrize("silos", [None, (2, 0)])
def test_batches_bit_identical(silos):
    ref = JBatcher(JStream(512, 16, n_silos=3, seed=4), local_steps=2, batch_per_silo=3)
    got = FederatedBatcher(SyntheticLMStream(512, 16, n_silos=3, seed=4), 2, 3)
    assert np.array_equal(got.stream.probs, ref.stream.probs)
    for step in range(3):
        a, b = ref.batch(step, silos=silos), got.batch(step, silos=silos)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_init_params_and_layout_views():
    cfg = get_config("internlm2-1.8b").reduced()
    specs = model_specs(cfg)
    p1 = init_params(specs, seed=3, device="cpu")
    p2 = init_params(specs, seed=3, device="cpu")
    layout = ParamLayout(specs)
    leaves = tree_leaves_with_path(p1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves, tree_leaves_with_path(p2)))
    w = p1["layers"][0]["attn"]["wq"]
    assert w.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert float(w.abs().max()) <= 2 * cfg.d_model ** -0.5 + 1e-7  # clipped at 2 sigma
    assert torch.equal(p1["final_ln"], torch.ones(cfg.d_model))
    row = torch.zeros(layout.size)
    layout.flatten_into(p1, row)
    assert all(torch.equal(v, a) for v, (_, a) in zip(layout.leaf_views(row), leaves))


# ---------------------------------------------------------------------------
# The MoE, MLA and the last dense configs, reduced: forward, loss (cross
# entropy plus the MoE load-balance loss) and gradients at the same
# tolerances, the aux loss alone to 1e-6.

ZOO = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "granite-20b", "mistral-large-123b"]
ZOO_FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab_size", "block_pattern", "sliding_window",
              "mlp_variant", "tie_embeddings", "rope_theta", "norm_eps", "use_flash_kernel")


def _assert_same_config(cfg_t, cfg_j):
    for f in ZOO_FIELDS:
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    for f in ("moe", "mla"):
        got, ref = getattr(cfg_t, f), getattr(cfg_j, f)
        assert (got is None) == (ref is None), f
        if ref is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(ref), f


@pytest.fixture(scope="module", params=ZOO)
def zoo(request):
    arch = request.param
    cfg_j = j_get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    params_np = jax.device_get(j_init_params(jax.random.PRNGKey(2), JT.model_specs(cfg_j)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_t.vocab_size, size=(2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab_size, size=(2, 16)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits_j, aux_j = jax.jit(lambda p: JT.forward(p, cfg_j, batch_j["tokens"]))(params_np)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, cfg_j, batch_j)))(params_np)
    ref = {"logits": np.asarray(logits_j), "aux": float(aux_j), "loss": float(loss_j),
           "grads": jax.device_get(grads_j)}
    return arch, cfg_j, cfg_t, params_np, tokens, labels, ref


def test_zoo_reduced_config_and_specs_match(zoo):
    _, cfg_j, cfg_t, params_np, _, _, _ = zoo
    _assert_same_config(cfg_t, cfg_j)
    ref = {p: tuple(np.shape(a)) for p, a in tree_leaves_with_path(params_np)}
    got = {p: s.shape for p, s in tree_leaves_with_path(model_specs(cfg_t))}
    assert ref == got
    assert ParamLayout(model_specs(cfg_t)).size == sum(int(np.prod(s)) for s in ref.values())
    # one model's tree (leaves leading with V, D, E or F) is one silo, not a stack
    assert _silo_count(params_np) == 1


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_full_width_config_matches(arch):
    """The published config, and a depth cut that keeps the first kinds of
    the pattern (deepseek's dense first layer survives), with the
    reference's parameter count."""
    _assert_same_config(get_config(arch), j_get_config(arch))
    n = 2
    full_t = get_config(arch, n_layers=n)
    full_j = j_get_config(arch, n_layers=n, block_pattern=j_get_config(arch).block_pattern[:n])
    _assert_same_config(full_t, full_j)
    if arch.startswith("deepseek"):
        assert full_t.block_pattern == ("mla", "mla_moe")
    ref = sum(int(np.prod(s.shape)) for _, s in tree_leaves_with_path(JT.model_specs(full_j)))
    assert ParamLayout(model_specs(full_t)).size == ref


def test_zoo_forward_loss_and_gradients_match(zoo):
    _, _, cfg_t, params_np, tokens, labels, ref_out = zoo
    params = from_jax_params(params_np, device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_leaves_with_path(params)]
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    logits, aux = TT.forward(params, dataclasses.replace(cfg_t, remat=False), batch["tokens"],
                             return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), ref_out["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), ref_out["aux"], rtol=1e-6, atol=1e-6)
    assert (ref_out["aux"] > 0) == (cfg_t.moe is not None)
    loss = TT.loss_fn(params, cfg_t, batch)  # remat: the checkpointed blocks carry (x, aux)
    np.testing.assert_allclose(float(loss.detach()), ref_out["loss"], rtol=1e-5)
    loss.backward()
    ref = dict(tree_leaves_with_path(ref_out["grads"]))
    for (path, _), leaf in zip(tree_leaves_with_path(params), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), ref[path], atol=1e-5, err_msg=str(path))
