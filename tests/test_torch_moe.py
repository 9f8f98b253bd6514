"""The port's MoE FFN, MLA attention and GELU MLP against the JAX package,
on the CPU, from numpy inputs and JAX-initialised weights carried over
with ``from_jax_params``.

* Dispatch: the chosen experts, each assignment's slot and the kept set
  are identical to the reference's, at a dropping capacity (E = 4, k = 2,
  factor 1.0) and at a dropless one; the dispatch buffer holds the same
  bits (the reference's slots past the port's width are empty); a
  hand-made router tie takes the reference's order (lower expert first).
* Values: the MoE output within 1e-5 and the aux loss within 1e-6; MLA
  forward, latents and the absorbed decode within 1e-5 (float32 sums
  taken in another order); the GELU MLP within 1e-6."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.layers import gelu_mlp as j_gelu_mlp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_jax_params, moe_forward  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.layers import gelu_mlp  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, factor=None):
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    if factor is not None:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                                   capacity_factor=factor))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                                   capacity_factor=factor))
    return cfg_j, cfg_t


def _weights(specs, seed):
    return jax.device_get(j_init_params(jax.random.PRNGKey(seed), specs))


def _j_dispatch(x, logits, k, E, cap):
    return jax.vmap(lambda xf, lg: JM._dispatch_group(xf, lg, k, E, cap))(
        jnp.asarray(x), jnp.asarray(logits))


@pytest.mark.parametrize("arch,factor", [
    ("qwen3-moe-30b-a3b", 1.0),
    ("qwen3-moe-30b-a3b", None),
    ("deepseek-v2-lite-16b", 1.0),
], ids=["qwen3-dropping", "qwen3-dropless", "deepseek-shared-dropping"])
def test_moe_dispatch_identical_and_forward_matches(arch, factor):
    cfg_j, cfg_t = _cfgs(arch, factor)
    m = cfg_t.moe
    assert (m.n_experts, m.top_k) == (4, 2)
    p_np = _weights(JM.moe_specs(cfg_j), 5)
    p = from_jax_params(p_np, device="cpu")
    B, S = 2, 24
    x = np.random.default_rng(8).standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    cap = TM.capacity(cfg_t, S)
    assert cap == int(max(1, (m.top_k * S * m.capacity_factor) // m.n_experts))

    logits = (x @ p_np["router"]).astype(np.float32)
    ref_buf, (ref_idx, ref_pos, ref_gate, ref_probs) = _j_dispatch(x, logits, m.top_k,
                                                                   m.n_experts, cap)
    buf, (idx, pos, gate, probs, keep) = TM._dispatch_group(
        torch.from_numpy(x), torch.from_numpy(logits), m.top_k, m.n_experts, cap)
    ref_keep = np.asarray(ref_gate) != 0
    assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
    assert np.array_equal(pos.numpy(), np.asarray(ref_pos))
    assert np.array_equal(keep.numpy(), ref_keep)
    if factor is None:
        assert keep.all()
    else:
        assert 0 < int((~keep).sum()) < keep.numel()
    W = buf.shape[2]
    assert W <= cap and not np.asarray(ref_buf)[:, :, W:].any()
    assert np.array_equal(buf.numpy(), np.asarray(ref_buf)[:, :, :W])
    np.testing.assert_allclose(gate.numpy(), np.asarray(ref_gate), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), rtol=1e-6, atol=1e-6)

    ref_out, ref_aux = jax.jit(lambda pp, xx: JM.moe_forward(pp, cfg_j, xx))(p_np, jnp.asarray(x))
    out, aux = moe_forward(p, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6, atol=1e-6)


def test_router_ties_take_the_reference_order():
    """Exact ties in the router's probabilities: the lower expert comes
    first (``jax.lax.top_k``), and positions follow from that order."""
    E, k, S, D = 4, 2, 6, 8
    logits = np.array([[0, 0, 0, 0], [1, 1, 0, 0], [0, 2, 2, 2], [3, 0, 3, 1],
                       [0, 0, 5, 5], [1, 1, 1, 1]], np.float32)[None]
    x = np.random.default_rng(3).standard_normal((1, S, D)).astype(np.float32)
    for cap in (1, 2, 3):
        _, (ref_idx, ref_pos, ref_gate, _) = _j_dispatch(x, logits, k, E, cap)
        _, (idx, pos, gate, _, _) = TM._dispatch_group(torch.from_numpy(x),
                                                       torch.from_numpy(logits), k, E, cap)
        assert np.array_equal(idx.numpy(), np.asarray(ref_idx)), cap
        assert np.array_equal(pos.numpy(), np.asarray(ref_pos)), cap
        assert np.array_equal(gate.numpy() != 0, np.asarray(ref_gate) != 0), cap
    assert idx[0].tolist() == [[0, 1], [0, 1], [1, 2], [0, 2], [2, 3], [0, 1]]


@pytest.fixture(scope="module")
def mla_model():
    cfg_j, cfg_t = _cfgs("deepseek-v2-lite-16b")
    assert (cfg_t.mla.kv_lora_rank, cfg_t.mla.qk_nope_dim, cfg_t.mla.qk_rope_dim,
            cfg_t.mla.v_head_dim) == (64, 32, 16, 32)
    p_np = _weights(JA.mla_specs(cfg_j), 6)
    x = np.random.default_rng(9).standard_normal((2, 12, cfg_t.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p_np, from_jax_params(p_np, device="cpu"), x


def test_mla_forward_matches(mla_model):
    cfg_j, cfg_t, p_np, p, x = mla_model
    S = x.shape[1]
    ref, (ref_c, ref_r) = jax.jit(lambda pp, xx: JA.mla_forward(
        pp, cfg_j, xx, jnp.arange(S, dtype=jnp.int32), return_latent=True))(p_np, jnp.asarray(x))
    out, (c_kv, k_rope) = TA.mla_forward(p, cfg_t, torch.from_numpy(x), torch.arange(S),
                                         return_latent=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(ref_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(ref_r), rtol=1e-5, atol=1e-5)


def test_mla_decode_matches(mla_model):
    """Fill the latent cache from the first 8 positions, then decode the
    next 4 by the absorbed path in both packages."""
    cfg_j, cfg_t, p_np, p, x = mla_model
    n, S, max_len = 8, x.shape[1], 16
    pos_j = jnp.arange(n, dtype=jnp.int32)
    _, (c_j, r_j) = JA.mla_forward(p_np, cfg_j, jnp.asarray(x[:, :n]), pos_j, return_latent=True)
    jcache = JA.fill_mla_cache(cfg_j, JA.init_mla_cache(cfg_j, 2, max_len, jnp.float32),
                               c_j, r_j, pos_j)
    _, (c_t, r_t) = TA.mla_forward(p, cfg_t, torch.from_numpy(x[:, :n]), torch.arange(n),
                                   return_latent=True)
    cache = TA.fill_mla_cache(TA.init_mla_cache(cfg_t, 2, max_len, torch.float32,
                                                torch.device("cpu")), c_t, r_t, torch.arange(n))
    decode = jax.jit(lambda pp, xx, c, pos: JA.mla_decode(pp, cfg_j, xx, c, pos))
    for pos in range(n, S):
        ref, jcache = decode(p_np, jnp.asarray(x[:, pos:pos + 1]), jcache, jnp.int32(pos))
        out, cache = TA.mla_decode(p, cfg_t, torch.from_numpy(x[:, pos:pos + 1]), cache, pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)


def test_gelu_mlp_matches_tanh_gelu():
    rng = np.random.default_rng(4)
    D, F = 16, 48
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    w_up = (rng.standard_normal((D, F)) * D ** -0.5).astype(np.float32)
    b_up = rng.standard_normal(F).astype(np.float32)
    w_down = (rng.standard_normal((F, D)) * F ** -0.5).astype(np.float32)
    b_down = rng.standard_normal(D).astype(np.float32)
    args = (x, w_up, b_up, w_down, b_down)
    ref = j_gelu_mlp(*(jnp.asarray(a) for a in args))
    got = gelu_mlp(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
