"""Gossip plans and lowerings of the port against the JAX package: plans
(matrix and Birkhoff terms) must be identical, and the port's einsum /
ppermute / pallas lowerings must agree with the reference
``gossip_einsum`` to 2e-5 (f32 sums taken in another order)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import birkhoff as jbirk  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.fed.gossip import collective_bytes_per_round as j_bytes  # noqa: E402
from repro.fed.gossip import gossip_einsum as j_einsum  # noqa: E402
from repro.fed.topology_runtime import plan_for_n_silos as j_plan  # noqa: E402
from repro_torch.core import birkhoff as tbirk  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.fed.gossip import (  # noqa: E402
    GossipPlan,
    PlanSlot,
    collective_bytes_per_round,
    gossip_fused,
    mix,
)
from repro_torch.fed.topology_runtime import plan_for_n_silos  # noqa: E402

KINDS = ["ring", "chain", "star", "none"]


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_plans_identical_to_reference(kind, n):
    ref, got = j_plan(kind, n), plan_for_n_silos(kind, n)
    assert np.array_equal(ref.matrix, got.matrix)
    assert ref.terms == got.terms
    assert ref.num_transfers == got.num_transfers
    assert collective_bytes_per_round(got, 1234) == j_bytes(ref, 1234)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_birkhoff_and_consensus_copies_match(seed):
    rng = np.random.default_rng(seed)
    n = 6
    edges = [(i, j) for i in range(n) for j in range(n)
             if i != j and rng.random() < 0.4]
    edges = sorted(set(edges) | {(j, i) for i, j in edges})
    A_ref = jcons.local_degree_matrix(n, edges)
    A = tcons.local_degree_matrix(n, edges)
    assert np.array_equal(A, A_ref) and tcons.is_doubly_stochastic(A)
    tour = list(rng.permutation(n))
    assert np.array_equal(tcons.ring_matrix(n, tour), jcons.ring_matrix(n, tour))
    ref_terms = jbirk.birkhoff_decomposition(A_ref)
    terms = tbirk.birkhoff_decomposition(A)
    assert [(c, p.tolist()) for c, p in terms] == [(c, p.tolist()) for c, p in ref_terms]
    np.testing.assert_allclose(tbirk.reconstruct(terms, n), A, atol=1e-12)
    assert tbirk.schedule_cost(terms) == jbirk.schedule_cost(ref_terms)


@pytest.mark.parametrize("impl", ["einsum", "ppermute", "pallas"])
@pytest.mark.parametrize("kind,n", [("ring", 4), ("chain", 5), ("star", 4)])
def test_lowerings_match_reference_einsum(kind, n, impl):
    plan = plan_for_n_silos(kind, n)
    w = np.random.default_rng(n).standard_normal((n, 7, 3)).astype(np.float32)
    ref = j_einsum({"w": jnp.asarray(w)}, jnp.asarray(plan.matrix))["w"]
    got = mix(torch.from_numpy(w), plan, impl)
    assert got.shape == w.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("kind", ["ring", "star"])
def test_fused_on_flat_buffer_writes_in_place(kind):
    n = 4
    plan = plan_for_n_silos(kind, n)
    flat = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 101)).astype(np.float32))
    expect = np.asarray(j_einsum(jnp.asarray(flat.numpy()), jnp.asarray(plan.matrix)))
    out = gossip_fused(flat, plan, out=flat)
    assert out.data_ptr() == flat.data_ptr()
    np.testing.assert_allclose(flat.numpy(), expect, atol=2e-5)


def test_none_lowering_and_slot():
    plan = plan_for_n_silos("ring", 3)
    w = torch.ones(3, 4)
    assert mix(w, plan, "none") is w
    with pytest.raises(KeyError):
        mix(w, plan, "allreduce")
    slot = PlanSlot(plan)
    seen = []
    slot.on_swap(lambda p, v: seen.append(v))
    assert slot.swap(plan_for_n_silos("star", 3), "to-star") == 1 and seen == [1]
    with pytest.raises(ValueError):
        slot.swap(plan_for_n_silos("star", 4))
    assert slot.history == [(0, "init"), (1, "to-star")]
    assert GossipPlan.from_matrix(np.eye(3)).num_transfers == 0
