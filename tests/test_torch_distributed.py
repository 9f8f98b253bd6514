"""One silo per process: the port's DPASGD over ``torch.distributed``.

Ranks run on the CPU over ``gloo`` (``repro_torch.launch.mesh.spawn``, a
``file://`` store, one torch thread each), the counterpart of the
reference's silo mesh (``tests/fed_worker.py``: one silo per virtual
device).  Each spawn serves a group of checks, and the parametrised cases
read its results:

* 4 ranks: the ``ppermute``, ``pallas`` and ``einsum`` lowerings on the
  tiny model's rows over ring, star and chain, bit for bit against row r
  of the stacked lowerings, within 1e-6 of each other and of the JAX
  package's 4-device ``gossip_shard_map`` (run in a subprocess with
  ``--xla_force_host_platform_device_count=4``, as tests/fed_worker.py
  runs), with the bytes each rank received; two DPASGD rounds from the
  JAX state (``from_jax_params``) under ``ppermute`` and ``pallas``, bit
  for bit against the single-process port and within 2e-5 of the JAX
  package's ``make_train_step(gossip_impl="ppermute", mesh)``;
  tests/fed_worker.py's three checks; ``train`` on a ring under
  ``pallas`` (bit for bit) and on MATCHA (1e-6) against single-process
  ``train``;
* 11 ranks: ``train(dynamic=True, scenario="churn")``, whose migrations,
  final checkpoint and leaver checkpoint equal the single-process run's
  byte for byte, and the same under ``designer="matcha"`` (the same round
  matrices, rows within 1e-6);
* ``torchrun`` with 4 ranks: the CLI prints the single-process CLI's
  ``step k loss`` lines.
"""

import os
import pickle
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.fed import (DPASGDConfig, init_state, local_sgd_steps,  # noqa: E402
                             make_train_step, plan_for_n_silos)
from repro_torch.fed.dpasgd import consensus_row, make_loss_fn, migrate_rank_state  # noqa: E402
from repro_torch.fed.gossip import (gossip_einsum, gossip_fused, gossip_permute,  # noqa: E402
                                    in_neighbours, mix_rank, recv_bytes_per_round)
from repro_torch.launch.mesh import init_silo_mesh, silo_mesh, spawn  # noqa: E402
from repro_torch.launch.train import batch_to_device, main, train  # noqa: E402
from repro_torch.models import (ModelConfig, ParamLayout, from_jax_params,  # noqa: E402
                                init_params, model_specs)
from repro_torch.optim import momentum, sgd  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, S_LOCAL, B, SEQ, ROUNDS = 4, 2, 2, 16, 2
KINDS = ("ring", "star", "chain")
IMPLS = ("ppermute", "pallas", "einsum")
CPU = torch.device("cpu")
STEP_LINE = re.compile(r"^step +(\d+) loss ([\d.]+)", re.M)
MATCHA_CHURN = dict(dynamic=True, scenario="churn", designer="matcha", steps=12, seq_len=16,
                    batch_per_silo=2, device="cpu")


def _tiny(n=1):
    """tests/fed_worker.py's model: 2 layers, d_model 64, vocab 256."""
    return ModelConfig("tiny", 2, 64, 2, 2, 128, 256, n_silos=n)


def _quiet(line):
    pass


def _rank_batch(batcher, r, rank):
    return batch_to_device({k: v[0] for k, v in batcher.batch(r, silos=(rank,)).items()}, CPU)


# ---------------------------------------------------------------------------
# Rank programs (run in the spawned processes)

def _static_rank(rank, world, init, jax_init):
    torch.set_num_threads(1)
    mesh = init_silo_mesh(rank, world, init, backend="gloo", device="cpu", log=_quiet)
    out = {"mix": {}, "rounds": {}}
    start = from_jax_params(jax_init, device="cpu")
    row = start["params"][rank].clone()
    for kind in KINDS:
        plan = plan_for_n_silos(kind, N)
        for impl in IMPLS:
            before = mesh.recv_bytes
            out["mix"][kind, impl] = (mix_rank(row.clone(), plan, impl, mesh),
                                      mesh.recv_bytes - before)
    # two rounds from the JAX package's state
    for impl in ("ppermute", "pallas"):
        state = {"params": start["params"][rank].clone(),
                 "opt_state": start["opt_state"][rank].clone(), "step": start["step"]}
        step = make_train_step(_tiny(N), DPASGDConfig(local_steps=S_LOCAL, gossip_impl=impl),
                               momentum(0.05, 0.9), plan_for_n_silos("ring", N), mesh=mesh)
        batcher = FederatedBatcher(SyntheticLMStream(256, SEQ, n_silos=N), S_LOCAL, B)
        losses = []
        for r in range(ROUNDS):
            state, m = step(state, _rank_batch(batcher, r, rank))
            losses.append(float(m["loss"]))
        out["rounds"][impl] = (state["params"], state["opt_state"], state["step"], losses)
    # tests/fed_worker.py::check_dpasgd_trains_and_converges
    opt = sgd(0.05)
    state = init_state(_tiny(N), opt, seed=0, device="cpu", mesh=mesh)
    step = make_train_step(_tiny(N), DPASGDConfig(local_steps=2, gossip_impl="ppermute"), opt,
                           plan_for_n_silos("ring", N), mesh=mesh)
    batcher = FederatedBatcher(SyntheticLMStream(256, 32, n_silos=N), 2, 4)
    losses = []
    for r in range(8):
        state, m = step(state, _rank_batch(batcher, r, rank))
        losses.append(float(m["loss"]))
    out["converge"] = (state["params"], losses)
    # tests/fed_worker.py::check_full_mixing_equals_single_worker
    opt = sgd(0.1)
    p0 = ParamLayout(model_specs(_tiny())).flatten_into(
        init_params(model_specs(_tiny()), seed=1, device="cpu"), torch.empty(115008))
    state = {"params": p0.clone(), "opt_state": None, "step": 0}
    step = make_train_step(_tiny(N), DPASGDConfig(local_steps=1, gossip_impl="ppermute"), opt,
                           plan_for_n_silos("star", N), mesh=mesh)
    one = SyntheticLMStream(256, 16, n_silos=1, seed=3).sample(0, 4, 0)
    state, _ = step(state, batch_to_device({k: v[None] for k, v in one.items()}, CPU))
    out["full_mixing"] = state["params"]
    # the launcher: a ring under pallas, and MATCHA
    kw = dict(silos=N, local_steps=S_LOCAL, batch_per_silo=B, seq_len=SEQ, steps=3,
              device="cpu", mesh=mesh, log=_quiet)
    cfg = get_config("internlm2-1.8b").reduced()
    res = train(cfg, topology="ring", gossip_impl="pallas", **kw)
    out["train_pallas"] = (res.state["params"], res.state["opt_state"], res.losses, res.rounds)
    res = train(cfg, designer="matcha", **kw)
    out["train_matcha"] = (res.state["params"], res.losses, res.consensus)
    out["staged"] = (_transfers(mesh, row), _staged(mesh, lambda: _transfers(mesh, row)))
    out["refusals"] = {}
    for key, call in (("backend", lambda: silo_mesh("cpu", backend="nccl", log=_quiet)),
                      ("silos", lambda: train(cfg, silos=2, steps=1, device="cpu", mesh=mesh,
                                              log=_quiet))):
        try:
            call()
        except ValueError as e:
            out["refusals"][key] = str(e)
    return out


def _transfers(mesh, row):
    """Every transfer path of the mesh on ``row``: the three lowerings over
    a ring and a star, the gather to rank 0, and a leave and rejoin of
    silo 2 (momentum slots) with its float64 consensus row."""
    got = {}
    for kind in ("ring", "star"):
        for impl in IMPLS:
            got[kind, impl] = mix_rank(row.clone(), plan_for_n_silos(kind, N), impl, mesh)
    got["gather"] = mesh.gather_rows(row, row.numel())
    state = {"params": row.clone(), "opt_state": row.flip(0).clone(), "step": 4}
    opt = momentum(0.05, 0.9)
    state, _, _ = migrate_rank_state(state, mesh, range(N), (0, 1, 3), size=row.numel(),
                                     optimizer=opt, step=4)
    state, _, _ = migrate_rank_state(state, mesh, (0, 1, 3), range(N), size=row.numel(),
                                     optimizer=opt, step=4)
    got["migrated"] = state
    return got


def _staged(mesh, fn):
    """``fn()`` in chunks of 16 KiB, with every tensor of the odd ranks
    staged, as a card's buffers are under gloo (through unpinned CPU
    buffers here), and the even ranks' sent as they are."""
    chunk, buffers = mesh.chunk_bytes, mesh._buffers
    mesh.chunk_bytes = 1 << 14
    mesh._buffers = [torch.empty(mesh.chunk_bytes, dtype=torch.uint8) for _ in range(2 * N)]
    if mesh.rank % 2:
        mesh._reachable = lambda t: False
    before = mesh.staged_bytes
    try:
        return fn(), mesh.staged_bytes - before
    finally:
        mesh.__dict__.pop("_reachable", None)
        mesh.chunk_bytes, mesh._buffers = chunk, buffers


def _churn_rank(rank, world, init, tmp):
    torch.set_num_threads(1)
    mesh = init_silo_mesh(rank, world, init, backend="gloo", device="cpu", log=_quiet)
    lines, migrations = [], []
    res = train(get_config("internlm2-1.8b").reduced(), dynamic=True, scenario="churn",
                steps=12, gossip_impl="pallas", seq_len=16, batch_per_silo=2, device="cpu",
                churn_checkpoint=os.path.join(tmp, "leavers"),
                checkpoint=os.path.join(tmp, "final.msgpack"), on_migration=migrations.append,
                mesh=mesh, log=lines.append)
    out = {"lines": lines, "migrations": migrations, "losses": res.losses,
           "rounds": res.rounds, "active": res.active}
    # MATCHA under churn: the mask and the schedule swaps broadcast by rank 0
    migrations = []
    res = train(_tiny(), mesh=mesh, on_migration=migrations.append, log=_quiet, **MATCHA_CHURN)
    out["matcha"] = {"migrations": [(m["left"], m["joined"]) for m in migrations],
                     "losses": res.losses, "consensus": res.consensus,
                     "params": res.state["params"]}
    return out


# ---------------------------------------------------------------------------
# The JAX package's multi-device run (a subprocess with 4 host devices)

def _jax_reference(out_path):
    """gossip_shard_map (ppermute; pallas in interpret mode) over ring, star
    and chain, and two rounds of make_train_step(gossip_impl="ppermute",
    mesh), on 4 virtual devices, from init_state(PRNGKey(0))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.data import FederatedBatcher as JBatcher
    from repro.data import SyntheticLMStream as JStream
    from repro.fed import DPASGDConfig as JFed
    from repro.fed import init_state as j_init_state
    from repro.fed import make_train_step as j_make_train_step
    from repro.fed.gossip import gossip_shard_map
    from repro.fed.topology_runtime import plan_for_n_silos as j_plan
    from repro.launch.mesh import compat_make_mesh, mesh_context
    from repro.models import ModelConfig as JModelConfig
    from repro.optim import momentum as j_momentum

    assert len(jax.devices()) == N, jax.devices()
    cfg = JModelConfig("tiny", "dense", 2, 64, 2, 2, 128, 256, n_silos=N)
    mesh = compat_make_mesh((N,), ("data",))
    opt = j_momentum(0.05, 0.9)

    def put(x):
        if getattr(x, "ndim", 0) > 0:
            return jax.device_put(x, NamedSharding(mesh, JP("data", *(None,) * (x.ndim - 1))))
        return x

    state = j_init_state(cfg, opt, jax.random.PRNGKey(0))
    sharded = jax.tree_util.tree_map(put, state)
    out = {"init": jax.device_get(state), "mix": {}}
    with mesh_context(mesh):
        for kind in KINDS:
            for impl in ("ppermute", "pallas"):
                mix = jax.jit(lambda p, plan=j_plan(kind, N), pallas=impl == "pallas":
                              gossip_shard_map(p, plan, mesh, "data", use_pallas=pallas))
                out["mix"][kind, impl] = jax.device_get(mix(sharded["params"]))
        step = jax.jit(j_make_train_step(
            cfg, JFed(local_steps=S_LOCAL, gossip_impl="ppermute", silo_axis="data"), opt,
            j_plan("ring", N), mesh))
        batcher = JBatcher(JStream(cfg.vocab_size, SEQ, n_silos=N), S_LOCAL, B)
        losses = []
        for r in range(ROUNDS):
            sharded, m = step(sharded, {k: jnp.asarray(v) for k, v in batcher.batch(r).items()})
            losses.append(float(m["loss"]))
    out["final"], out["losses"] = jax.device_get(sharded), losses
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _threads_env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


@pytest.fixture(scope="module")
def static_runs(tmp_path_factory):
    """One 4-rank spawn and, beside it, the JAX package's 4-device run."""
    import jax

    from repro.fed import init_state as j_init_state
    from repro.models import ModelConfig as JModelConfig
    from repro.optim import momentum as j_momentum

    jax_init = jax.device_get(j_init_state(JModelConfig("tiny", "dense", 2, 64, 2, 2, 128, 256,
                                                        n_silos=N),
                                           j_momentum(0.05, 0.9), jax.random.PRNGKey(0)))
    out_path = tmp_path_factory.mktemp("jax") / "reference.pkl"
    flags = "--xla_force_host_platform_device_count=4"
    proc = subprocess.Popen([sys.executable, __file__, str(out_path)], cwd=REPO,
                            env=_threads_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn(_static_rank, N, jax_init)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    return jax_init, ranks, ref


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(params_tree):
    """A reference params tree with a leading silo dim as the port's [n, P]."""
    return from_jax_params({"params": params_tree, "opt_state": (), "step": 0},
                           device="cpu")["params"]


def _stacked(ranks, pick):
    return torch.stack([pick(r) for r in ranks])


# ---------------------------------------------------------------------------
# 4 ranks: the lowerings

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_rank_mix_equals_stacked_row(static_runs, kind, impl):
    jax_init, ranks, _ = static_runs
    w = from_jax_params(jax_init, device="cpu")["params"]
    plan = plan_for_n_silos(kind, N)
    got = _stacked(ranks, lambda r: r["mix"][kind, impl][0])
    if impl == "einsum":
        torch.testing.assert_close(got, gossip_einsum(w, plan.matrix), atol=1e-6, rtol=0)
    else:
        stacked = gossip_permute(w, plan) if impl == "ppermute" else gossip_fused(w.clone(), plan)
        assert torch.equal(got, stacked), float((got - stacked).abs().max())
    # the three lowerings agree (tests/fed_worker.py::check_gossip_impls_agree)
    ein = _stacked(ranks, lambda r: r["mix"][kind, "einsum"][0])
    torch.testing.assert_close(got, ein, atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_rank_receives_one_row_per_distinct_in_neighbour(static_runs, kind, impl):
    _, ranks, _ = static_runs
    plan = plan_for_n_silos(kind, N)
    row_bytes = 115008 * 4
    for rank, r in enumerate(ranks):
        want = ((N - 1) if impl == "einsum" else len(in_neighbours(plan, rank))) * row_bytes
        assert r["mix"][kind, impl][1] == want == recv_bytes_per_round(plan, impl, rank,
                                                                       row_bytes)
    if kind == "star" and impl != "einsum":  # the hub receives every leaf once
        assert ranks[0]["mix"][kind, impl][1] == (N - 1) * row_bytes


@pytest.mark.parametrize("impl", ["ppermute", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_rank_mix_matches_jax_shard_map(static_runs, kind, impl):
    jax_init, ranks, ref = static_runs
    for a, b in zip(jax_init_leaves(ref["init"]), jax_init_leaves(jax_init)):
        np.testing.assert_array_equal(a, b)  # both runs start from the same draw
    got = _stacked(ranks, lambda r: r["mix"][kind, impl][0])
    np.testing.assert_allclose(got.numpy(), _flat(ref["mix"][kind, impl]).numpy(), atol=1e-6)


def jax_init_leaves(tree):
    from repro_torch.checkpoint.io import _leaves_with_keys

    return [np.asarray(v) for _, v in _leaves_with_keys(tree)]


def test_staged_transfers_equal_direct_ones(static_runs):
    """Staging (a card's buffers under gloo: through host buffers, a chunk
    at a time) changes no bit of any transfer path, also between a rank
    that stages and one that does not, and counts the staged bytes."""
    jax_init, ranks, _ = static_runs
    w = from_jax_params(jax_init, device="cpu")["params"]
    row_bytes = w.shape[1] * 4
    for rank, r in enumerate(ranks):
        direct, (staged, n_staged) = r["staged"]
        assert direct.keys() == staged.keys()
        for key in direct:
            if key == "migrated":
                for k in ("params", "opt_state"):
                    assert torch.equal(direct[key][k], staged[key][k]), (rank, k)
                assert direct[key]["step"] == staged[key]["step"] == 4
            elif key == "gather":
                assert (direct[key] is None) == (staged[key] is None) == (rank != 0)
                if rank == 0:
                    assert torch.equal(direct[key], w) and torch.equal(staged[key], w)
            else:
                assert torch.equal(direct[key], staged[key]), (rank, key)
        # silo 2 rejoined at its survivors' float64 consensus (params, slot)
        if rank == 2:
            rows = torch.stack([w[v] for v in (0, 1, 3)])
            assert torch.equal(direct["migrated"]["params"], consensus_row(rows, [0, 1, 2]))
            assert torch.equal(direct["migrated"]["opt_state"],
                               consensus_row(rows.flip(1), [0, 1, 2]))
        else:
            assert torch.equal(direct["migrated"]["params"], w[rank])
        assert (n_staged > 0) == bool(rank % 2) and n_staged % 4 == 0
    # a ring's pallas round stages the row out and the neighbour's in
    assert ranks[1]["staged"][1][1] % row_bytes == 0


# ---------------------------------------------------------------------------
# 4 ranks: DPASGD rounds

def _single_process_rounds(jax_init, impl):
    state = from_jax_params(jax_init, device="cpu")
    step = make_train_step(_tiny(N), DPASGDConfig(local_steps=S_LOCAL, gossip_impl=impl),
                           momentum(0.05, 0.9), plan_for_n_silos("ring", N))
    batcher = FederatedBatcher(SyntheticLMStream(256, SEQ, n_silos=N), S_LOCAL, B)
    losses = []
    for r in range(ROUNDS):
        state, m = step(state, batch_to_device(batcher.batch(r), CPU))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("impl", ["ppermute", "pallas"])
def test_two_rank_rounds_equal_single_process(static_runs, impl):
    jax_init, ranks, _ = static_runs
    state, losses = _single_process_rounds(jax_init, impl)
    assert torch.equal(_stacked(ranks, lambda r: r["rounds"][impl][0]), state["params"])
    assert torch.equal(_stacked(ranks, lambda r: r["rounds"][impl][1]), state["opt_state"])
    for r in ranks:
        assert r["rounds"][impl][2] == state["step"] == ROUNDS * S_LOCAL
        assert r["rounds"][impl][3] == losses  # the same float32 mean, bit for bit


@pytest.mark.parametrize("impl", ["ppermute", "pallas"])
def test_two_rank_rounds_match_jax_mesh_step(static_runs, impl):
    _, ranks, ref = static_runs
    expect = from_jax_params(ref["final"], device="cpu")
    np.testing.assert_allclose(_stacked(ranks, lambda r: r["rounds"][impl][0]).numpy(),
                               expect["params"].numpy(), atol=2e-5)
    np.testing.assert_allclose(_stacked(ranks, lambda r: r["rounds"][impl][1]).numpy(),
                               expect["opt_state"].numpy(), atol=2e-5)
    np.testing.assert_allclose(ranks[0]["rounds"][impl][3], ref["losses"], atol=2e-5)


def test_dpasgd_trains_and_converges(static_runs):
    """tests/fed_worker.py::check_dpasgd_trains_and_converges on 4 ranks."""
    _, ranks, _ = static_runs
    losses = ranks[0]["converge"][1]
    assert all(r["converge"][1] == losses for r in ranks)
    assert losses[-1] < losses[0], losses
    layout = ParamLayout(model_specs(_tiny()))
    w = _stacked(ranks, lambda r: layout.views(r["converge"][0])["embed"]).numpy()
    spread = np.abs(w - w.mean(0, keepdims=True)).max()
    assert spread < 0.5 * np.abs(w).max()


def test_full_mixing_equals_single_worker(static_runs):
    """tests/fed_worker.py::check_full_mixing_equals_single_worker on 4
    ranks: equal starts and batches under the star plan stay equal to one
    worker's local step."""
    _, ranks, _ = static_runs
    cfg, opt = _tiny(), sgd(0.1)
    layout = ParamLayout(model_specs(cfg))
    p = layout.flatten_into(init_params(model_specs(cfg), seed=1, device="cpu"),
                            torch.empty(layout.size))
    one = SyntheticLMStream(256, 16, n_silos=1, seed=3).sample(0, 4, 0)
    local_sgd_steps(make_loss_fn(cfg), opt, p, None,
                    batch_to_device({k: v[None] for k, v in one.items()}, CPU), 0, layout=layout)
    for r in ranks:
        np.testing.assert_allclose(r["full_mixing"].numpy(), p.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# 4 ranks: the launcher

def _single_train(**kw):
    return train(get_config("internlm2-1.8b").reduced(), silos=N, local_steps=S_LOCAL,
                 batch_per_silo=B, seq_len=SEQ, steps=3, device="cpu", log=_quiet, **kw)


def test_train_ring_pallas_equals_single_process(static_runs):
    _, ranks, _ = static_runs
    res = _single_train(topology="ring", gossip_impl="pallas")
    assert torch.equal(_stacked(ranks, lambda r: r["train_pallas"][0]), res.state["params"])
    assert torch.equal(_stacked(ranks, lambda r: r["train_pallas"][1]), res.state["opt_state"])
    P = res.state["params"].shape[1]
    for rank, r in enumerate(ranks):
        assert r["train_pallas"][2] == res.losses
        # a ring's K = 2 terms: one in-neighbour, one row a round
        assert [rec["recv_bytes"] for rec in r["train_pallas"][3]] == [P * 4] * 3
        assert [rec["rows_in"] for rec in r["train_pallas"][3]] == [1] * 3
        assert all(rec["K"] == 2 and rec["n"] == N and rec["active"] and rec["staged_bytes"] == 0
                   for rec in r["train_pallas"][3])


def test_train_matcha_matches_single_process(static_runs):
    """Every rank derives each round's matrix from the shared counter; the
    einsum lowering's row is within 1e-6 of the stacked einsum."""
    _, ranks, _ = static_runs
    res = _single_train(designer="matcha")
    for r in ranks:
        assert all(np.array_equal(a, b) for a, b in zip(r["train_matcha"][2], res.consensus))
        np.testing.assert_allclose(r["train_matcha"][1], res.losses, atol=1e-6)
    np.testing.assert_allclose(_stacked(ranks, lambda r: r["train_matcha"][0]).numpy(),
                               res.state["params"].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# 11 ranks: --dynamic churn

@pytest.fixture(scope="module")
def churn_runs(tmp_path_factory):
    """One 11-rank spawn (a churn run under pallas, then one under MATCHA)
    and, beside it, the same two runs in this process."""
    tmp_path = tmp_path_factory.mktemp("churn")
    spawned = []
    ranks_thread = threading.Thread(
        target=lambda: spawned.append(spawn(_churn_rank, 11, str(tmp_path / "dist"))))
    ranks_thread.start()
    lines = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' one thread: the same reduction orders
    try:
        single = train(get_config("internlm2-1.8b").reduced(), dynamic=True, scenario="churn",
                       steps=12, gossip_impl="pallas", seq_len=16, batch_per_silo=2,
                       device="cpu", churn_checkpoint=str(tmp_path / "single" / "leavers"),
                       checkpoint=str(tmp_path / "single" / "final.msgpack"), log=lines.append)
        matcha = train(_tiny(), log=_quiet, **MATCHA_CHURN)
    finally:
        torch.set_num_threads(threads)
        ranks_thread.join(timeout=600)
    assert not ranks_thread.is_alive() and len(spawned) == 1, "the 11 ranks did not finish"
    return tmp_path, spawned[0], single, lines, matcha


def test_matcha_churn_over_eleven_ranks_matches_single_process(churn_runs):
    """Every rank derives each round's matrix from its mirrored
    ScheduleSlot, through rank 0's schedule swaps and masks: the same
    matrices and migrations as one process, rows and losses within 1e-6."""
    _, ranks, _, _, single = churn_runs
    for r in ranks:
        m = r["matcha"]
        assert m["migrations"] == [((5,), ()), ((), (5,))]
        assert len(m["consensus"]) == len(single.consensus) == 12
        assert all(np.array_equal(a, b) for a, b in zip(m["consensus"], single.consensus))
        np.testing.assert_allclose(m["losses"], single.losses, atol=1e-6)
    rows = torch.stack([r["matcha"]["params"] for r in ranks])
    np.testing.assert_allclose(rows.numpy(), single.state["params"].numpy(), atol=1e-6)


def test_churn_over_eleven_ranks_matches_single_process(churn_runs):
    tmp_path, ranks, single, lines, _ = churn_runs
    for r in ranks:
        assert [(m["left"], m["joined"]) for m in r["migrations"]] == [((5,), ()), ((), (5,))]
        assert r["losses"] == single.losses
    assert ranks[0]["active"] == single.active == tuple(range(11))
    # rank 0 prints the run's lines, the same ones apart from wall times and
    # paths; the leaver's rank prints its own checkpoint's
    def same(x):
        for pat in (r"\(\d+\.\d+s\)", r"wall \d+\.\d+ s", r"in \d+ ms",
                    r"\(migration \d+\.\d+ s\)", r"-> \S+", r"\(\d+\.\d+ s\)"):
            x = re.sub(pat, "", x)
        return x

    leaver = [x for x in lines if "leaver silo" in x]
    assert len(leaver) == 1 and [same(x) for x in ranks[5]["lines"]] == [same(leaver[0])]
    assert [same(x) for x in ranks[0]["lines"]] == [same(x) for x in lines if x not in leaver]
    assert all(not r["lines"] for i, r in enumerate(ranks[1:], 1) if i != 5)
    # silo 5 sat out the rounds between its leave and its rejoin
    idle = [rec for rec in ranks[5]["rounds"] if not rec["active"]]
    assert idle and all(rec["recv_bytes"] == 0 for rec in idle)
    assert [rec["n"] for rec in ranks[0]["rounds"]] == [rec["n"] for rec in single.rounds]
    names = sorted(os.listdir(tmp_path / "single" / "leavers"))
    assert names and sorted(os.listdir(tmp_path / "dist" / "leavers")) == names
    for name in ["final.msgpack"] + [os.path.join("leavers", x) for x in names]:
        assert (tmp_path / "dist" / name).read_bytes() == \
            (tmp_path / "single" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# torchrun: the CLI

def test_torchrun_cli_prints_single_process_step_lines(capsys):
    args = ["--reduced", "--device", "cpu", "--silos", "4", "--topology", "ring",
            "--gossip-impl", "pallas", "--steps", "4", "--seq-len", "16",
            "--batch-per-silo", "2"]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", "-m", "repro_torch.launch.train"] + args,
                          cwd=REPO, env=_threads_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert main(args) == 0
    single = STEP_LINE.findall(capsys.readouterr().out)
    assert len(single) == 4
    assert STEP_LINE.findall(proc.stdout) == single


# ---------------------------------------------------------------------------
# No silent fallback

def test_nccl_on_the_cpu_raises_before_the_group_forms(tmp_path):
    with pytest.raises(ValueError, match="nccl sends CUDA buffers"):
        init_silo_mesh(0, 2, f"file://{tmp_path / 'store'}", backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_mismatched_backend_or_silo_count_raises(static_runs):
    _, ranks, _ = static_runs
    for r in ranks:
        assert "the process group runs 'gloo'" in r["refusals"]["backend"]
        assert "2 silos over 4 ranks" in r["refusals"]["silos"]


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
