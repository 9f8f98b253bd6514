"""``build_train_step(mesh=)`` and ``perf_gossip`` over ranks: AdamW
rounds of one silo per process equal the single-process step bit for bit
and match the JAX package's ``build_train_step(mesh=)``.

One 4-rank spawn (gloo on the CPU, one torch thread each, a ``file://``
store) serves every check: each rank runs ``perf_gossip.run_entries`` at
a reduced internlm2-1.8b (ring, chain and star under ``ppermute`` and
``pallas``, ring under ``einsum``; two AdamW rounds each through
``build_train_step(mesh=)`` from the same ``init_state``), then a leave and
rejoin of silo 2 through ``migrate_rank_state`` with AdamW's two slots.
The test holds each entry's params, ``mu``, ``nu`` and losses to the
stacked single-process ``build_train_step`` bit for bit, each rank's
received bytes to ``recv_bytes_per_round``, the joiner's params and both
slots to ``consensus_row``'s bits, and shows which lowerings of a plan
give the same bits (the K2 sum's products are exact where the weights
are powers of two: ring and star; chain's thirds round differently,
within AdamW's bound of 2 * lr * rounds, as tests/test_torch_steps.py
holds AdamW rounds).  ``perf_gossip.main`` runs at 2 ranks (16 take 40 s here).

Beside the spawn, a subprocess with 4 host devices
(``--xla_force_host_platform_device_count=4``, as
tests/test_torch_distributed.py runs the JAX package) takes the
reference's ``build_train_step(mesh=)`` through the same two AdamW rounds
of its own ``perf_gossip`` entries (ring, chain and star under
``ppermute``, ring under ``einsum``) from the port's initial state
(``state_to_tree``).  Every rank's entry is held to the reference entry of
its plan and lowering (``pallas`` to its plan's ``ppermute``): losses,
``mu`` and ``nu`` within 1e-5 and params within 2 * lr * rounds, as
tests/test_torch_steps.py holds the single-process rounds.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.data import FederatedBatcher, SyntheticLMStream  # noqa: E402
from repro_torch.fed import init_state, plan_for_n_silos  # noqa: E402
from repro_torch.fed.dpasgd import consensus_row, migrate_rank_state  # noqa: E402
from repro_torch.fed.gossip import recv_bytes_per_round  # noqa: E402
from repro_torch.launch import perf_gossip as PG  # noqa: E402
from repro_torch.launch.mesh import init_silo_mesh, spawn  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.launch.train import batch_to_device  # noqa: E402
from repro_torch.models import ParamLayout, from_jax_params, model_specs  # noqa: E402
from repro_torch.models.params import state_to_tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N = 4
OPTS = PG.Options(device="cpu", reduced=True, seq_len=16, batch=2, rounds=2, keep_rows=True)
CPU = torch.device("cpu")
LEAVER = 2


def _rank(rank, world, init):
    torch.set_num_threads(1)
    mesh = init_silo_mesh(rank, world, init, backend="gloo", device="cpu",
                          log=lambda line: None)
    out = PG.run_entries(mesh, OPTS)
    # a leave and a rejoin of silo 2 with AdamW's two slots
    cfg = PG.config(N, OPTS)
    opt = adamw(1e-4)
    state = init_state(cfg, opt, seed=3, device="cpu", mesh=mesh)
    state["opt_state"]["mu"].copy_(state["params"] * 0.5)
    state["opt_state"]["nu"].copy_(state["params"].square())
    out["pre_migration"] = {"params": state["params"].clone(),
                            "mu": state["opt_state"]["mu"].clone(),
                            "nu": state["opt_state"]["nu"].clone()}
    size = state["params"].numel()
    rest = tuple(r for r in range(N) if r != LEAVER)
    state, _, left = migrate_rank_state(state, mesh, range(N), rest, size=size, optimizer=opt,
                                        step=2)
    state, joined, _ = migrate_rank_state(state, mesh, rest, range(N), size=size,
                                          optimizer=opt, step=2)
    out["migrated"] = {"params": state["params"], "mu": state["opt_state"]["mu"],
                       "nu": state["opt_state"]["nu"], "step": state["step"],
                       "left": left, "joined": joined}
    return out


# the reference's perf_gossip entries
JAX_ENTRIES = (("ring", "ppermute"), ("chain", "ppermute"), ("star", "ppermute"),
               ("ring", "einsum"))


def _jax_reference(init_path, out_path):
    """The JAX package's ``build_train_step(mesh=)`` on 4 virtual devices:
    ``OPTS.rounds`` AdamW rounds of each of ``JAX_ENTRIES`` from the
    port's initial state."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as j_get_config
    from repro.data import FederatedBatcher as JBatcher
    from repro.data import SyntheticLMStream as JStream
    from repro.fed.topology_runtime import plan_for_n_silos as j_plan
    from repro.launch.mesh import compat_make_mesh, mesh_context
    from repro.launch.steps import build_train_step as j_build_train_step
    from repro.optim import adamw as j_adamw

    assert len(jax.devices()) == N, jax.devices()
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    cfg = dataclasses.replace(j_get_config(PG.ARCH).reduced(), n_silos=N, flash_vjp=True)
    mesh = compat_make_mesh((N,), ("data",))

    def put(x):
        if getattr(x, "ndim", 0) > 0:
            return jax.device_put(x, NamedSharding(mesh, JP("data", *(None,) * (x.ndim - 1))))
        return jnp.asarray(x)

    batcher = JBatcher(JStream(cfg.vocab_size, OPTS.seq_len, n_silos=N, seed=OPTS.seed), 1,
                       OPTS.batch)
    batches = [{k: jnp.asarray(v) for k, v in batcher.batch(r).items()}
               for r in range(OPTS.rounds)]
    out = {}
    with mesh_context(mesh):
        for kind, impl in JAX_ENTRIES:
            step = jax.jit(j_build_train_step(cfg, optimizer=j_adamw(1e-4), gossip_impl=impl,
                                              silo_axis="data", plan=j_plan(kind, N),
                                              mesh=mesh))
            state = jax.tree_util.tree_map(put, init)
            losses = []
            for batch in batches:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            out[kind, impl] = (jax.device_get(state), losses)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 4-rank spawn and, beside it, the JAX package's 4-device run
    from the same initial state; the single-process rounds of every entry
    are taken while the JAX run ends."""
    cfg = PG.config(N, OPTS)
    init = init_state(cfg, adamw(1e-4), seed=OPTS.seed, device="cpu")
    tmp = tmp_path_factory.mktemp("jax")
    init_path, out_path = tmp / "init.pkl", tmp / "reference.pkl"
    with open(init_path, "wb") as f:
        pickle.dump(state_to_tree(init, ParamLayout(model_specs(cfg))), f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen([sys.executable, __file__, str(init_path), str(out_path)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn(_rank, N)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            single = {entry: _single_process(*entry) for entry in PG.ENTRIES}
        finally:
            torch.set_num_threads(threads)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    return ranks, ref, single


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _single_process(kind, impl):
    """The stacked single-process AdamW rounds of the same entry."""
    cfg = PG.config(N, OPTS)
    opt = adamw(1e-4)
    state = init_state(cfg, opt, seed=OPTS.seed, device="cpu")
    step = build_train_step(cfg, optimizer=opt, gossip_impl=impl,
                            plan=plan_for_n_silos(kind, N))
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, OPTS.seq_len, n_silos=N,
                                                 seed=OPTS.seed), 1, OPTS.batch)
    losses = []
    for r in range(OPTS.rounds):
        state, m = step(state, batch_to_device(batcher.batch(r), CPU))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("entry", range(len(PG.ENTRIES)),
                         ids=[f"{k}-{i}" for k, i in PG.ENTRIES])
def test_rank_adamw_rounds_equal_single_process_bit_for_bit(runs, entry):
    ranks, _, single = runs
    kind, impl = PG.ENTRIES[entry]
    state, losses = single[kind, impl]
    for r in ranks:
        got = r["entries"][entry]
        assert (got["kind"], got["impl"]) == (kind, impl)
        assert torch.equal(got["rows"]["params"], state["params"][r["rank"]])
        assert torch.equal(got["rows"]["mu"], state["opt_state"]["mu"][r["rank"]])
        assert torch.equal(got["rows"]["nu"], state["opt_state"]["nu"][r["rank"]])
        assert [rd["loss"] for rd in got["rounds"]] == losses


@pytest.mark.parametrize("entry", range(len(PG.ENTRIES)),
                         ids=[f"{k}-{i}" for k, i in PG.ENTRIES])
def test_rank_adamw_rounds_match_reference_mesh_step(runs, entry):
    ranks, ref, _ = runs
    kind, impl = PG.ENTRIES[entry]
    tree, losses = ref[kind, impl if (kind, impl) in JAX_ENTRIES else "ppermute"]
    expect = from_jax_params(tree, device="cpu")
    assert expect["step"] == OPTS.rounds
    for r in ranks:
        got = r["entries"][entry]
        np.testing.assert_allclose([rd["loss"] for rd in got["rounds"]], losses, atol=1e-5)
        diff = float((got["rows"]["params"] - expect["params"][r["rank"]]).abs().max())
        assert diff <= 2 * 1e-4 * OPTS.rounds, diff
        for k in ("mu", "nu"):
            np.testing.assert_allclose(got["rows"][k].numpy(),
                                       expect["opt_state"][k][r["rank"]].numpy(), atol=1e-5)


@pytest.mark.parametrize("entry", range(len(PG.ENTRIES)),
                         ids=[f"{k}-{i}" for k, i in PG.ENTRIES])
def test_each_rank_receives_the_plans_bytes(ranks, entry):
    kind, impl = PG.ENTRIES[entry]
    plan = plan_for_n_silos(kind, N)
    P = ranks[0]["P"]
    for r in ranks:
        got = r["entries"][entry]
        want = recv_bytes_per_round(plan, impl, r["rank"], P * 4)
        assert want > 0 and got["expected_recv_bytes"] == want
        assert [rd["recv_bytes"] for rd in got["rounds"]] == [want] * OPTS.rounds
        assert all(rd["staged_bytes"] == 0 for rd in got["rounds"])  # CPU rows: no staging
        assert got["num_transfers"] == plan.num_transfers
        assert got["launches"] == 0  # the CPU takes K2's plain version


def test_lowerings_of_a_plan_agree(ranks):
    summary = PG.summarise(ranks, OPTS)
    rows = {(e["kind"], e["impl"]): e for e in summary["entries"]}
    assert all(e["recv_ok"] for e in rows.values())
    for key in (("ring", "einsum"), ("ring", "pallas"), ("star", "pallas")):
        assert rows[key]["same_bits_as_first"] and rows[key]["max_abs_diff_params"] == 0, key
    chain = rows["chain", "pallas"]
    assert not chain["same_bits_as_first"]
    assert 0 < chain["max_abs_diff_params"] <= 2 * 1e-4 * OPTS.rounds
    assert summary["star_ring_traffic_ratio"] == pytest.approx(3.0)
    roof = rows["star", "ppermute"]["roofline"]
    assert roof["coll_gbytes"] == 3 * ranks[0]["P"] * 4 / 1e9
    assert roof["step_s"] == rows["star", "ppermute"]["last_round_s"]
    lines = PG.table(summary)
    assert len(lines) == 2 + len(PG.ENTRIES) and lines[-1].endswith("3.00x")


def test_rejoiner_gets_params_and_both_adamw_slots_at_consensus_bits(ranks):
    rest = [r for r in range(N) if r != LEAVER]
    for key in ("params", "mu", "nu"):
        stacked = torch.stack([r["pre_migration"][key] for r in ranks])
        want = consensus_row(stacked, rest)
        joiner = ranks[LEAVER]["migrated"]
        assert torch.equal(joiner[key], want), key
        for r in rest:  # survivors keep their rows untouched
            assert torch.equal(ranks[r]["migrated"][key], ranks[r]["pre_migration"][key])
    assert ranks[LEAVER]["migrated"]["step"] == 2
    assert ranks[0]["migrated"]["left"] == (LEAVER,)
    assert ranks[0]["migrated"]["joined"] == (LEAVER,)


def test_perf_gossip_main_runs_on_the_cpu(tmp_path, capsys):
    assert PG.main(["--device", "cpu", "--reduced", "--silos", "2", "--seq-len", "16",
                    "--batch", "2", "--rounds", "1", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "ring vs star gossip traffic ratio: 1.00x" in out
    summary = json.loads((tmp_path / "perf_gossip.json").read_text())
    assert summary["silos"] == 2 and len(summary["entries"]) == len(PG.ENTRIES)
    assert all(e["recv_ok"] for e in summary["entries"])


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
