"""The reference against the port at a tiny size on the CPU, through the
harness's own entries: each cell's check rounds (cell 1's AdamW rounds
under the ring; the churn cell's momentum rounds, its two migrations and
re-designs; the MATCHA cell's einsum rounds under resampled matrices),
and each planted fault that a cell can have comes out not correct."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.tests.conftest import ROOT
from portbench import core
from portbench.reference import membership

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 3_456_789_012_345   # past 32 bits, as the driver's are
GAPS = ("loss_gap", "grad_gap", "delta_gap", "follow_gap")


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(tiny_root, cell):
    rec = core.run_cell(cell, SEED, 1.0, False, device="cpu")
    checks = {c["name"]: c["value"] for c in rec["checks"]}
    # the limits are set for the cells' own sizes; at this size the gaps
    # are float32 round-off, and every exact comparison holds
    assert all(checks[g] < 1e-5 for g in GAPS if g in checks), checks
    assert all(checks[k] == 0 for k in checks if k not in GAPS), checks
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["window_s"] > 0 and len(rec["round_s"]) == rec["attempted"]
    if "migration_faults" in checks:
        assert checks["migrations_missing"] == 0 and checks["redesign_faults"] == 0


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_mix"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    # a whole run, window included, with the timed path broken underneath
    rec = core.run_cell(cell, SEED, 0.5, False, device="cpu", options={"fault": fault})
    assert rec["attempted"] >= 1
    assert not core.judge(rec["checks"]), rec["checks"]


def _state(n, P, gen):
    return {"params": torch.randn(n, P, generator=gen),
            "opt_state": torch.randn(n, P, generator=gen), "step": 4}


def test_migration_check_holds_survivors_and_joiners():
    gen = torch.Generator().manual_seed(0)
    old = _state(3, 1000, gen)
    # silo 1 leaves, silo 3 joins at the float64 mean of survivors 0 and 2
    new = {"params": torch.empty(3, 1000), "opt_state": torch.empty(3, 1000), "step": 4}
    for key in ("params", "opt_state"):
        new[key][0], new[key][1] = old[key][0], old[key][2]
        new[key][2] = ((old[key][0].double() + old[key][2].double()) / 2).float()
    assert membership.migration_faults(old, new, (0, 1, 2), (0, 2, 3), chunk=256) == 0
    bad = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in new.items()}
    bad["params"][0, 7] += 1e-3                        # a survivor's row touched
    assert membership.migration_faults(old, bad, (0, 1, 2), (0, 2, 3)) == 1
    bad = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in new.items()}
    bad["opt_state"][2] = old["opt_state"][0]          # a joiner not at the mean
    assert membership.migration_faults(old, bad, (0, 1, 2), (0, 2, 3)) > 900


def test_overlay_check():
    assert membership.overlay_faults([(0, 2), (2, 3), (3, 0)], (0, 2, 3)) == 0
    assert membership.overlay_faults([(0, 2), (2, 0)], (0, 2, 3)) == 1          # 3 left out
    assert membership.overlay_faults([(0, 1), (1, 2), (2, 0)], (0, 2, 3)) == 1  # a leaver used
    assert membership.overlay_faults([(0, 2), (2, 3)], (0, 2, 3)) == 1          # not strongly connected


CHURN = "h2o-danube-1.8b.gaia11.churn-1k"


def _churn_checks(**options):
    rec = core.run_cell(CHURN, SEED, 1.0, False, device="cpu", options=options)
    return {c["name"]: c["value"] for c in rec["checks"]}, rec


def test_a_fault_in_the_steps_rebuilt_after_a_migration_is_not_correct(tiny_root, monkeypatch):
    # the first step is sound, every step rebuilt on a new membership or
    # plan trains on half of each sequence: only the rounds after the
    # migrations can see it
    import repro_torch.launch.train as TR
    from portbench import training

    make, built = TR.make_train_step, []

    def rebuilt_faulty(*args, **kwargs):
        step = make(*args, **kwargs)
        built.append(step)
        return step if len(built) == 1 else training.faulty(step, "half_batch")

    monkeypatch.setattr(TR, "make_train_step", rebuilt_faulty)
    checks, rec = _churn_checks()
    assert checks["loss_gap"] < 1e-5 and checks["delta_gap"] < 1e-5     # the check rounds hold
    assert checks["follow_gap"] > 1e-3, checks
    assert not core.judge(rec["checks"])


def test_a_wrong_cycle_time_is_not_correct(tiny_root, monkeypatch):
    import dataclasses

    from repro_torch.dynamics.controller import OnlineTopologyController as CTL

    redesign = CTL._redesign

    def off(self, *args, **kwargs):
        return dataclasses.replace(redesign(self, *args, **kwargs),
                                   predicted_tau_ms=self.predicted_tau_ms * (1 + 1e-6))

    monkeypatch.setattr(CTL, "_redesign", off)
    checks, rec = _churn_checks()
    assert checks["tau_gap"] == pytest.approx(1e-6, rel=1e-3), checks
    assert not core.judge(rec["checks"])


def test_a_wrong_plan_after_a_redesign_is_not_correct(tiny_root, monkeypatch):
    # the rebuilt plans weigh a silo's own row 0.6 and its in-neighbour's 0.4
    import repro_torch.dynamics.controller as C
    from repro_torch.fed import GossipPlan

    plan_from_overlay = C.plan_from_overlay

    def skewed(*args, **kwargs):
        A = plan_from_overlay(*args, **kwargs).matrix
        n = len(A)
        return GossipPlan.from_matrix(0.8 * A + 0.2 * torch.eye(n, dtype=torch.float64).numpy())

    monkeypatch.setattr(C, "plan_from_overlay", skewed)
    checks, rec = _churn_checks()
    assert checks["plan_matrix_gap"] == pytest.approx(0.1), checks
    assert checks["follow_gap"] > 1e-3, checks
    assert not core.judge(rec["checks"])


def test_the_control_puts_float32_karp_in_place_of_the_cycle_time(tiny_root):
    checks, _ = _churn_checks(control="tf32")
    assert 0 < checks["tau_gap"] < 1e-5, checks
