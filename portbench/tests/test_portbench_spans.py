"""The span metrics' readers, the window's span record and the idle split,
on synthetic data; and a tiny cell of each entry run on the CPU with the
program's spans on from the window's first round."""

from __future__ import annotations

import importlib

import pytest

from portbench import spans as bs
from repro_torch.obs.spans import SpanRecord

NAMES = ("silo_loop_ms_per_round", "optimizer_ms_per_round", "mix_ms_per_round",
         "control_ms_per_round", "migration_ms", "idle_outside_step_ms")


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


@pytest.mark.parametrize("name", NAMES)
def test_reader_returns_none_without_its_data(name):
    assert reader(name)({}) is None
    assert reader(name)({"round_spans": [], "control_spans": [], "migrate_spans_s": [],
                         "idle_split": None, "profiled": [0, 1]}) is None


def test_readers_on_a_synthetic_record():
    rec = {"profiled": [0, 1],
           "round_spans": [{"local_s": 9.0, "optimizer_s": 9.0, "mix_s": 9.0},
                           {"local_s": 9.0, "optimizer_s": 9.0, "mix_s": 9.0},
                           {"local_s": 0.010, "optimizer_s": 0.100, "mix_s": 0.012},
                           {"local_s": 0.030, "optimizer_s": 0.120, "mix_s": 0.014}],
           "control_spans": [{"s": 0.002, "redesign": False}, {"s": 0.300, "redesign": True},
                             {"s": 0.004, "redesign": False}],
           "migrate_spans_s": [0.110, 0.130],
           "idle_split": {"idle_s": 0.5, "outside_step_s": 0.125, "by_span": {}, "syncs": {}}}
    got = {name: reader(name)(rec) for name in NAMES}
    assert got == pytest.approx({"silo_loop_ms_per_round": 20.0, "optimizer_ms_per_round": 110.0,
                                 "mix_ms_per_round": 13.0, "control_ms_per_round": 3.0,
                                 "migration_ms": 120.0, "idle_outside_step_ms": 125.0})


def test_a_round_without_device_time_reads_none():
    rec = {"round_spans": [{"local_s": 0.01, "optimizer_s": None, "mix_s": None}]}
    assert reader("silo_loop_ms_per_round")(rec) == pytest.approx(10.0)
    assert reader("optimizer_ms_per_round")(rec) is None
    assert reader("mix_ms_per_round")(rec) is None


def rec_(name, t, d, device_s=None, **attrs):
    return SpanRecord(name=name, parent=None, depth=0, t_start_s=t, duration_s=d,
                      attrs=attrs, device_s=device_s)


def test_window_record_groups_spans_by_step():
    records = [
        rec_("train.round", 0.0, 10.0),
        rec_("step", 1.0, 5.0),
        rec_("step.local", 1.1, 2.0, silo=0), rec_("step.optimizer", 2.0, 0.5, device_s=0.25),
        rec_("step.local", 3.2, 1.0, silo=1), rec_("step.optimizer", 3.5, 0.5, device_s=0.5),
        rec_("step.mix", 4.5, 1.0, device_s=0.125),
        rec_("train.control", 6.5, 0.25),
        rec_("train.migrate", 7.0, 0.75),
        rec_("step", 11.0, 1.0),
        rec_("step.local", 11.1, 0.5, silo=0), rec_("step.optimizer", 11.2, 0.1, device_s=0.0625),
        rec_("step.mix", 11.7, 0.2, device_s=0.03125),
        rec_("train.control", 12.5, 2.0), rec_("controller.redesign", 12.6, 1.5),
    ]
    summary = {}
    for r in records:
        summary.setdefault(r.name, {"count": 0})["count"] += 1
    got = bs.window_record(records, summary)
    assert got["round_spans"] == [{"local_s": 3.0, "optimizer_s": 0.75, "mix_s": 0.125},
                                  {"local_s": 0.5, "optimizer_s": 0.0625, "mix_s": 0.03125}]
    assert got["control_spans"] == [{"s": 0.25, "redesign": False}, {"s": 2.0, "redesign": True}]
    assert got["migrate_spans_s"] == [0.75]
    summary["step.local"]["count"] += 1    # the ring dropped one: nothing is read
    assert bs.window_record(records, summary) == {}


def test_idle_split_on_synthetic_intervals():
    # microseconds; gaps of 10, 5, 50 and 90 between the card's activity
    device = [(0, 10), (5, 20), (30, 40), (45, 50), (100, 110), (200, 210)]
    host = [(0, 60, "train.round"), (0, 35, "step"), (2, 34, "step.local"),
            (41, 55, "train.control"), (42, 43, "cudaStreamSynchronize"),
            (20, 31, "aten::mm"), (36, 40, "cudaStreamSynchronize"), (60, 70, "aten::add")]
    got = bs.idle_split(device, host)
    assert got["window_s"] == pytest.approx(210e-6) and got["edges_s"] == 0
    assert got["idle_s"] == pytest.approx(155e-6)
    # every piece of the gaps at 40, 50 and 110, each cut where a span opens or closes
    assert got["outside_step_s"] == pytest.approx(145e-6)
    assert got["by_span"] == pytest.approx({"step.local": 10e-6, "train.round": 6e-6,
                                            "train.control": 9e-6, "no span": 130e-6})
    assert got["syncs"] == {"train.control": [1, pytest.approx(1e-6)],
                            "train.round": [1, pytest.approx(4e-6)]}
    assert got["runtime"] == {"train.control": [1, pytest.approx(1e-6), 0.0],
                              "train.round": [1, pytest.approx(4e-6), 0.0]}
    assert got["step_s"] == pytest.approx(35e-6)
    assert got["outside_step_s"] <= got["idle_s"]


def test_idle_split_counts_the_window_edges_and_a_trailing_gap_in_control_outside_step():
    """The card idles from the window's start to its first kernel and
    from the step's last kernel to the window's end, while the host runs
    the controller and the loop: all of the second counts outside
    ``step``."""
    device = [(10, 50)]
    host = [(5, 52, "step"), (6, 40, "step.local"), (60, 90, "train.control")]
    got = bs.idle_split(device, host, (0, 100))
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["idle_s"] == pytest.approx(60e-6) and got["edges_s"] == pytest.approx(60e-6)
    assert got["outside_step_s"] == pytest.approx(53e-6)
    assert got["by_span"] == pytest.approx({"no span": 23e-6, "step": 3e-6, "step.local": 4e-6,
                                            "train.control": 30e-6})
    assert got["step_s"] == pytest.approx(47e-6)
    assert got["outside_step_s"] <= got["window_s"] - got["step_s"] + 1e-12
    # without its window only the gaps between the card's activity count
    assert bs.idle_split(device, host)["idle_s"] == 0
    # a window with no device activity is idle throughout
    empty = bs.idle_split([], host, (0, 100))
    assert empty["idle_s"] == empty["edges_s"] == pytest.approx(100e-6)
    assert empty["outside_step_s"] == pytest.approx(53e-6)


def test_idle_split_counts_the_host_runtime_calls_by_span():
    host = [(0, 1000, "step.local"), (10, 15, "cudaLaunchKernel"), (20, 170, "cudaLaunchKernel"),
            (200, 203, "cuLaunchKernelEx"), (300, 400, "cudaStreamSynchronize"),
            (500, 600, "custom_op"), (1100, 1101, "cudaMalloc")]
    got = bs.idle_split([(0, 2000)], host, (0, 2000))
    assert got["idle_s"] == 0
    assert got["runtime"] == {"step.local": [4, pytest.approx(258e-6), pytest.approx(250e-6)],
                              "no span": [1, pytest.approx(1e-6), 0.0]}
    assert got["syncs"] == {"step.local": [1, pytest.approx(100e-6)]}


class _Ev:
    def __init__(self, name, dev, s, e, ann=False):
        self.name, self.device_type, self.is_user_annotation = name, dev, ann
        self.time_range = type("R", (), {"start": s, "end": e})()


def _prof(events, stamps=None):
    prof = type("P", (), {"events": lambda self: events})()
    if stamps is not None:
        prof.profiler = stamps
    return prof


def test_profile_intervals_leave_the_device_ranges_of_spans_out():
    events = [_Ev("kernel", "DeviceType.CUDA", 1, 2), _Ev("step.mix", "DeviceType.CUDA", 0, 9, True),
              _Ev("step.mix", "DeviceType.CPU", 0, 9, True), _Ev("aten::empty", "DeviceType.CPU", 3, 3)]
    assert bs.profile_intervals(_prof(events)) == ([(1, 2)], [(0, 9, "step.mix")], (0.0, 9))


def test_profile_window_reaches_the_profilers_stop():
    """The window runs to the profiler's stop call (its enable call's
    length plus its start-to-stop stamps), past the last event."""
    stats = type("S", (), {"profiler_enable_call_duration_us": 5,
                           "profiler_disable_call_duration_us": 250_000})()
    stamps = type("A", (), {"_stats": stats, "profiling_start_time_ns": 1_000,
                            "profiling_end_time_ns": 21_000})()
    prof = _prof([_Ev("kernel", "DeviceType.CUDA", 1, 2)], stamps)
    assert bs.profile_intervals(prof)[2] == (0.0, 25.0)
    assert bs.profiler_stop_s(prof) == pytest.approx(0.25)
    assert bs.profiler_stop_s(_prof([])) is None


@pytest.mark.parametrize("cell", ["internlm2-1.8b.ring4.adamw-4k",
                                  "h2o-danube-1.8b.gaia11.churn-1k"])
def test_spans_run_reads_a_tiny_cell_on_the_cpu(tiny_root, cell):
    """The cell's own entry with the spans on from its window's first
    round: one ``step`` a window round, the host metrics read, the device
    ones absent on the CPU, the spans off again after the run."""
    from portbench import spans_run
    from repro_torch.obs import spans

    rec = spans_run.run(cell, 7, 0.5, False, True, device="cpu")
    assert len(rec["round_spans"]) == len(rec["round_s"]) >= 1
    assert not spans.enabled() and spans.summary() == {}
    got = rec["span_metrics"]
    assert got["silo_loop_ms_per_round"] > 0
    assert "idle_split" not in rec and "device_window" not in rec   # untraced
    assert "optimizer_ms_per_round" not in got and "mix_ms_per_round" not in got
    if cell.endswith("churn-1k"):
        # the window's migrations (at this size the first falls in a check round)
        mig = rec["migrate_spans_s"]
        assert 1 <= len(mig) <= len(rec["migration_wall_s"]) == 2
        for span_s, wall in zip(mig, rec["migration_wall_s"][-len(mig):]):
            assert wall <= span_s < wall + 1e-3
        assert got["migration_ms"] > 0 and got["control_ms_per_round"] > 0
    off = spans_run.run(cell, 7, 0.5, False, False, device="cpu")
    assert off["span_metrics"] == {} and "round_spans" not in off
