"""The port's observability layer (``repro_torch.obs``) against the
reference's ``repro.obs``, on the CPU.

The first half mirrors ``tests/test_obs.py`` on the port's modules: span
nesting and the near-zero disabled path, metrics snapshot/reset, the
JSONL flight recorder's schema round trips, the logger, the report
renderers, and the controller writing a complete decision record on a
forced regression.  The second half holds the two packages to each
other: the same ``emit`` calls give the same lines, both reports print
the same text on the same traces, the controller's traces are equal
record for record with the rewire climb off (the climb draws from a
torch generator, not ``jax.random``), the churn trace replays through
the reference's slot protocol, and a traced ``--dynamic`` run trains
exactly as an untraced one."""

import dataclasses
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro.analysis.rules.slot_protocol import replay_slot_trace  # noqa: E402
from repro.obs import events as r_events  # noqa: E402
from repro.obs import metrics as r_metrics  # noqa: E402
from repro.obs import report as r_report  # noqa: E402
from repro.obs import spans as r_spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dynamics import (  # noqa: E402
    ControllerConfig,
    DynamicTimeline,
    OnlineTopologyController,
    active_subgraph,
    link_failure_scenario,
)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.train import main, train  # noqa: E402
from repro_torch.obs import events, log, metrics, report, spans  # noqa: E402
from test_torch_dynamics import PORT, REF, controller_loop, redesign_fields  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NAMES = [name for name, _ in P.GAIA_SITES]


def _reset_both():
    for s, m in ((spans, metrics), (r_spans, r_metrics)):
        s.disable()
        s.reset()
        m.reset()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts and ends with obs disabled and empty in both
    packages, on one torch thread (the suite runs several worker
    processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset_both()
    yield
    _reset_both()
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Spans


class TestSpans:
    def test_disabled_span_is_the_shared_noop(self):
        assert spans.span("x") is spans.span("y")
        with spans.span("x") as s:
            s.set(ignored=1)
        assert spans.summary() == {}

    def test_disabled_path_overhead_is_near_zero(self):
        n = 200_000
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("hot"):
                pass
        per_call = (time.perf_counter() - t0) / n
        # the reference's budget: one flag read + a shared context manager
        assert per_call < 5e-6, f"{per_call*1e6:.2f}us per disabled span"
        assert spans.summary() == {}

    def test_nesting_records_parent_and_depth(self):
        spans.enable()
        with spans.span("outer"):
            with spans.span("inner"):
                pass
        recs = {r.name: r for r in spans.pop_finished()}
        assert recs["outer"].parent is None and recs["outer"].depth == 0
        assert recs["inner"].parent == "outer" and recs["inner"].depth == 1

    def test_summary_aggregates_count_total_max(self):
        spans.enable()
        for _ in range(3):
            with spans.span("agg"):
                pass
        s = spans.summary()["agg"]
        assert s["count"] == 3
        assert s["total_s"] >= s["max_s"] >= 0
        assert s["mean_s"] == pytest.approx(s["total_s"] / 3)

    def test_span_fn_decorator_only_times_when_enabled(self):
        @spans.span_fn("decorated")
        def f(x):
            return x + 1

        assert f(1) == 2
        assert "decorated" not in spans.summary()
        spans.enable()
        assert f(2) == 3
        assert spans.summary()["decorated"]["count"] == 1

    def test_attrs_land_on_the_record(self):
        spans.enable()
        with spans.span("job", phase="init") as s:
            s.set(items=4)
        (rec,) = spans.pop_finished()
        assert rec.attrs == {"phase": "init", "items": 4}

    def test_reset_clears_aggregate_and_ring(self):
        spans.enable()
        with spans.span("gone"):
            pass
        spans.reset()
        assert spans.summary() == {} and spans.pop_finished() == []

    def test_disabled_device_span_is_the_shared_noop_and_imports_nothing(self, monkeypatch):
        def no_event(*args, **kwargs):
            raise AssertionError("a disabled device span created a CUDA event")

        monkeypatch.setattr(torch.cuda, "Event", no_event)
        monkeypatch.setattr(torch.cuda, "current_stream", no_event)
        s = spans.device_span("x", torch.device("cuda"))
        assert s is spans.span("y") is spans.device_span("z")
        with s:
            pass
        assert spans.summary() == {}
        code = ("import sys\n"
                "from repro_torch.obs import spans\n"
                "with spans.device_span('x', None, k=1):\n"
                "    pass\n"
                "assert spans.device_span('x') is spans.span('y')\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'numpy'))\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_device_span_on_the_cpu_records_host_time_only(self):
        spans.enable()
        with spans.device_span("dev", torch.device("cpu"), silo=3):
            pass
        (rec,) = spans.pop_finished()
        assert rec.attrs == {"silo": 3} and rec.device_s is None and rec.duration_s >= 0
        assert set(spans.summary()["dev"]) == {"count", "total_s", "max_s", "mean_s"}

    def test_device_span_events_are_read_with_the_summary(self, monkeypatch):
        """The event pairs stay unread at exit; the summary and the ring
        read them, and past ``_PENDING_MAX`` only the pairs the card has
        passed are folded, without a wait."""
        log_ = []

        class Event:
            clock = 0.0

            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t, self.done = None, True

            def record(self, stream):
                log_.append(("record", stream))
                Event.clock += 0.5
                self.t = Event.clock

            def query(self):
                return self.done

            def synchronize(self):
                log_.append(("sync",))

            def elapsed_time(self, end):
                return end.t - self.t  # ms

        class Cuda:
            pass

        fake = type("T", (), {})()
        fake.cuda = Cuda()
        fake.cuda.Event = Event
        fake.cuda.current_stream = lambda device: f"stream {device}"
        fake.autograd = torch.autograd
        monkeypatch.setattr(spans, "_torch", lambda: fake)
        dev = torch.device("cuda", 1)
        spans.enable()
        with spans.span("outer"):
            for _ in range(3):
                with spans.device_span("dev", dev, k=1):
                    pass
        assert log_ == [("record", "stream cuda:1")] * 6  # no wait at exit
        s = spans.summary()
        assert log_[6:] == [("sync",)] * 3
        assert s["dev"]["device_count"] == 3 and s["dev"]["device_total_s"] == pytest.approx(1.5e-3)
        assert s["dev"]["device_max_s"] == pytest.approx(5e-4)
        assert "device_count" not in s["outer"]
        recs = spans.pop_finished()
        assert [r.device_s for r in recs if r.name == "dev"] == [pytest.approx(5e-4)] * 3
        assert [r.parent for r in recs if r.name == "dev"] == ["outer"] * 3
        monkeypatch.setattr(spans, "_PENDING_MAX", 4)
        del log_[:]
        for k in range(5):
            with spans.device_span("dev", dev):
                if k == 3:
                    spans._PENDING[1][3].done = False   # the card is behind from pair 1
        assert ("sync",) not in log_ and len(spans._PENDING) == 4
        assert spans._AGG["dev"][3] == 3 + 1


# ---------------------------------------------------------------------------
# Metrics


class TestMetrics:
    def test_counter_gauge_histogram_snapshot(self):
        metrics.counter("c").inc()
        metrics.counter("c").inc(2)
        metrics.gauge("g").set(7.5)
        for v in range(10):
            metrics.histogram("h").observe(float(v))
        snap = metrics.snapshot()
        assert snap["c"] == 3
        assert snap["g"] == 7.5
        h = snap["h"]
        assert h["count"] == 10 and h["min"] == 0.0 and h["max"] == 9.0
        assert h["p50"] <= h["p95"] <= h["max"]

    def test_same_name_same_instrument(self):
        assert metrics.counter("x") is metrics.counter("x")

    def test_kind_mismatch_raises(self):
        metrics.counter("typed")
        with pytest.raises(TypeError):
            metrics.gauge("typed")

    def test_reset_empties_registry(self):
        metrics.counter("tmp").inc()
        metrics.reset()
        assert metrics.snapshot() == {}


# ---------------------------------------------------------------------------
# Flight recorder / schema


class TestFlightRecorder:
    def test_round_trip_validates(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        with events.FlightRecorder(p, meta={"test": True},
                                   silo_names=["a", "b"]) as rec:
            rec.emit("epoch", index=0, t_start_ms=0.0, active=[0, 1])
            rec.emit("round", step=0, duration_ms=10.0,
                     predicted_window_ms=9.0, measured_window_ms=None,
                     drift=None)
        records, problems = events.validate_trace(p)
        assert problems == []
        assert [r["kind"] for r in records] == [
            "run_start", "epoch", "round", "run_end"]
        meta = records[0]["meta"]
        assert meta["schema_version"] == events.TRACE_SCHEMA_VERSION
        assert meta["test"] is True and meta["silo_names"] == ["a", "b"]
        assert set(records[-1]) >= {"metrics", "spans", "summary"}

    def test_unknown_kind_and_missing_field_raise_at_emit(self, tmp_path):
        rec = events.FlightRecorder(str(tmp_path / "t.jsonl"))
        with pytest.raises(ValueError, match="unknown"):
            rec.emit("nope")
        with pytest.raises(ValueError, match="missing required"):
            rec.emit("epoch", index=0)  # no t_start_ms/active
        rec.close()
        with pytest.raises(ValueError, match="closed"):
            rec.emit("epoch", index=0, t_start_ms=0.0, active=[])

    def test_validator_catches_corruption(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        with events.FlightRecorder(p):
            pass
        records = events.read_trace(p)
        records[0]["seq"] = 5  # break seq contiguity
        with open(p, "w") as fh:
            for r in records:
                fh.write(json.dumps(r) + "\n")
        _, problems = events.validate_trace(p)
        assert any("seq" in pr for pr in problems)

    def test_numpy_payloads_serialize(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        with events.FlightRecorder(p) as rec:
            rec.emit("epoch", index=np.int64(1),
                     t_start_ms=np.float64(2.5),
                     active=np.arange(3))
        (_, ep, _) = events.read_trace(p)
        assert ep["index"] == 1 and ep["active"] == [0, 1, 2]

    def test_cpu_tensor_payloads_serialize(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        with events.FlightRecorder(p) as rec:
            rec.emit("epoch", index=torch.tensor(1), t_start_ms=torch.tensor(2.5),
                     active=torch.arange(3))
        (_, ep, _) = events.read_trace(p)
        assert ep["index"] == 1 and ep["t_start_ms"] == 2.5 and ep["active"] == [0, 1, 2]
        assert events._jsonable(torch.tensor([1.5, 2.0])) == [1.5, 2.0]

    def test_run_metadata_never_initializes_cuda(self):
        meta = events.run_metadata()
        assert meta["device_kind"] == "uninitialized" or torch.cuda.is_initialized()
        assert meta["torch_version"] == torch.__version__
        assert meta["schema_version"] == events.TRACE_SCHEMA_VERSION
        assert "jax_version" not in meta

    def test_run_metadata_imports_neither_jax_nor_reference(self):
        code = (
            "import sys\n"
            "from repro_torch.obs import events\n"
            "m = events.run_metadata()\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'torch'))\n"
            "assert not bad and m['device_kind'] == 'uninitialized', (bad, m)\n"
            "import torch\n"
            "m = events.run_metadata()\n"
            "assert m['torch_version'] == torch.__version__, m\n"
            "assert m['cuda_version'] == (torch.version.cuda or 'none'), m\n"
            "assert m['device_kind'] == 'uninitialized', m\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Structured logger


class TestLog:
    def test_human_line_and_jsonl_share_fields(self, tmp_path):
        stream = io.StringIO()
        jp = str(tmp_path / "log.jsonl")
        lg = log.StructuredLogger("t", stream=stream, jsonl_path=jp)
        lg.info("swap", "plan moved", version=3)
        lg.debug("hidden")  # below the default info level
        assert "[t] swap plan moved version=3" in stream.getvalue()
        assert "hidden" not in stream.getvalue()
        (rec,) = [json.loads(ln) for ln in open(jp)]
        assert rec["event"] == "swap" and rec["version"] == 3

    def test_get_logger_is_a_singleton_registry(self):
        assert log.get_logger("same") is log.get_logger("same")


# ---------------------------------------------------------------------------
# Report rendering


def _write_trace(path, redesign_kw=None, ev=events):
    with ev.FlightRecorder(str(path), silo_names=["x", "y", "z"]) as rec:
        rec.emit("epoch", index=0, t_start_ms=0.0, active=[0, 1, 2])
        rec.emit("round", step=0, duration_ms=12.0,
                 predicted_window_ms=10.0, measured_window_ms=11.0,
                 drift=0.1)
        kw = dict(round_idx=5, winner="fixed", name="ring",
                  predicted_tau_ms=10.0, measured_ms=13.0,
                  expected_window_ms=11.0, drift=0.18, n_candidates=100,
                  elapsed_s=0.2, bottleneck=[0, 2, 0],
                  bottleneck_names=["x", "z", "x"], membership=None)
        kw.update(redesign_kw or {})
        rec.emit("redesign", **kw)
    return str(path)


class TestReport:
    def test_timeline_and_bottlenecks_render(self, tmp_path):
        trace = report.load_trace(_write_trace(tmp_path / "t.jsonl"))
        out = report.render_report(trace)
        assert "controller actuations" in out
        assert "x-z-x" in out  # circuit by silo name
        assert "ring" in out

    def test_check_trace_flags_problems(self, tmp_path):
        p = tmp_path / "bad.jsonl"
        p.write_text('{"v": 1, "seq": 0, "kind": "epoch"}\n')
        ok, lines = report.check_trace(str(p))
        assert not ok and any("problem" in ln for ln in lines)

    def test_diff_reports_circuit_change(self, tmp_path):
        a = report.load_trace(_write_trace(tmp_path / "a.jsonl"))
        b = report.load_trace(_write_trace(
            tmp_path / "b.jsonl",
            redesign_kw=dict(bottleneck=[0, 1, 0],
                             bottleneck_names=["x", "y", "x"])))
        out = report.diff_traces(a, b)
        assert "DIFFER" in out
        same = report.diff_traces(a, a)
        assert "structurally identical" in same


# ---------------------------------------------------------------------------
# Controller decision records (forced regression, Gaia link failure)


def test_controller_emits_complete_decision_record(tmp_path):
    M, Tc = P.WORKLOADS["inaturalist"]
    tp = P.TrainingParams(model_size_mbits=M, local_steps=1)
    u = P.make_underlay("gaia")
    gc0 = u.connectivity_graph(comp_time_ms=Tc)
    overlay = P.design_overlay("ring", gc0, tp, device="cpu")
    deadline_ms = 400 * overlay.cycle_time_ms
    scenario = link_failure_scenario(
        u, Tc, t_fail_ms=deadline_ms / 3, overlay_edges=overlay.edges,
        horizon_ms=deadline_ms)
    timeline = DynamicTimeline(scenario, tp)
    timeline.set_overlay(overlay.edges)
    p = str(tmp_path / "ctl.jsonl")
    recorder = events.FlightRecorder(p, silo_names=NAMES)
    timeline.attach_recorder(recorder)
    controller = OnlineTopologyController(
        gc0, tp, overlay,
        config=ControllerConfig(seed=0, rewire_restarts=0),
        connectivity_provider=lambda: active_subgraph(
            timeline.current_epoch().gc, timeline.current_epoch().active),
        recorder=recorder,
        silo_names=NAMES,
        device="cpu",
    )
    redesign = None
    while timeline.now_ms < deadline_ms and redesign is None:
        redesign = controller.observe_round(timeline.step())
    recorder.close()
    assert redesign is not None, "link failure never tripped the detector"

    records, problems = events.validate_trace(p)
    assert problems == []
    by_kind = {}
    for r in records:
        by_kind.setdefault(r["kind"], []).append(r)
    assert [e["index"] for e in by_kind["epoch"]] == [0, 1]
    (reg,) = by_kind["regression"]
    assert reg["strikes"] >= controller.config.patience
    assert reg["measured_ms"] > reg["expected_window_ms"]
    (rd,) = by_kind["redesign"]
    assert rd["round_idx"] == redesign.round_idx
    assert rd["winner"] == "fixed" and rd["name"] == redesign.overlay.name
    assert rd["n_candidates"] == redesign.n_candidates
    assert rd["drift"] == redesign.drift
    assert rd["expected_window_ms"] == redesign.expected_window_ms
    assert redesign.drift == redesign.measured_ms / redesign.expected_window_ms - 1.0
    assert rd["bottleneck"] == list(redesign.bottleneck)
    assert rd["bottleneck_names"] == [NAMES[s] for s in redesign.bottleneck]
    assert set(rd["bottleneck_names"]) <= set(NAMES)
    snap = metrics.snapshot()
    assert snap["controller.redesigns"] == 1
    assert snap["controller.regressions"] == 1
    out = report.render_report(report.load_trace(p))
    assert "saopaulo" in out or "sydney" in out or "virginia" in out


# ---------------------------------------------------------------------------
# The two packages against each other


_PROVENANCE = ("git_rev", "jax_version", "torch_version", "cuda_version", "device_kind",
               "python", "platform", "argv", "time_unix")


def _emit_sequence(ev, path):
    """The same records through either package's recorder: every kind,
    numpy, CPU-tensor, set, tuple and None payloads."""
    rec = ev.FlightRecorder(str(path), meta={"underlay": "gaia", "steps": 3},
                            silo_names=NAMES[:3])
    rec.emit("epoch", index=np.int64(0), t_start_ms=np.float64(0.0), active=np.arange(3))
    rec.emit("round", step=0, duration_ms=151.75, predicted_window_ms=150.5,
             measured_window_ms=None, drift=None)
    rec.emit("regression", round_idx=23, measured_ms=159.125, expected_window_ms=151.75,
             drift=159.125 / 151.75 - 1.0, strikes=3)
    rec.emit("membership", step=20, version=1, n_before=3, n_after=2, left=["ireland"],
             joined=[])
    rec.emit("swap", slot="plan", version=2, label="round20:ring_2opt", resized=True)
    rec.emit("redesign", round_idx=torch.tensor(20), winner="fixed", name="ring_2opt",
             predicted_tau_ms=np.float32(150.25), measured_ms=159.125,
             expected_window_ms=151.75, drift=0.048, n_candidates=644, elapsed_s=0.25,
             bottleneck=(0, 2, 0), bottleneck_names=["virginia", "california", "virginia"],
             membership=[0, 2], rho=None, objective="tau", tags={"b", "a"})
    rec.emit("metrics", snapshot={"slot.plan_version": 2.0})
    rec.close(steps=3, recompiles=2, wall_s=1.5)
    return ev.read_trace(str(path))


def _strip_provenance(records):
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k != "t_s"}
        if r["kind"] == "run_start":
            r["meta"] = {k: v for k, v in r["meta"].items() if k not in _PROVENANCE}
        out.append(r)
    return out


def test_same_emit_calls_give_the_same_records(tmp_path):
    ref = _emit_sequence(r_events, tmp_path / "ref.jsonl")
    port = _emit_sequence(events, tmp_path / "port.jsonl")
    assert _strip_provenance(port) == _strip_provenance(ref)
    assert [r["kind"] for r in port][-2:] == ["metrics", "run_end"]
    (rd,) = [r for r in port if r["kind"] == "redesign"]
    assert rd["tags"] == ["a", "b"] and rd["round_idx"] == 20 and rd["bottleneck"] == [0, 2, 0]
    # and each package's validator reads the other's trace
    assert events.validate_trace(str(tmp_path / "ref.jsonl"))[1] == []
    assert r_events.validate_trace(str(tmp_path / "port.jsonl"))[1] == []


def _controller_trace(pkg, ev, sp, me, case, path):
    """One controller loop of ``tests/test_torch_dynamics.py`` (climb off)
    with spans on and a recorder carrying Gaia's site names."""
    sp.reset()
    me.reset()
    sp.enable()
    rec = ev.FlightRecorder(str(path), silo_names=NAMES)
    try:
        controller_loop(pkg, case, recorder=rec, silo_names=NAMES)
        rec.close()
    finally:
        sp.disable()
    return str(path)


def _timings_out(records):
    """A controller trace without its timings: ``t_s``, the metadata,
    each re-design's ``elapsed_s``, and ``run_end``'s span times and
    timed metrics (span counts stay)."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k != "t_s"}
        if r["kind"] == "run_start":
            r.pop("meta")
        elif r["kind"] == "redesign":
            r.pop("elapsed_s")
        elif r["kind"] == "run_end":
            r["spans"] = {k: s["count"] for k, s in r["spans"].items()}
            r["metrics"] = {k: v for k, v in r["metrics"].items()
                            if k not in ("controller.redesign_s", "controller.candidates_per_s")}
        out.append(r)
    return out


@pytest.fixture(scope="module")
def controller_traces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ctl")
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case in ("linkfail", "churn-membership", "matcha"):
            _reset_both()
            before = dict(LAUNCHES)
            port = _controller_trace(PORT, events, spans, metrics, case,
                                     tmp / f"port-{case}.jsonl")
            assert dict(LAUNCHES) == before  # the CPU runs the plain versions
            ref = _controller_trace(REF, r_events, r_spans, r_metrics, case,
                                    tmp / f"ref-{case}.jsonl")
            out[case] = (port, ref)
    finally:
        _reset_both()
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("case", ["linkfail", "churn-membership", "matcha"])
def test_controller_traces_equal_reference(controller_traces, case):
    port, ref = controller_traces[case]
    records, problems = events.validate_trace(port)
    assert problems == []
    assert r_events.validate_trace(port)[1] == []
    ref_records = r_events.read_trace(ref)
    assert _timings_out(records) == _timings_out(ref_records)
    kinds = [r["kind"] for r in records]
    assert kinds.count("redesign") >= 1 and kinds[-1] == "run_end"
    assert records[0]["meta"]["silo_names"] == NAMES
    for rd in (r for r in records if r["kind"] == "redesign"):
        assert set(rd["bottleneck_names"]) <= set(NAMES)
    spans_run = records[-1]["spans"]
    assert {"controller.calibrate", "controller.redesign"} <= set(spans_run)
    if case == "linkfail":
        assert kinds.count("regression") >= 1
        assert [r["index"] for r in records if r["kind"] == "epoch"] == [0, 1]
        assert records[-1]["metrics"]["slot.plan_version"] >= 2
    elif case == "matcha":
        assert any(r["kind"] == "redesign" and r["winner"] == "randomized" for r in records)
        assert any(r["kind"] == "swap" and r["slot"] == "schedule" for r in records)
    else:
        assert records[-1]["metrics"]["slot.membership_swaps"] == 2


def test_churn_trace_replays_through_the_slot_protocol(controller_traces):
    records = events.read_trace(controller_traces["churn-membership"][0])
    resized = [r for r in records if r["kind"] == "swap" and r["resized"]]
    assert resized and all(r["slot"] == "plan" for r in resized)
    members = [r for r in records if r["kind"] == "membership"]
    assert [(m["left"], m["joined"]) for m in members] == [
        (["frankfurt"], []), ([], ["frankfurt"])]
    replay = replay_slot_trace(records, strict=False)
    assert replay.errors == []


def test_reports_print_the_same_text(controller_traces, tmp_path):
    traces = [p for pair in controller_traces.values() for p in pair]
    traces.append(_write_trace(tmp_path / "port.jsonl"))
    traces.append(_write_trace(tmp_path / "ref.jsonl", ev=r_events))
    for path in traces:
        assert report.render_report(report.load_trace(path)) == \
            r_report.render_report(r_report.load_trace(path))
        assert report.check_trace(path) == r_report.check_trace(path)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "seq": 0, "kind": "epoch"}\n')
    assert report.check_trace(str(bad)) == r_report.check_trace(str(bad))
    for a, b in zip(traces, traces[1:] + traces[:1]):
        assert report.diff_traces(report.load_trace(a), report.load_trace(b)) == \
            r_report.diff_traces(r_report.load_trace(a), r_report.load_trace(b))
    port, ref = controller_traces["linkfail"]
    out = report.diff_traces(report.load_trace(port), report.load_trace(ref))
    assert "DIFFER" not in out and out.rstrip().endswith("same")


# ---------------------------------------------------------------------------
# Traced --dynamic training


def _small_internlm2():
    return get_config("internlm2-1.8b").reduced(n_layers=1, d_model=128)


def test_tracing_changes_no_result_of_dynamic_training(tmp_path):
    """24 rounds of reduced internlm2 under a Gaia link failure, traced
    and untraced: the detector trips once, and the losses, re-designs,
    state and launch counts are the same bits."""
    kw = dict(dynamic=True, scenario="linkfail", steps=24, gossip_impl="pallas", seq_len=8,
              batch_per_silo=1, local_steps=1, device="cpu")
    p = str(tmp_path / "t.jsonl")
    before = dict(LAUNCHES)
    lines = []
    traced = train(_small_internlm2(), trace_out=p, metrics_interval=5, log=lines.append, **kw)
    assert not spans.enabled()  # restored after the run
    plain = train(_small_internlm2(), log=lambda line: None, **kw)
    assert dict(LAUNCHES) == before
    assert traced.losses == plain.losses and all(map(math.isfinite, traced.losses))
    rds = [redesign_fields(rd) for rd in traced.controller.redesigns]
    assert rds == [redesign_fields(rd) for rd in plain.controller.redesigns] and rds
    for key in ("params", "opt_state"):
        assert torch.equal(traced.state[key], plain.state[key]), key
    assert traced.state["step"] == plain.state["step"]

    records, problems = events.validate_trace(p)
    assert problems == []
    assert r_events.validate_trace(p)[1] == []
    ok, report_lines = r_report.check_trace(p)
    assert ok, report_lines
    meta = records[0]["meta"]
    assert meta["silo_names"] == NAMES and meta["scenario"] == "linkfail"
    assert meta["torch_version"] == torch.__version__ and meta["steps"] == 24
    rounds = [r for r in records if r["kind"] == "round"]
    assert [r["step"] for r in rounds] == [i for i in range(24) if i % 5 == 0]
    assert all(r["duration_ms"] > 0 for r in rounds)
    assert [r["index"] for r in records if r["kind"] == "epoch"] == [0, 1]
    (rd,) = [r for r in records if r["kind"] == "redesign"]
    assert rd["round_idx"] == traced.controller.redesigns[0].round_idx
    assert rd["bottleneck_names"] == [NAMES[s] for s in rd["bottleneck"]]
    assert sum(r["kind"] == "regression" for r in records) == 1
    end = records[-1]
    assert end["kind"] == "run_end"
    assert end["summary"]["steps"] == 24 and end["summary"]["recompiles"] == 2
    assert end["spans"]["step"]["count"] == end["spans"]["train.round"]["count"] == 24
    assert {"controller.redesign", "designer.search_jit"} <= set(end["spans"])
    m = end["metrics"]
    assert m["train.recompiles"] == 2 and len(rounds) == 5
    # 11 silos x (tokens, labels) of 1 x 1 x 8 int32 ids a round
    assert m["train.h2d_bytes"] == 24 * 11 * 2 * 8 * 4
    assert m["slot.plan_version"] == 2 and m["controller.redesigns"] == 1
    assert any("trace-written" in line for line in lines)


def _within(inner, outer):
    return outer.t_start_s <= inner.t_start_s and \
        inner.t_start_s + inner.duration_s <= outer.t_start_s + outer.duration_s


def test_step_spans_are_profiler_ranges_nested_as_the_spans_nest():
    """With spans on, a reduced DPASGD step under a CPU ``torch.profiler``
    shows ``step`` around one ``step.local`` a silo, each around its
    ``step.optimizer`` updates, and ``step.mix`` beside them; with spans
    off no such range appears."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_for_n_silos
    from repro_torch.optim import momentum

    cfg = dataclasses.replace(_small_internlm2(), n_silos=2)
    opt = momentum(0.05, 0.9)
    step = make_train_step(cfg, DPASGDConfig(local_steps=2, gossip_impl="pallas"), opt,
                           plan_for_n_silos("ring", 2))
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 1, 8), generator=torch.Generator().manual_seed(0))
    names = ("step", "step.local", "step.optimizer", "step.mix")

    def ranges():
        state = init_state(cfg, opt, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, {"tokens": tok, "labels": tok})
        return {n: sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                          if e.name == n) for n in names}

    assert ranges() == {n: [] for n in names}
    spans.enable()
    got = ranges()
    assert [len(got[n]) for n in names] == [1, 2, 4, 1]
    (outer,) = got["step"]

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    assert all(inside(r, outer) for n in names[1:] for r in got[n])
    assert all(sum(inside(o, loc) for loc in got["step.local"]) == 1
               for o in got["step.optimizer"])
    assert not any(inside(got["step.mix"][0], loc) for loc in got["step.local"])
    recs = {r.name: r for r in spans.pop_finished()}
    assert recs["step.local"].parent == "step" and recs["step.optimizer"].parent == "step.local"
    assert recs["step.mix"].parent == "step" and recs["step.mix"].device_s is None


def test_span_counts_follow_the_round_structure_under_churn(tmp_path):
    """A traced reduced ``--dynamic`` churn run: each ``train.round`` holds
    one ``train.batch``, ``step`` and ``step.mix``, n ``step.local`` and
    n s ``step.optimizer`` spans (n the round's silos), one
    ``train.control``; ``train.migrate`` once per migration, each its
    logged wall, and a ``train.rebuild`` for each step built again."""
    migrations = []
    s = 2
    res = train(_small_internlm2(), dynamic=True, scenario="churn", steps=12,
                gossip_impl="pallas", seq_len=8, batch_per_silo=1, local_steps=s, device="cpu",
                trace_out=str(tmp_path / "t.jsonl"), on_migration=migrations.append,
                log=lambda line: None)
    recs = spans.pop_finished()
    rounds = [r for r in recs if r.name == "train.round"]
    assert [r.attrs["round"] for r in rounds] == list(range(12))
    assert [r.attrs["n"] for r in rounds] == [rec["n"] for rec in res.rounds]
    assert [r.attrs["K"] for r in rounds] == [rec["K"] for rec in res.rounds]
    assert sorted({r.attrs["n"] for r in rounds}) == [10, 11]
    for rnd in rounds:
        inner = [r for r in recs if r is not rnd and _within(r, rnd)]
        count = {name: sum(r.name == name for r in inner)
                 for name in ("train.batch", "step", "step.local", "step.optimizer", "step.mix",
                              "train.control")}
        n = rnd.attrs["n"]
        assert count == {"train.batch": 1, "step": 1, "step.local": n, "step.optimizer": n * s,
                         "step.mix": 1, "train.control": 1}, rnd.attrs
        assert sorted(r.attrs["silo"] for r in inner if r.name == "step.local") == list(range(n))
    mig = [r for r in recs if r.name == "train.migrate"]
    assert len(migrations) == 2 and len(mig) == 2
    for r, m in zip(mig, migrations):
        assert r.duration_s >= m["wall_s"] and r.duration_s - m["wall_s"] < 1e-3
        assert (r.attrs["n_before"], r.attrs["n_after"]) == (len(m["old_active"]),
                                                            len(m["new_active"]))
    end = events.read_trace(str(tmp_path / "t.jsonl"))[-1]
    assert sum(r.name == "train.rebuild" for r in recs) == end["summary"]["recompiles"] - 1 >= 2


def test_cli_trace_out_passes_obs_report_check(tmp_path, capsys):
    p = str(tmp_path / "t.jsonl")
    assert main(["--reduced", "--device", "cpu", "--dynamic", "--scenario", "linkfail",
                 "--trace-out", p, "--metrics-interval", "5", "--steps", "6",
                 "--seq-len", "8", "--batch-per-silo", "1", "--local-steps", "1",
                 "--gossip-impl", "none"]) == 0
    spec = importlib.util.spec_from_file_location("obs_report", REPO / "scripts" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    capsys.readouterr()
    assert obs_report.main(["--check", p]) == 0
    out = capsys.readouterr().out
    assert "0 problem(s)" in out and "round=2" in out and "run_start=1" in out
    assert obs_report.main([p]) == 0
    assert "span summary" in capsys.readouterr().out
