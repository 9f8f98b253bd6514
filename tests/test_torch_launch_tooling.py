"""The port's launch tooling against the JAX package's: the assignment's
input shapes and their gate, the parameter counts, the analytic FLOP
model and the input and cache stand-ins, for all ten archs x four shapes
(on the meta device: nothing is allocated); then the dry run on the CPU
at a reduced size, ``needs_cards`` without allocating, the sweep's
resume, the report's tables and the roofline's terms.  The reference's
``repro.launch.dryrun`` and ``perf_gossip`` set ``XLA_FLAGS`` when
imported, so no test imports them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_supported as j_shape_supported  # noqa: E402
from repro.launch import analytic_model as JA  # noqa: E402
from repro.launch import input_specs as JIS  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_supported  # noqa: E402
from repro_torch.launch import analytic_model as PA  # noqa: E402
from repro_torch.launch import dryrun, finalize_experiments, report, roofline, sweep  # noqa: E402
from repro_torch.launch import input_specs as IS  # noqa: E402
from repro_torch.models import count_params, model_specs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PARAMS_M = {  # the reference's counts, in millions
    "h2o-danube-1.8b": 1831, "xlstm-350m": 506, "internvl2-76b": 70562,
    "internlm2-1.8b": 1889, "qwen3-moe-30b-a3b": 30532, "deepseek-v2-lite-16b": 15706,
    "granite-20b": 20317, "mistral-large-123b": 122610, "whisper-large-v3": 1602,
    "hymba-1.5b": 1404,
}
SUBQUADRATIC = {"xlstm-350m", "hymba-1.5b", "h2o-danube-1.8b"}


def _shapes(tree, path=()):
    """``(path, shape)`` of every tensor of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return [(path, tuple(tree.shape))]
    if isinstance(tree, dict):
        return sum((_shapes(tree[k], path + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, (list, tuple)):
        return sum((_shapes(v, path + (i,)) for i, v in enumerate(tree)), [])
    return []


def _j_shapes(tree):
    return [tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_input_shapes_equal_the_reference():
    assert INPUT_SHAPES == J_SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_gate_and_subquadratic_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.is_subquadratic == jcfg.is_subquadratic == (arch in SUBQUADRATIC)
    for shape in INPUT_SHAPES:
        assert shape_supported(cfg, shape) == j_shape_supported(jcfg, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_the_reference(arch):
    n = count_params(model_specs(get_config(arch)))
    assert n == j_count_params(JT.model_specs(j_get_config(arch)))
    assert round(n / 1e6) == PARAMS_M[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_equal_the_reference_to_the_float(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape, spec in INPUT_SHAPES.items():
        assert PA.analytic_step_flops(cfg, spec, spec["kind"]) == \
            JA.analytic_step_flops(jcfg, spec, spec["kind"]), shape
    for S, T, decode in ((4096, 4096, False), (1, 32768, True), (100, 300, False),
                         (32768, 32768, False), (1, 524288, True)):
        assert PA.forward_flops(cfg, S, T, decode=decode) == \
            JA.forward_flops(jcfg, S, T, decode=decode), (S, T, decode)


def test_whisper_decode_counts_the_encoder_as_the_reference_does():
    cfg = get_config("whisper-large-v3")
    enc = sum(PA._layer_flops(cfg, "attn", i, 1500, 1500, False)
              for i in range(cfg.encoder.n_layers))
    flops = PA.analytic_step_flops(cfg, INPUT_SHAPES["decode_32k"], "decode")
    assert flops / 1e12 == pytest.approx(266, abs=1)
    assert enc * 128 / flops > 0.95


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_in_shapes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape, spec in INPUT_SHAPES.items():
        if spec["kind"] == "train":
            for accum in (1, 16):
                got = IS.train_input_specs(cfg, shape, accum_steps=accum)
                want = JIS.train_input_specs(jcfg, shape, accum_steps=accum)
                assert [s for _, s in _shapes(got)] == _j_shapes(want), (shape, accum)
                assert all(t.device.type == "meta" for t in got.values())
        else:
            got = IS.serve_input_specs(cfg, shape)
            want = JIS.serve_input_specs(jcfg, shape)
            assert [s for _, s in _shapes(got)] == _j_shapes(want), shape
            cache = got.get("cache", [])
            assert all(t.device.type == "meta" for t in
                       jax.tree_util.tree_leaves(cache, is_leaf=lambda x: isinstance(
                           x, torch.Tensor)))


def test_cache_bytes_match_the_reckoning():
    # internlm2: 24 layers x 8 KV heads x 128 x (K, V) x 2 bytes a token
    cache = IS.abstract_cache(get_config("internlm2-1.8b"), 1, 32768)
    pos = 24 * 32768 * 4
    assert IS.tree_bytes(cache) - pos == 24 * 8 * 128 * 2 * 2 * 32768
    danube = IS.abstract_cache(get_config("h2o-danube-1.8b"), 1, 32768)
    assert IS.tree_bytes(danube) - 24 * 4096 * 4 == 4096 * 24 * 8 * 80 * 2 * 2


def test_active_params_scale_only_the_routed_experts():
    dense = get_config("internlm2-1.8b")
    assert dryrun.active_param_count(dense) == count_params(model_specs(dense))
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch)
        m = cfg.moe
        routed = sum(3 * m.n_experts * cfg.d_model * m.d_expert
                     for kind in cfg.block_pattern if kind.endswith("_moe"))
        want = count_params(model_specs(cfg)) - routed + routed * m.top_k / m.n_experts
        assert dryrun.active_param_count(cfg) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "train_4k"),
                                        ("h2o-danube-1.8b", "prefill_32k"),
                                        ("whisper-large-v3", "decode_32k"),
                                        ("xlstm-350m", "long_500k")])
def test_dryrun_on_the_cpu_gives_ok_with_device_fields_not_measured(arch, shape, tmp_path):
    r = dryrun.dryrun_one(arch, shape, device="cpu", out=str(tmp_path), reduced=True,
                          seq_len=128, batch=2, flash_kernel=True)
    assert r["status"] == "ok", r.get("traceback")
    assert r["batch"] == 2 and r["failed_batches"] == [] and r["finite"]
    assert len(r["reduced"]) == 3 and r["reduced"][1] == f"seq_len 128 of " \
        f"{INPUT_SHAPES[shape]['seq_len']}"
    for key in dryrun.MEASURED:
        assert r[key] == roofline.NOT_MEASURED
    roof = r["roofline"]
    for key in ("step_s", "device_busy_s", "idle_share", "parts_s", "share"):
        assert roof[key] == roofline.NOT_MEASURED
    assert roof["bottleneck"] in ("compute", "memory")
    assert roof["bound_ms"] == max(roof["compute_ms"], roof["memory_ms"])
    assert roof["compute_rate"] == roofline.COMPUTE_RATE
    saved = json.loads(Path(dryrun.result_path(str(tmp_path), arch, shape)).read_text())
    assert saved["status"] == "ok" and saved["roofline"] == roof


@pytest.mark.parametrize("shape,cards", [("train_4k", 25), ("decode_32k", 7)])
def test_mistral_needs_cards_without_allocating(shape, cards):
    # device "cuda" raises here (no GPU): the record comes back before any allocation
    r = dryrun.dryrun_one("mistral-large-123b", shape)
    assert r["status"] == "needs_cards", r
    assert r["cards_needed"] == cards
    assert r["fit_bytes"] == r["n_params"] * 4 * (4 if shape == "train_4k" else 1)
    assert "batch" not in r and "device" not in r


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path):
    # there is no GPU here: the default device raises rather than run on the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_one("internlm2-1.8b", "decode_32k", out=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "xlstm-350m", "--shape", "long_500k", "--out", str(tmp_path)])
    from repro_torch.launch import perf_gossip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_gossip.main(["--silos", "2", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_depth_cut_keeps_the_full_depth_status():
    r = dryrun.dryrun_one("granite-20b", "decode_32k", device="cpu", reduced=True, n_layers=1,
                          seq_len=64, batch=1)
    assert r["status"] == "ok"
    assert r["full_depth"]["status"] == "needs_cards" and r["full_depth"]["cards_needed"] == 2
    assert "n_layers 1 of 2" in r["reduced"] and r["n_layers"] == 1


def test_long_500k_is_skipped_on_full_attention():
    got = {a: dryrun.dryrun_one(a, "long_500k")["status"] for a in ARCH_IDS
           if a not in SUBQUADRATIC}
    assert set(got.values()) == {"skipped"} and len(got) == 7


def _write(out, arch, shape, status):
    with open(dryrun.result_path(out, arch, shape), "w") as f:
        json.dump({"arch": arch, "shape": shape, "status": status}, f)


def test_sweep_skips_cached_pairs_without_spawning(tmp_path, monkeypatch, capsys):
    out = str(tmp_path)
    statuses = ("ok", "needs_cards", "skipped")
    for i, arch in enumerate(sweep.ARCHS):
        for j, shape in enumerate(sweep.SHAPES):
            _write(out, arch, shape, statuses[(i + j) % 3])
    _write(out, "xlstm-350m", "decode_32k", "error")
    calls = []

    class Done:
        returncode = 0

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    assert sweep.main(["--out", out, "--flash-kernel"]) == 0
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[1:5] == ["-m", "repro_torch.launch.dryrun", "--arch", "xlstm-350m"]
    assert cmd[cmd.index("--shape") + 1] == "decode_32k" and "--flash-kernel" in cmd
    assert capsys.readouterr().out.count("[skip]") == 39
    calls.clear()
    assert sweep.main(["--out", out, "--force"]) == 0
    assert len(calls) == 40


def test_sweep_records_a_timeout_and_retries_it_only_with_a_longer_limit(tmp_path,
                                                                         monkeypatch):
    out = str(tmp_path)
    for arch in sweep.ARCHS:
        for shape in sweep.SHAPES:
            if (arch, shape) != ("xlstm-350m", "prefill_32k"):
                _write(out, arch, shape, "skipped")
    calls = []

    def slow(cmd, timeout, **kw):
        calls.append(cmd)
        raise sweep.subprocess.TimeoutExpired(cmd, timeout)

    monkeypatch.setattr(sweep.subprocess, "run", slow)
    assert sweep.main(["--out", out, "--timeout", "900"]) == 1 and len(calls) == 1
    rec = json.loads(Path(dryrun.result_path(out, "xlstm-350m", "prefill_32k")).read_text())
    assert rec["status"] == "error" and rec["timed_out"] == 900 and rec["kind"] == "prefill"
    assert sweep.main(["--out", out, "--timeout", "600"]) == 0 and len(calls) == 1
    assert sweep.main(["--out", out, "--timeout", "1800", "--arch", "xlstm-350m"]) == 1
    assert len(calls) == 2
    rows = report.load(out)
    assert any("ERROR: timed out after 1800 s" in line
               for line in report.fmt_dryrun_table(rows).splitlines())


def _ok_record(arch, shape, batch, failed, step_s):
    roof = roofline.make_roofline(arch=arch, shape=shape, batch=batch, flops=3.35e12,
                                  bytes_moved=6.7e9, model_flops=2e12,
                                  measured={"step_s": step_s, "device_busy_s": step_s / 2,
                                            "idle_share": 0.5,
                                            "parts_s": {"matrix products": step_s / 4}})
    return {"arch": arch, "shape": shape, "status": "ok", "batch": batch,
            "failed_batches": failed, "peak_gib": 51.5, "step_s": step_s, "reduced": [],
            "roofline": json.loads(roof.to_json())}


def test_report_builds_both_tables_from_the_records(tmp_path):
    out = str(tmp_path)
    recs = [_ok_record("internlm2-1.8b", "decode_32k", 16, [128, 64, 32], 0.025),
            {"arch": "mistral-large-123b", "shape": "train_4k", "status": "needs_cards",
             "fit_bytes": 1961.8e9, "cards_needed": 25},
            {"arch": "internlm2-1.8b", "shape": "long_500k", "status": "skipped"},
            {"arch": "hymba-1.5b", "shape": "train_4k", "status": "error",
             "error": "RuntimeError: boom"}]
    for r in recs:
        with open(dryrun.result_path(out, r["arch"], r["shape"]), "w") as f:
            json.dump(r, f)
    rows = report.load(out)
    assert len(rows) == 4
    dry = report.fmt_dryrun_table(rows).splitlines()
    assert len(dry) == 2 + 40
    line = next(x for x in dry if x.startswith("| internlm2-1.8b | decode_32k |"))
    # the roofline: compute 50 ms at 67 TFLOP/s, bytes 2 ms at 3.35 TB/s
    assert "| 16 | 128, 64, 32 | 51.50 | 0.0250 | 0.500 | 50.000 | 2.000 | compute | 2.000 |" \
        in line
    assert any("needs_cards (25 cards: 1961.8 GB)" in x for x in dry)
    assert any("| internlm2-1.8b | long_500k | skipped" in x for x in dry)
    assert any("ERROR: RuntimeError: boom" in x for x in dry)
    assert sum("MISSING" in x for x in dry) == 36
    roof = report.fmt_roofline_table(rows).splitlines()
    assert len(roof) == 3 and roof[2].startswith("| internlm2-1.8b | decode_32k | 16 | 3350.0 |")
    assert "matrix products 0.006" in roof[2]
    target = tmp_path / "EXPERIMENTS.md"
    target.write_text("# E\n\n<!-- DRYRUN_TABLE -->\n\n<!-- ROOFLINE_TABLE -->\n")
    assert finalize_experiments.main(["--path", str(target), "--out", out]) == 0
    text = target.read_text()
    assert "<!--" not in text and "| internlm2-1.8b | decode_32k | ok |" in text
    assert roof[2] in text


def test_roofline_terms_at_the_cards_rates():
    r = roofline.make_roofline(arch="a", shape="s", batch=1, flops=67e12, bytes_moved=3.35e9,
                               model_flops=33.5e12, coll_bytes=900e9)
    assert (r.compute_ms, r.memory_ms, r.collective_ms) == (1000.0, 1.0, 2000.0)
    assert r.compute_tf32_ms == pytest.approx(1000 * 67 / 495)
    assert r.bottleneck == "collective" and r.bound_ms == 2000.0
    assert r.useful_flop_ratio == 0.5
    assert r.step_s == r.share == r.idle_share == roofline.NOT_MEASURED
    assert roofline.model_flops_estimate({"seq_len": 4096, "global_batch": 2}, 10.0,
                                         "train") == 6.0 * 10 * 8192
    assert roofline.model_flops_estimate({"seq_len": 4096, "global_batch": 2}, 10.0,
                                         "decode") == 2.0 * 10 * 2


def test_importing_the_tooling_sets_no_environment_variable():
    code = (
        "import os, sys\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.sweep, repro_torch.launch.report\n"
        "import repro_torch.launch.finalize_experiments, repro_torch.launch.perf_gossip\n"
        "import repro_torch.launch.roofline, repro_torch.launch.input_specs\n"
        "import repro_torch.launch.analytic_model\n"
        "changed = sorted(k for k in set(before) | set(os.environ)\n"
        "                 if before.get(k) != os.environ.get(k))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(changed, bad)\n"
        "sys.exit(1 if changed or bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
