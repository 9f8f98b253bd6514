"""The port's analysis layer (``repro_torch.analysis``) against the JAX
package's ``repro.analysis``.

* repro-lint: for every framework-neutral snippet of the reference's own
  lint tests (tests/test_lint_rules.py, tests/test_protocol_rules.py,
  tests/test_dataflow.py) the port's lint reports the same (rule, line,
  col) list as the reference's, with the snippet's ``src/repro/...``
  path moved to ``src/repro_torch/...``; each torch idiom of the port's
  rules, positive and negative; the port's tree has no violation outside
  its baseline, every baseline entry carries a reason, and the
  reference's gate finds nothing new in ``src/repro_torch``.
* ``@contract``: every public function of the six engine modules carries
  one, its spec equal to the reference's where the reference has the
  function (a ``*_torch`` twin: its numpy/JAX counterpart's); a wrong
  shape names the function and the argument; the checker never turns a
  tensor into an array.
* recompile guards: 12 sampled MATCHA rounds build the train step once,
  and a kernel library is built and loaded once a process.

Tolerance: none: every comparison is exact.
"""

import ast
import functools
import importlib
import os
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as RL  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis import lint as PL  # noqa: E402
from repro_torch.analysis.contracts import ContractError, contract  # noqa: E402
from repro_torch.analysis.recompile import TraceCounter, assert_max_traces  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ENGINE_MODULES = ("core/maxplus_vec.py", "core/maxplus_sparse.py", "core/delays.py",
                  "core/schedule.py", "core/mixing.py", "kernels/segment_max.py")


# ---------------------------------------------------------------------------
# The lint against the reference's, snippet by snippet

#: reference test file -> the path its ``run`` helper lints a snippet as
_SNIPPET_FILES = {"test_lint_rules.py": "snippet.py",
                  "test_protocol_rules.py": "src/repro/dynamics/snippet.py",
                  "test_dataflow.py": "snippet.py"}
_FRAMEWORK_WORDS = ("jax", "lax", "jnp", "torch")


def _snippet_cases():
    """(id, source, reference path, engine-config?) for every multi-line
    string of the three reference test files that parses as Python and
    names no framework; the path and config are the enclosing call's."""
    cases = []
    for fname, default_path in _SNIPPET_FILES.items():
        text = (REPO / "tests" / fname).read_text()
        tree = ast.parse(text)
        call_of = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args:
                for arg in node.args[:2]:
                    call_of[id(arg)] = node
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and "\n" in node.value):
                continue
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue  # a docstring, not a snippet
            if not src.strip() or any(w in src for w in _FRAMEWORK_WORDS):
                continue
            path, engine = default_path, False
            call = call_of.get(id(node))
            if call is not None:
                for kw in call.keywords:
                    if kw.arg == "path" and isinstance(kw.value, ast.Constant):
                        path = kw.value.value
                    elif kw.arg == "config":
                        engine = True
            cases.append(pytest.param(src, path, engine, id=f"{fname}:{node.lineno}"))
    return cases


def _port_path(path):
    return "src/repro_torch/" + path[len("src/repro/"):] if path.startswith("src/repro/") \
        else path


def _triples(vs):
    return [(v.rule, v.line, v.col) for v in vs]


SNIPPETS = _snippet_cases()


def test_snippet_harvest_covers_every_file():
    files = {c.id.split(":")[0] for c in SNIPPETS}
    assert files == set(_SNIPPET_FILES) and len(SNIPPETS) >= 80


@pytest.mark.parametrize("src,path,engine", SNIPPETS)
def test_lint_matches_reference_on_neutral_snippet(src, path, engine):
    ref_cfg = RL.LintConfig(engine_modules=("snippet.py",)) if engine else None
    port_cfg = PL.LintConfig(engine_modules=("snippet.py",)) if engine else None
    ref = RL.lint_source(src, path=path, config=ref_cfg)
    port = PL.lint_source(src, path=_port_path(path), config=port_cfg)
    assert _triples(port) == _triples(ref)


# ---------------------------------------------------------------------------
# The port's torch idioms, positive and negative

HOT = "src/repro_torch/core/snippet.py"
ENGINE = PL.LintConfig(engine_modules=(HOT,))

# (id, source, path, rule, expected count, message fragment)
IDIOMS = [
    # trace-safety: the traced view is PyTorch's
    ("autograd_forward_item", """
        import torch

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.item()

            @staticmethod
            def backward(ctx, g):
                return g
        """, HOT, "trace-safety", 1, ".item()"),
    ("autograd_backward_float", """
        from torch.autograd import Function

        class F(Function):
            @staticmethod
            def forward(ctx, x):
                return x

            @staticmethod
            def backward(ctx, g):
                return g * float(g.sum())
        """, HOT, "trace-safety", 1, "float()"),
    ("autograd_helper_closure", """
        import torch

        def _scale(x):
            return x * x.max().item()

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return _scale(x)
        """, HOT, "trace-safety", 1, "_scale"),
    ("torch_compile_decorator", """
        import torch

        @torch.compile
        def step(x):
            if x > 0:
                return x
            return -x
        """, HOT, "trace-safety", 1, "branch"),
    ("torch_compile_call", """
        import numpy as np
        import torch

        def step(x):
            return np.square(x)

        fast = torch.compile(step, mode="reduce-overhead")
        """, HOT, "trace-safety", 1, "np.square"),
    ("torch_func_vmap", """
        from torch.func import vmap

        def row(x):
            return x.sum().item()

        batched = vmap(row)
        """, HOT, "trace-safety", 1, ".item()"),
    ("cuda_graph_capture", """
        import torch

        def body(x):
            return float(x.sum())

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
        """, HOT, "trace-safety", 1, "float()"),
    ("make_graphed_callables", """
        import torch

        def body(x):
            return x.tolist()

        def capture(x):
            return torch.cuda.make_graphed_callables(body, (x,))
        """, HOT, "trace-safety", 1, ".tolist()"),
    ("plain_function_is_not_traced", """
        def step(x):
            return x * x.item()
        """, HOT, "trace-safety", 0, ""),
    ("autograd_shape_branch_is_clean", """
        import torch

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                if x.shape[0] > 1:
                    return torch.where(x > 0, x, -x)
                return x
        """, HOT, "trace-safety", 0, ""),
    ("plain_module_method_forward_is_not_traced", """
        class Net:
            def forward(self, x):
                return x.item()
        """, HOT, "trace-safety", 0, ""),
    ("jax_jit_does_not_trace_in_the_port", """
        import jax

        @jax.jit
        def f(x):
            return float(x)
        """, HOT, "trace-safety", 0, ""),
    # obs-purity reads the same view
    ("span_in_autograd_forward", """
        import torch
        from repro_torch.obs.spans import span

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                with span("inside"):
                    return x + 1
        """, HOT, "obs-purity", 1, "host effects"),
    ("relative_obs_import_in_compiled_body", """
        import torch

        @torch.compile
        def f(x):
            from ..obs.events import FlightRecorder
            return x
        """, HOT, "obs-purity", 1, "lazy import"),
    ("span_decorator_on_compiled_function", """
        import torch
        from repro_torch.obs.spans import span_fn

        @torch.compile
        @span_fn("engine.bad")
        def f(x):
            return x + 1
        """, HOT, "obs-purity", 2, "span"),  # the call and the decorator, as the reference
    ("host_level_span_is_clean", """
        import torch
        from repro_torch.obs.spans import span, span_fn

        @torch.compile
        def kernel(x):
            return x * 2

        @span_fn("engine.entry")
        def entry(x):
            with span("engine.dispatch"):
                return kernel(x)
        """, HOT, "obs-purity", 0, ""),
    # rng-discipline
    ("torch_manual_seed", """
        import torch
        torch.manual_seed(0)
        """, HOT, "rng-discipline", 1, "torch.manual_seed"),
    ("torch_cuda_manual_seed_all", """
        import torch

        def seed_all(s):
            torch.cuda.manual_seed_all(s)
        """, HOT, "rng-discipline", 1, "process-wide"),
    ("torch_draws_without_generator", """
        import torch

        def draw(n):
            a = torch.rand(n)
            b = torch.randn(n, n)
            c = torch.randint(0, 5, (n,))
            d = torch.randperm(n)
            e = torch.normal(0.0, 1.0, (n,))
            f = torch.bernoulli(a)
            g = torch.multinomial(a, 2)
            return a, b, c, d, e, f, g
        """, HOT, "rng-discipline", 7, "generator="),
    ("torch_draws_with_generator_are_clean", """
        import torch

        def draw(n, seed, dev):
            gen = torch.Generator(device=dev).manual_seed(seed)
            a = torch.rand(n, generator=gen, device=dev)
            b = torch.randint(0, 5, (n,), generator=gen)
            return a, b, torch.multinomial(a, 2, generator=gen)
        """, HOT, "rng-discipline", 0, ""),
    # dtype-discipline
    ("dtypeless_torch_ctors_in_engine_module", """
        import torch

        def table(n):
            a = torch.zeros(n, n)
            b = torch.empty((n,))
            c = torch.full((n,), float("-inf"))
            d = torch.tensor([1.0, 2.0])
            e = torch.ones(n)
            return a, b, c, d, e
        """, HOT, "dtype-discipline", 5, "float32"),
    ("dtyped_torch_ctors_are_clean", """
        import torch

        def table(n, x):
            a = torch.zeros(n, n, dtype=torch.float64)
            b = torch.full((n,), float("-inf"), dtype=torch.float64)
            return a, b, x.new_zeros((n,)), torch.tensor([1], dtype=torch.int64)
        """, HOT, "dtype-discipline", 0, ""),
    ("torch_f32_in_masked_consensus", """
        import torch

        def masked_consensus(A, mask):
            return (A * mask).to(torch.float32)
        """, "src/repro_torch/fed/snippet.py", "dtype-discipline", 1, "bit-identity"),
    ("float_method_in_migration", """
        def migrate_silo_state(state, idx):
            return state[idx].float()
        """, "src/repro_torch/fed/snippet.py", "dtype-discipline", 1, ".float()"),
    ("f64_migration_is_clean", """
        import torch

        def migrate_silo_state(state, idx):
            return state[idx].to(torch.float64)
        """, "src/repro_torch/fed/snippet.py", "dtype-discipline", 0, ""),
    # effect-purity: *_torch twins, and the torch advice
    ("print_in_torch_twin", """
        def cycle_time_torch(w):
            print("pricing")
            return w.max()
        """, HOT, "effect-purity", 1, "capture time"),
    ("clock_in_jax_named_function_is_not_a_port_twin", """
        import time

        def cycle_time_jax(w):
            return w.max(), time.perf_counter()
        """, HOT, "effect-purity", 0, ""),
    ("loop_sync_advice", """
        def drive(step_fn, xs):
            out = []
            for x in xs:
                out.append(step_fn(x).item())
            return out
        """, HOT, "effect-purity", 1, ".tolist() of a stacked tensor"),
    # sentinel-discipline: the port's sentinel is MISSING
    ("missing_equality", """
        from repro_torch.core.maxplus_vec import MISSING

        def absent(w):
            return w == MISSING
        """, HOT, "sentinel-discipline", 1, "missing_mask"),
    ("missing_redefinition", """
        MISSING = float("-inf")
        """, HOT, "sentinel-discipline", 1, "maxplus_vec.MISSING"),
    ("missing_home_is_clean", """
        MISSING = float("-inf")
        NEG_INF = MISSING
        """, "src/repro_torch/core/maxplus_vec.py", "sentinel-discipline", 0, ""),
]


@pytest.mark.parametrize("src,path,rule,count,fragment",
                         [pytest.param(*c[1:], id=c[0]) for c in IDIOMS])
def test_torch_idiom(src, path, rule, count, fragment):
    vs = [v for v in PL.lint_source(textwrap.dedent(src), path=path, config=ENGINE)
          if v.rule == rule]
    assert len(vs) == count, [v.render() for v in vs]
    assert all(fragment in v.message for v in vs), [v.message for v in vs]


def test_traced_view_is_built_from_the_linted_package_only():
    """A reference module that jits a function of the same name does not
    mark the port's function traced; a port module that compiles it does."""
    lib = textwrap.dedent("""
        def local_sgd_steps(x):
            return float(x)
        """)
    ref_caller = ("src/repro/fed/step.py", "import jax\njitted = jax.jit(local_sgd_steps)\n")
    port_caller = ("src/repro_torch/fed/step.py",
                   "import torch\nfast = torch.compile(local_sgd_steps)\n")
    path = "src/repro_torch/fed/dpasgd_snippet.py"
    vs = PL.lint_source(lib, path=path, extra_files=[ref_caller])
    assert "trace-safety" not in {v.rule for v in vs}
    vs = PL.lint_source(lib, path=path, extra_files=[port_caller])
    assert "trace-safety" in {v.rule for v in vs}
    # the reference's view is project-wide and keyed on bare names
    vs = RL.lint_source(lib, path="src/repro/fed/dpasgd_snippet.py", extra_files=[ref_caller])
    assert "trace-safety" in {v.rule for v in vs}


def test_engine_contract_rule_covers_the_six_modules():
    cfg = PL.LintConfig()
    assert cfg.engine_modules == tuple(f"src/repro_torch/{m}" for m in ENGINE_MODULES)
    src = "def batched_frobnicate(W):\n    return W\n"
    for mod in cfg.engine_modules:
        assert [v.rule for v in PL.lint_source(src, path=mod)] == ["engine-contract"]
    assert PL.lint_source(src, path="src/repro_torch/core/topologies.py") == []


# ---------------------------------------------------------------------------
# The tree: baseline, reasons, and the reference's gate


@functools.lru_cache(maxsize=None)
def _port_tree_violations():
    return tuple(PL.lint_paths(PL.default_paths(str(REPO)), root=str(REPO)))


def test_port_lint_of_the_tree_is_clean_against_its_baseline():
    vs = _port_tree_violations()
    baseline = PL.load_baseline(PL.DEFAULT_BASELINE)
    fresh = [v.render() for v in vs if v.fingerprint() not in baseline]
    assert fresh == []
    stale = baseline - {v.fingerprint() for v in vs}
    assert stale == set()


def test_every_baseline_entry_has_a_reason():
    baseline = PL.load_baseline(PL.DEFAULT_BASELINE)
    reasons = PL.baseline_reasons(PL.DEFAULT_BASELINE)
    assert baseline and set(reasons) == baseline
    assert all(len(r) > 20 for r in reasons.values())


def test_default_paths_cover_the_port_its_tests_and_chip_smoke():
    paths = [os.path.relpath(p, REPO) for p in PL.default_paths(str(REPO))]
    assert paths[0] == os.path.join("src", "repro_torch")
    assert "chip_smoke.py" in paths
    assert os.path.join("tests", "test_torch_analysis.py") in paths
    assert not any(os.path.basename(p) == "test_lint_rules.py" for p in paths)


def test_reference_gate_finds_nothing_new_in_the_port():
    vs = RL.lint_paths([str(REPO / "src" / "repro_torch")], root=str(REPO))
    baseline = RL.load_baseline(str(REPO / "scripts" / "lint_baseline.txt"))
    assert [v.render() for v in vs if v.fingerprint() not in baseline] == []


def test_cli_reports_new_violations_and_rewrites_the_baseline(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\ntorch.manual_seed(0)\n")
    base = tmp_path / "baseline.txt"
    argv = [str(bad), "--root", str(tmp_path), "--baseline", str(base), "--no-cache"]
    assert PL.main(argv) == 1
    assert "[rng-discipline]" in capsys.readouterr().out
    assert PL.main(argv + ["--update-baseline"]) == 0
    text = base.read_text()
    base.write_text(text.replace("src/repro_torch/core/bad.py::",
                                 "# why: a test fixture\nsrc/repro_torch/core/bad.py::"))
    assert PL.main(argv) == 0
    assert PL.main(argv + ["--update-baseline"]) == 0
    assert "# why: a test fixture" in base.read_text()


# ---------------------------------------------------------------------------
# @contract on the engine modules


def _module_pairs():
    out = []
    for rel in ENGINE_MODULES:
        name = rel[:-3].replace("/", ".")
        out.append((rel, importlib.import_module(f"repro_torch.{name}"),
                    importlib.import_module(f"repro.{name}")))
    return out


def _public_functions(mod):
    tree = ast.parse(Path(mod.__file__).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


#: a port-only twin -> the reference function whose spec it takes
TWINS = {
    "batched_cycle_time_sparse_torch": "batched_cycle_time_sparse_jax",
    "timing_recursion_unique_rounds_sparse_torch": "timing_recursion_unique_rounds_sparse",
    "batched_rho_torch": "batched_rho_jax",
    "batched_spectral_gap_torch": "batched_spectral_gap_jax",
    "edge_segment_max_ref": "edge_segment_max_pallas",
    "edge_segment_max_cuda": "edge_segment_max_pallas",
}


def _spec_cases():
    cases = []
    for rel, port, ref in _module_pairs():
        for name in _public_functions(port):
            ref_name = name if hasattr(ref, name) else TWINS.get(name)
            cases.append(pytest.param(rel, name, ref_name, id=f"{rel}:{name}"))
    return cases


SPEC_CASES = _spec_cases()


def test_spec_cases_cover_all_engine_functions():
    # 75, the timing kernel's layout rule: timing_smem_bytes, timing_plan,
    # timing_plan_on_card; the standalone segment max's: segment_max_plan,
    # segment_max_layouts, segment_max_plan_on_card; and reachability's:
    # reach_plan, reach_layouts, reach_plan_on_card
    assert len(SPEC_CASES) == 84


@pytest.mark.parametrize("rel,name,ref_name", SPEC_CASES)
def test_engine_function_contract(rel, name, ref_name):
    mod = rel[:-3].replace("/", ".")
    port = getattr(importlib.import_module(f"repro_torch.{mod}"), name)
    assert hasattr(port, "__contract__"), f"{rel}:{name} has no @contract"
    if ref_name is None:  # port-only: written from its hand-rolled checks
        assert rel == "kernels/segment_max.py", name
        return
    ref = getattr(importlib.import_module(f"repro.{mod}"), ref_name)
    assert port.__contract__ == ref.__contract__


def test_the_reference_switch_turns_the_port_checks_on():
    """``tests/conftest.py`` sets ``REPRO_CHECK_CONTRACTS=1`` unless the
    caller chose; the port reads the reference's variable."""
    assert 'setdefault("REPRO_CHECK_CONTRACTS", "1")' in (REPO / "tests" / "conftest.py").read_text()
    assert contracts.checking_enabled() == (os.environ.get("REPRO_CHECK_CONTRACTS") == "1")


@pytest.fixture
def checking_on():
    was = contracts.checking_enabled()
    contracts.enable()
    yield
    (contracts.enable if was else contracts.disable)()


class TestContractSemantics:
    """The reference's decorator semantics (tests/test_lint_rules.py),
    on the port's stdlib copy and on tensors."""

    def test_matching_call_passes(self, checking_on):
        @contract("[B,N,N]", ret="[B]")
        def f(W):
            return torch.zeros(W.shape[0])

        assert f(torch.zeros((3, 4, 4))).shape == (3,)

    def test_rank_mismatch_raises(self, checking_on):
        @contract("[B,N,N]")
        def f(W):
            return W

        with pytest.raises(ContractError, match="f: argument 'W'"):
            f(torch.zeros((3, 4)))

    def test_dim_binding_across_arguments(self, checking_on):
        @contract("[B,N,N]", "[B,N]")
        def f(W, t0):
            return W

        f(np.zeros((2, 3, 3)), torch.zeros((2, 3)))
        with pytest.raises(ContractError, match="t0"):
            f(np.zeros((2, 3, 3)), torch.zeros((2, 4)))

    def test_return_contract_checked(self, checking_on):
        @contract("[B,N,N]", ret="[B]")
        def f(W):
            return torch.zeros(W.shape[0] + 1)

        with pytest.raises(ContractError, match="return value"):
            f(torch.zeros((3, 4, 4)))

    def test_alternation_and_ellipsis(self, checking_on):
        @contract("[B,N,N]|[N,N]", "[...,N]")
        def f(W, v):
            return W

        f(torch.zeros((2, 3, 3)), torch.zeros(3))
        f(torch.zeros((3, 3)), torch.zeros((5, 2, 3)))
        with pytest.raises(ContractError):
            f(torch.zeros((3,)), torch.zeros(3))

    def test_optional_spec_skips_none(self, checking_on):
        @contract("[B,N,N]", "*[B,N]")
        def f(W, t0=None):
            return W

        f(torch.zeros((2, 3, 3)))
        f(torch.zeros((2, 3, 3)), torch.zeros((2, 3)))
        with pytest.raises(ContractError):
            f(torch.zeros((2, 3, 3)), torch.zeros((9, 3)))

    def test_expression_dims(self, checking_on):
        @contract("[N,N]", "R", ret="[R+1,N]")
        def f(W, rounds):
            return torch.zeros((rounds + 1, W.shape[0]))

        f(torch.zeros((4, 4)), 7)

        @contract("[N,N]", "R", ret="[R+1,N]")
        def g(W, rounds):
            return torch.zeros((rounds + 2, W.shape[0]))

        with pytest.raises(ContractError):
            g(torch.zeros((4, 4)), 7)

    def test_seqlen_and_scalar_specs(self, checking_on):
        @contract("#E", "N")
        def f(edges, n):
            return len(edges), n

        f([(0, 1), (1, 0)], 2)
        with pytest.raises(ContractError, match="static Python int"):
            f([(0, 1)], np.zeros((2, 2)))

    def test_edgebatch_expression_uses_num_nodes(self, checking_on):
        @contract("eb[B,E,N]", ret="eb[B,E+N,N]")
        def pad(eb):
            b, e = eb.src.shape
            n = eb.num_nodes
            z = torch.zeros((b, e + n), dtype=torch.int32)
            return SimpleNamespace(src=z, dst=z, w=torch.zeros((b, e + n)), num_nodes=n)

        eb = SimpleNamespace(src=torch.zeros((2, 5), dtype=torch.int32),
                             dst=torch.zeros((2, 5), dtype=torch.int32),
                             w=torch.zeros((2, 5)), num_nodes=4)
        assert pad(eb).src.shape == (2, 9)

    def test_disabled_mode_skips_checks(self):
        was = contracts.checking_enabled()
        contracts.disable()
        try:
            @contract("[B,N,N]")
            def f(W):
                return W

            assert f(torch.zeros((3,))).shape == (3,)
        finally:
            (contracts.enable if was else contracts.disable)()

    def test_bad_spec_fails_at_decoration_time(self):
        with pytest.raises(ValueError):
            @contract("[B,N,N")
            def f(W):
                return W

    def test_contract_record_on_the_wrapper(self):
        @contract("[N,N]", "R", ret="[R+1,N]", t0="*[N]")
        def f(W, rounds, t0=None):
            return W

        assert f.__contract__ == {"args": ("[N,N]", "R"), "kwargs": {"t0": "*[N]"},
                                  "ret": "[R+1,N]"}
        assert f.__wrapped__.__name__ == "f"


def test_checked_calls_are_counted_and_an_empty_contract_checks_nothing(checking_on):
    """``CHECKED_CALLS`` counts the calls checked against a spec: none for
    a ``@contract()`` (the per-arc delay functions) and none with checks
    off."""
    @contract("[N]")
    def f(v):
        return v

    @contract()
    def g(v):
        return v

    c0 = contracts.CHECKED_CALLS
    f(torch.zeros(3))
    g(torch.zeros(3))
    assert contracts.CHECKED_CALLS == c0 + 1
    contracts.disable()
    f(torch.zeros(3))
    assert contracts.CHECKED_CALLS == c0 + 1


def test_wrong_rank_cpu_tensor_names_function_and_argument(checking_on):
    from repro_torch.core.maxplus_sparse import batched_cycle_time_sparse_torch
    from repro_torch.kernels.segment_max import karp_cycle_time_ref

    src = torch.zeros((2, 5), dtype=torch.int32)
    w = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ContractError, match=r"batched_cycle_time_sparse_torch: argument 'w'"):
        batched_cycle_time_sparse_torch(src, src, w[0], 3)
    with pytest.raises(ContractError, match=r"karp_cycle_time_ref: argument 'dst'"):
        karp_cycle_time_ref(src, src[:, :4], w, 3)
    with pytest.raises(ContractError, match=r"timing_recursion_ref: argument 'round_ids'"):
        from repro_torch.kernels.segment_max import timing_recursion_ref
        timing_recursion_ref(src[0], src[0], w, torch.zeros(4, dtype=torch.int32), 3)
    # a ContractError is a TypeError only, as the reference's: a caller
    # that skips a candidate on ValueError does not swallow it
    assert issubclass(ContractError, TypeError) and not issubclass(ContractError, ValueError)


def test_edge_batch_whose_fields_disagree_is_refused(checking_on):
    from repro_torch.core.maxplus_sparse import EdgeBatch, batched_cycle_time_sparse

    eb = EdgeBatch(np.zeros((2, 5), dtype=np.int32), np.zeros((2, 6), dtype=np.int32),
                   np.zeros((2, 5)), 4)
    with pytest.raises(ContractError, match=r"batched_cycle_time_sparse: argument 'eb'.*disagree"):
        batched_cycle_time_sparse(eb)


class _NoArray(torch.Tensor):
    """A tensor that fails the test if anything converts it to an array."""

    def __array__(self, *args, **kwargs):
        raise AssertionError("the contract checker converted a tensor to an array")


def test_checker_never_converts_a_tensor(checking_on):
    @contract("[B,N]", "#K", "[K,N]", "N", ret="[B]")
    def f(x, seq, stack, n):
        return x[:, 0]

    x = torch.zeros((3, 4)).as_subclass(_NoArray)
    rows = [torch.zeros(4).as_subclass(_NoArray) for _ in range(2)]
    assert f(x, rows, rows, 4).shape == (3,)
    with pytest.raises(ContractError, match="argument 'stack'"):
        f(x, rows, [rows[0], torch.zeros(5).as_subclass(_NoArray)], 4)
    with pytest.raises(ContractError, match="static Python int, not a tensor"):
        f(x, rows, rows, torch.tensor(4))

    @contract("[N]")
    def g(v):
        return v

    with pytest.raises(ContractError, match="no shape"):
        g(SimpleNamespace(__array__=lambda: np.zeros(3)))


def test_sequence_shapes_match_numpy():
    from repro_torch.analysis.contracts import _shape_of

    for value in ([], [1.0, 2.0], [[1, 2], [3, 4], [5, 6]], ((0.5,),), [np.zeros((2, 3))] * 4,
                  ["a", "b"], [[], []]):
        assert _shape_of(value) == np.shape(value)
    assert _shape_of([[1, 2], [3]]) is None


# ---------------------------------------------------------------------------
# Recompile guards: the eager step is built once, a library once


N_SILOS = 4
N_ROUNDS = 12


def _tiny():
    from repro_torch.models.config import ModelConfig

    return ModelConfig(arch_id="tiny", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                       d_ff=128, vocab_size=256, n_silos=N_SILOS)


def _matcha_slot():
    from repro_torch.core import MatchaSchedule
    from repro_torch.fed import ScheduleSlot

    sched = MatchaSchedule(matchings=(((0, 1), (2, 3)), ((1, 2), (0, 3)), ((0, 2),)),
                           budget=0.5)
    return ScheduleSlot(sched, N_SILOS)


def test_consensus_step_builds_once_across_sampled_rounds():
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.fed import DPASGDConfig, init_state, make_train_step
    from repro_torch.launch.train import batch_to_device
    from repro_torch.optim import sgd

    torch.set_num_threads(1)
    cfg = _tiny()
    fed = DPASGDConfig(local_steps=1, gossip_impl="einsum")
    opt = sgd(0.1)
    counter = TraceCounter(make_train_step, name="make_train_step")
    step_fn = counter(cfg, fed, opt, None, consensus_arg=True)
    state = init_state(cfg, opt, device="cpu")
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, 16, n_silos=N_SILOS),
                               local_steps=1, batch_per_silo=2)
    slot = _matcha_slot()
    seen = set()
    for k in range(N_ROUNDS):
        A = slot.matrix_for_round(k)
        seen.add(tuple(np.asarray(A).ravel().tolist()))
        state, aux = step_fn(state, batch_to_device(batcher.batch(k), torch.device("cpu")), A)
    assert len(seen) >= 2, "MATCHA sampling degenerated to one matrix"
    assert counter.count == 1
    assert_max_traces(counter)
    assert np.isfinite(float(aux["loss"]))


def test_launcher_builds_the_step_once_over_sampled_rounds(monkeypatch):
    import repro_torch.launch.train as T

    torch.set_num_threads(1)
    counter = TraceCounter(T.make_train_step, name="make_train_step")
    monkeypatch.setattr(T, "make_train_step", counter)
    result = T.train(_tiny(), silos=N_SILOS, designer="matcha", steps=N_ROUNDS, local_steps=1,
                     batch_per_silo=2, seq_len=16, device="cpu", log=lambda *_: None)
    assert len(result.consensus) == N_ROUNDS
    assert len({np.asarray(A).tobytes() for A in result.consensus}) >= 2
    assert counter.count == 1
    assert all(np.isfinite(result.losses))


def test_assert_max_traces_reports_a_rebuild():
    counter = TraceCounter(lambda x: x + 1, name="toy")
    counter(1)
    counter(2)
    assert counter.count == 2
    with pytest.raises(AssertionError, match="toy"):
        assert_max_traces(counter, limit=1)
    counter.reset()
    assert counter.count == 0


def test_a_kernel_library_is_built_and_loaded_once(monkeypatch, tmp_path):
    """``build_all`` skips a library that exists and ``load_library`` is
    cached: a process builds and loads each library at most once."""
    from repro_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = "-o" ]; then shift; '
                    'echo lib > "$1"; fi\n  shift\ndone\n')
    nvcc.chmod(0o755)
    loads = []
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILDS", {})
    monkeypatch.setattr(_build, "LOADS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loads.append(path) or path)
    _build.load_library.cache_clear()
    try:
        assert set(_build.build_all(["segment_max"])) == {"segment_max"}
        assert _build.build_all(["segment_max"]) == {}
        for _ in range(3):
            _build.load_library("segment_max")
        assert _build.BUILDS == {"segment_max": 1} and _build.LOADS == {"segment_max": 1}
        assert len(loads) == 1
    finally:
        _build.load_library.cache_clear()


# ---------------------------------------------------------------------------
# A fix the lint asked for changes no number


def test_perf_gossip_digest_reads_once_and_keeps_its_numbers(monkeypatch):
    import repro_torch.launch.perf_gossip as PG

    monkeypatch.setattr(PG, "DIGEST_CHUNK", 7)
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(50).astype(np.float32))
    bits, total = 0, 0.0
    for lo in range(0, 50, 7):  # the chunk-by-chunk reads it replaced
        part = t[lo:lo + 7]
        bits += int(part.view(torch.int32).sum(dtype=torch.int64))
        total += float(part.sum(dtype=torch.float64))
    assert PG.digest(t) == (bits, total)
    assert PG.digest(t[:0]) == (0, 0.0)
