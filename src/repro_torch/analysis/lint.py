"""repro-lint for the port: AST-based static checks of the project's
invariants over ``src/repro_torch`` (the reference's
``repro/analysis/lint.py`` with every home moved to the port).

The port's headline claims — bit-identical engine equivalence with the
reference, deterministic MATCHA sampling, "sampled topologies never
rebuild the step" — rest on conventions nothing in CPython enforces: no
host syncs inside captured or differentiated bodies, no ambient RNG
state, no arithmetic on the ``-inf`` sentinel, f64-only bit-identity
paths, and a shape contract on every engine entry point.  This module
parses the tree once, shares a cross-file view of which functions run
under tracing, and runs each rule in ``repro_torch.analysis.rules`` over
every file.

The traced view is PyTorch's: the ``forward``/``backward`` bodies of
``torch.autograd.Function`` subclasses, functions handed to the
``torch.func`` transforms, ``torch.compile`` or
``torch.cuda.make_graphed_callables``, functions called inside a ``with
torch.cuda.graph(...)`` capture, and what those call in the same file.
It is built from the linted package's own files only (and bare snippets),
so a reference function that shares a name with a port function never
marks the port's as traced.

Run it as ``python -m repro_torch.analysis.lint [paths] [--changed]
[--update-baseline] [--no-cache]``; by default it lints
``src/repro_torch``, ``tests/test_torch_*.py`` and ``chip_smoke.py``.

Grandfathering: ``src/repro_torch/analysis/lint_baseline.txt`` holds
fingerprints of pre-existing violations.  Fingerprints are line-number independent
(path, rule, enclosing function, stripped source line) so unrelated
edits do not invalidate the baseline.  New violations fail the run;
``--update-baseline`` rewrites the file.

Inline suppression: append ``# repro-lint: ignore`` (or
``ignore[rule-id]``) to the offending line.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import subprocess
import sys
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["LintConfig", "Violation", "FileCtx", "Project", "lint_paths",
           "lint_files", "lint_source", "load_baseline", "baseline_reasons",
           "write_baseline", "default_paths", "changed_paths", "main",
           "DEFAULT_BASELINE"]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LintConfig:
    """Project layout knobs consumed by the rules."""

    # Modules whose loops/jitted bodies are throughput-critical: host
    # syncs there are flagged.
    hot_prefixes: Tuple[str, ...] = (
        "src/repro_torch/core/", "src/repro_torch/fed/",
        "src/repro_torch/dynamics/", "src/repro_torch/kernels/",
        "src/repro_torch/launch/", "src/repro_torch/models/")
    # The engine modules: dtype-less constructions are flagged and
    # every public function must carry a @contract.
    engine_modules: Tuple[str, ...] = (
        "src/repro_torch/core/maxplus_vec.py",
        "src/repro_torch/core/maxplus_sparse.py",
        "src/repro_torch/core/delays.py",
        "src/repro_torch/core/schedule.py",
        "src/repro_torch/core/mixing.py",
        "src/repro_torch/kernels/segment_max.py")
    # The one module allowed to define the -inf sentinel.
    sentinel_home: str = "src/repro_torch/core/maxplus_vec.py"
    sentinel_names: Tuple[str, ...] = ("NEG_INF", "_NEG_INF", "MISSING")
    # Functions on the bit-identity consensus/migration path: any f32
    # mention inside them is a violation.
    bit_identity_funcs: Tuple[str, ...] = (
        "migrate_silo_state", "masked_consensus")
    # np.random attributes that thread explicit state and are allowed.
    allowed_np_random: Tuple[str, ...] = (
        "default_rng", "Generator", "SeedSequence", "BitGenerator",
        "PCG64", "Philox")
    # numpy attributes that are trace-time constants, not host syncs.
    np_trace_constants: Tuple[str, ...] = (
        "float16", "float32", "float64", "int8", "int16", "int32",
        "int64", "uint8", "uint32", "bool_", "dtype", "newaxis", "pi",
        "inf", "nan", "e", "ndarray", "integer", "floating", "shape",
        "ndim")
    # The linted package: only its files (and bare snippets) feed the
    # project-wide traced view.
    package_prefix: str = "src/repro_torch/"


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str        # repo-relative, forward slashes
    line: int
    col: int
    message: str
    func: str        # enclosing qualname or "<module>"
    line_text: str

    def fingerprint(self) -> str:
        return "::".join(
            (self.path, self.rule, self.func, self.line_text.strip()))

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}")


@dataclass
class Project:
    """Cross-file facts shared with every rule."""

    # Bare names handed to torch tracing entry points anywhere in the
    # linted package: torch.func transforms, torch.compile,
    # make_graphed_callables, calls inside a torch.cuda.graph capture.
    traced_root_names: Set[str] = field(default_factory=set)


@dataclass
class FileCtx:
    path: str
    tree: ast.Module
    lines: List[str]
    config: LintConfig
    project: Project
    # node -> enclosing function qualname ("<module>" at top level)
    func_of: Dict[ast.AST, str] = field(default_factory=dict)
    # node -> innermost enclosing FunctionDef (None at module level)
    def_of: Dict[ast.AST, Optional[ast.AST]] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def violation(self, rule: str, node: ast.AST, message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Violation(rule=rule, path=self.path, line=line, col=col,
                         message=message,
                         func=self.func_of.get(node, "<module>"),
                         line_text=self.line_text(line))


# ---------------------------------------------------------------------------
# AST helpers shared by the rules
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'np.random.default_rng' for nested Attribute/Name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: ``torch.func`` transforms (and their ``torch.*`` aliases): the first
#: positional argument runs under functorch tracing.
_FUNC_TRANSFORMS = {"vmap", "grad", "grad_and_value", "jacrev", "jacfwd",
                    "hessian", "vjp", "jvp", "linearize", "functionalize",
                    "functional_call"}
#: Methods of an ``autograd.Function`` that autograd runs as its graph.
_AUTOGRAD_METHODS = {"forward", "backward", "setup_context", "jvp", "vmap"}
_KNOWN_FILE_PREFIXES = ("src/", "tests/", "benchmarks/", "scripts/",
                        "examples/", "docs/", "chip_smoke.py")


def _torch_aliases(tree: ast.Module) -> Dict[str, str]:
    """Bare local name -> qualified torch name for ``from torch... import``
    bindings (``from torch.func import vmap as v`` -> {"v":
    "torch.func.vmap"})."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch" or node.module.startswith("torch.")):
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    node.module + "." + alias.name)
    return out


def _qualified(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in aliases:
        return aliases[head] + ("." + rest if rest else "")
    return name


def _tracing_entry(qual: str) -> bool:
    """Does this callee trace (or capture) its first argument?"""
    parts = qual.split(".")
    leaf = parts[-1]
    if parts[0] != "torch":
        return False
    if leaf == "compile" and len(parts) == 2:
        return True
    if leaf == "make_graphed_callables":
        return True
    return leaf in _FUNC_TRANSFORMS and (
        len(parts) == 2 or parts[1] == "func")


def _is_graph_capture(qual: Optional[str]) -> bool:
    return qual is not None and qual.split(".")[0] == "torch" and \
        qual.rsplit(".", 1)[-1] == "graph" and ".cuda." in qual + "."


def _decorator_traces(dec: ast.AST, aliases: Dict[str, str]) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    qual = _qualified(target, aliases)
    if qual is not None and _tracing_entry(qual):
        return True
    if isinstance(dec, ast.Call) and qual and \
            qual.rsplit(".", 1)[-1] == "partial" and dec.args:
        # functools.partial(torch.compile, mode=...)
        inner = _qualified(dec.args[0], aliases)
        return inner is not None and _tracing_entry(inner)
    return False


def collect_traced_roots(tree: ast.Module) -> Set[str]:
    """Bare function names handed to torch tracing entry points, or
    called by bare name inside a ``torch.cuda.graph`` capture."""
    aliases = _torch_aliases(tree)
    roots: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            qual = _qualified(node.func, aliases)
            if qual is not None and _tracing_entry(qual) and node.args \
                    and isinstance(node.args[0], ast.Name):
                roots.add(node.args[0].id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call)
                   and _is_graph_capture(_qualified(
                       item.context_expr.func, aliases))
                   for item in node.items):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                isinstance(sub.func, ast.Name):
                            roots.add(sub.func.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _decorator_traces(dec, aliases):
                    roots.add(node.name)
    return roots


def _is_autograd_function(cls: ast.ClassDef,
                          aliases: Dict[str, str]) -> bool:
    for base in cls.bases:
        qual = _qualified(base, aliases)
        if qual is None:
            continue
        if qual in ("torch.autograd.Function",
                    "torch.autograd.function.Function") or \
                qual.endswith("autograd.Function"):
            return True
    return False


def traced_functions(ctx: FileCtx) -> Set[ast.AST]:
    """FunctionDefs in this file that execute under torch tracing.

    Seeds: the ``forward``/``backward`` (and ``setup_context``/``jvp``/
    ``vmap``) methods of ``autograd.Function`` subclasses, defs whose
    name is a traced root of the linted package, and defs carrying a
    ``torch.compile``/``torch.func`` decorator.  Closure: defs nested
    inside a traced def, and defs called by bare name from an
    already-traced def in the same file.
    """
    aliases = _torch_aliases(ctx.tree)
    defs: List[ast.AST] = [n for n in ast.walk(ctx.tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
    by_name: Dict[str, List[ast.AST]] = {}
    for d in defs:
        by_name.setdefault(d.name, []).append(d)
    # Methods are handed to tracing entry points as `self.f` (an
    # Attribute), never by bare name — exclude them from name-based
    # seeding or every method that shares a name with a traced helper
    # goes traced.
    methods: Set[ast.AST] = set()
    traced: Set[ast.AST] = set()
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        autograd = _is_autograd_function(cls, aliases)
        for d in cls.body:
            if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods.add(d)
                if autograd and d.name in _AUTOGRAD_METHODS:
                    traced.add(d)

    for d in defs:
        if d.name in ctx.project.traced_root_names and d not in methods:
            traced.add(d)
        elif any(_decorator_traces(dec, aliases)
                 for dec in d.decorator_list):
            traced.add(d)

    def _mark_nested(d: ast.AST) -> None:
        for child in ast.walk(d):
            if child is not d and isinstance(child, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef)):
                traced.add(child)

    changed = True
    while changed:
        changed = False
        for d in list(traced):
            before = len(traced)
            _mark_nested(d)
            for node in ast.walk(d):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)):
                    for cand in by_name.get(node.func.id, ()):
                        traced.add(cand)
            if len(traced) != before:
                changed = True
    return traced


def feeds_traced_view(path: str, config: LintConfig) -> bool:
    """Only the linted package's own files (and bare snippets) name
    traced roots."""
    return path.startswith(config.package_prefix) or \
        not path.startswith(_KNOWN_FILE_PREFIXES)


def body_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a FunctionDef body without descending into nested defs
    (nested defs are analysed as their own traced functions)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*ignore(?:\[([\w\s,-]*)\])?")


def _suppressed(ctx: FileCtx, v: Violation) -> bool:
    m = _SUPPRESS_RE.search(ctx.line_text(v.line))
    if not m:
        return False
    rules = m.group(1)
    if rules is None:
        return True
    return v.rule in {r.strip() for r in rules.split(",") if r.strip()}


def _build_maps(ctx: FileCtx) -> None:
    def visit(node: ast.AST, qual: str, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_qual = child.name if qual == "<module>" else (
                    qual + "." + child.name)
                ctx.func_of[child] = qual
                ctx.def_of[child] = fn
                visit(child, child_qual, child)
            else:
                if isinstance(child, ast.ClassDef):
                    child_qual = child.name if qual == "<module>" else (
                        qual + "." + child.name)
                    ctx.func_of[child] = qual
                    ctx.def_of[child] = fn
                    visit(child, child_qual, fn)
                else:
                    ctx.func_of[child] = qual
                    ctx.def_of[child] = fn
                    visit(child, qual, fn)

    visit(ctx.tree, "<module>", None)


def _all_rules():
    from .rules import ALL_RULES

    return [cls() for cls in ALL_RULES]


def _norm(path: str, root: Optional[str]) -> str:
    if root:
        try:
            path = os.path.relpath(path, root)
        except ValueError:
            pass
    return path.replace(os.sep, "/")


def _parse_ctxs(files: Sequence[Tuple[str, str]], config: LintConfig,
                ) -> Tuple[List[FileCtx], List[Violation]]:
    """Parse every file and build the shared cross-file Project view.

    Parsing is the cheap phase (fractions of a second for the whole
    tree) and MUST cover every file even when only a subset is checked:
    ``traced_root_names`` is a package-wide fact — a function compiled
    from another module is traced no matter which files changed."""
    project = Project()
    ctxs: List[FileCtx] = []
    violations: List[Violation] = []
    for path, src in files:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as exc:
            violations.append(Violation(
                rule="parse", path=path, line=exc.lineno or 1,
                col=exc.offset or 0, message=f"syntax error: {exc.msg}",
                func="<module>", line_text=""))
            continue
        ctx = FileCtx(path=path, tree=tree, lines=src.splitlines(),
                      config=config, project=project)
        _build_maps(ctx)
        if feeds_traced_view(path, config):
            project.traced_root_names |= collect_traced_roots(tree)
        ctxs.append(ctx)
    return ctxs, violations


def _check_ctx(ctx: FileCtx, rules: Sequence) -> List[Violation]:
    out: List[Violation] = []
    for rule in rules:
        for v in rule.check(ctx):
            if not _suppressed(ctx, v):
                out.append(v)
    return out


def lint_files(files: Sequence[Tuple[str, str]],
               config: Optional[LintConfig] = None) -> List[Violation]:
    """Lint (path, source) pairs sharing one cross-file view."""
    config = config or LintConfig()
    ctxs, violations = _parse_ctxs(files, config)
    rules = _all_rules()
    for ctx in ctxs:
        violations.extend(_check_ctx(ctx, rules))
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations


def lint_source(src: str, path: str = "snippet.py",
                config: Optional[LintConfig] = None,
                extra_files: Optional[Sequence[Tuple[str, str]]] = None,
                ) -> List[Violation]:
    """Lint one source string (the test-suite entry point)."""
    files = list(extra_files or []) + [(path, src)]
    return [v for v in lint_files(files, config) if v.path == path]


def iter_py_files(paths: Sequence[str], root: Optional[str] = None,
                  ) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    out.append(os.path.join(dirpath, fname))
    return out


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               config: Optional[LintConfig] = None) -> List[Violation]:
    files = []
    for fpath in iter_py_files(paths, root):
        with open(fpath, "r", encoding="utf-8") as fh:
            files.append((_norm(fpath, root), fh.read()))
    return lint_files(files, config)


# ---------------------------------------------------------------------------
# Incremental mode: hash-keyed result cache + git changed-file selection
# ---------------------------------------------------------------------------

_CACHE_NAME = ".repro_torch_lint_cache.json"


def _rules_digest() -> str:
    """Hash of the analysis package's own sources.

    Any edit to a rule, the engine, dataflow, or the protocol machines
    changes this digest and invalidates every cached result — a stale
    verdict from an older linter must never survive."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                h.update(fname.encode("utf-8"))
                with open(os.path.join(dirpath, fname), "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def lint_paths_cached(paths: Sequence[str], root: Optional[str] = None,
                      config: Optional[LintConfig] = None,
                      cache_path: Optional[str] = None,
                      only: Optional[Set[str]] = None,
                      ) -> Tuple[List[Violation], int, int]:
    """Like :func:`lint_paths` with per-file result caching.

    Every file is still *parsed* (the cross-file traced-roots view must
    be complete) but rules re-run only for files whose content hash
    missed the cache.  The cache carries a context digest over the
    analysis package sources, the config, and the project traced-root
    set, so a rule edit — or an edit anywhere that changes which
    functions are traced — invalidates everything at once rather than
    serving unsound per-file hits.

    ``only`` restricts which repo-relative paths contribute violations
    (and cache refreshes) — the ``--changed`` mode.  Returns
    ``(violations, checked, cached)``.
    """
    config = config or LintConfig()
    files = []
    for fpath in iter_py_files(paths, root):
        with open(fpath, "r", encoding="utf-8") as fh:
            files.append((_norm(fpath, root), fh.read()))
    src_of = dict(files)
    ctxs, violations = _parse_ctxs(files, config)

    digest = hashlib.sha256()
    digest.update(_rules_digest().encode("utf-8"))
    digest.update(repr(config).encode("utf-8"))
    digest.update(",".join(
        sorted(ctxs[0].project.traced_root_names) if ctxs else []
        ).encode("utf-8"))
    context_digest = digest.hexdigest()

    cached_files: Dict[str, dict] = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path, "r", encoding="utf-8") as fh:
                on_disk = json.load(fh)
            if on_disk.get("digest") == context_digest:
                cached_files = on_disk.get("files", {})
        except (ValueError, OSError):
            cached_files = {}

    rules = None
    next_files: Dict[str, dict] = {}
    checked = cached = 0
    for ctx in ctxs:
        if only is not None and ctx.path not in only:
            continue
        file_hash = hashlib.sha256(
            src_of[ctx.path].encode("utf-8")).hexdigest()
        entry = cached_files.get(ctx.path)
        if entry is not None and entry.get("hash") == file_hash:
            vs = [Violation(**d) for d in entry["violations"]]
            cached += 1
        else:
            if rules is None:
                rules = _all_rules()
            vs = _check_ctx(ctx, rules)
            checked += 1
        next_files[ctx.path] = {
            "hash": file_hash, "violations": [asdict(v) for v in vs]}
        violations.extend(vs)

    if cache_path:
        # keep entries for files outside `only` so a --changed run does
        # not evict the full-lint cache
        merged = dict(cached_files)
        merged.update(next_files)
        try:
            with open(cache_path, "w", encoding="utf-8") as fh:
                json.dump({"digest": context_digest, "files": merged},
                          fh)
        except OSError:
            pass
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, checked, cached


def changed_paths(root: str) -> Optional[List[str]]:
    """Repo-relative ``.py`` paths changed vs the merge base.

    Compares the working tree against ``merge-base(HEAD, ref)`` for the
    first of origin/main, origin/master, main and master that resolves,
    and adds untracked files.  Returns None when git is unavailable or
    no base ref resolves — the caller falls back to a full lint."""

    def _git(*argv: str):
        try:
            return subprocess.run(["git", "-C", root, *argv],
                                  capture_output=True, text=True,
                                  timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None

    merge_base = None
    for ref in ("origin/main", "origin/master", "main", "master"):
        r = _git("merge-base", "HEAD", ref)
        if r is not None and r.returncode == 0:
            merge_base = r.stdout.strip()
            break
    if not merge_base:
        return None
    r = _git("diff", "--name-only", merge_base, "--")
    if r is None or r.returncode != 0:
        return None
    names = set(r.stdout.split())
    r = _git("ls-files", "--others", "--exclude-standard")
    if r is not None and r.returncode == 0:
        names |= set(r.stdout.split())
    return sorted(n for n in names if n.endswith(".py"))


# ---------------------------------------------------------------------------
# Baseline + CLI
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.txt")
_WHY = "# why: "


def load_baseline(path: str) -> Set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        return {line.rstrip("\n") for line in fh
                if line.strip() and not line.startswith("#")}


def baseline_reasons(path: str) -> Dict[str, str]:
    """fingerprint -> the ``# why:`` line written just above it."""
    out: Dict[str, str] = {}
    if not os.path.exists(path):
        return out
    why = ""
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(_WHY):
                why = line[len(_WHY):]
            elif line.strip() and not line.startswith("#"):
                if why:
                    out[line] = why
                why = ""
    return out


def write_baseline(path: str, violations: Sequence[Violation]) -> None:
    """Rewrite the baseline, keeping each surviving entry's reason."""
    reasons = baseline_reasons(path)
    fingerprints = sorted({v.fingerprint() for v in violations})
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# repro-lint baseline of the port: grandfathered violations.\n")
        fh.write("# One line-number-independent fingerprint per line, after a\n")
        fh.write("# '# why:' line with its reason; regenerate with\n")
        fh.write("# python -m repro_torch.analysis.lint --update-baseline\n")
        fh.write("# (it keeps the reasons of the entries that survive).\n")
        for fp in fingerprints:
            if fp in reasons:
                fh.write(_WHY + reasons[fp] + "\n")
            fh.write(fp + "\n")


def default_paths(root: str) -> List[str]:
    """``src/repro_torch``, ``tests/test_torch_*.py`` and
    ``chip_smoke.py`` under ``root`` (those that exist)."""
    tests = os.path.join(root, "tests")
    out = [os.path.join(root, "src", "repro_torch")]
    if os.path.isdir(tests):
        out += [os.path.join(tests, f) for f in sorted(os.listdir(tests))
                if f.startswith("test_torch_") and f.endswith(".py")]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.isfile(smoke):
        out.append(smoke)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Project-invariant linter (trace safety, RNG, "
                    "sentinel, dtype, contracts, protocol typestate).")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: "
                             "src/repro_torch, tests/test_torch_*.py, "
                             "chip_smoke.py)")
    parser.add_argument("--root", default=None,
                        help="repo root for path normalisation "
                             "(default: two levels above this file)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             "src/repro_torch/analysis/lint_baseline.txt)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from this run")
    parser.add_argument("--changed", action="store_true",
                        help="check only files changed vs the git merge "
                             "base (untracked included); the whole tree "
                             "is still parsed for cross-file facts")
    parser.add_argument("--no-cache", action="store_true",
                        help="ignore and do not write the result cache")
    args = parser.parse_args(argv)

    root = args.root or os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    paths = args.paths or default_paths(root)
    baseline_path = args.baseline or DEFAULT_BASELINE
    cache_path = None if args.no_cache else os.path.join(root, _CACHE_NAME)

    only: Optional[Set[str]] = None
    if args.changed:
        changed = changed_paths(root)
        if changed is None:
            print("repro-lint: --changed could not resolve a git merge "
                  "base; falling back to a full lint", file=sys.stderr)
        else:
            only = set(changed)

    violations, checked, cached = lint_paths_cached(
        paths, root=root, cache_path=cache_path, only=only)

    if args.update_baseline:
        if only is not None:
            print("repro-lint: refusing --update-baseline with "
                  "--changed (the baseline must cover the whole tree)",
                  file=sys.stderr)
            return 2
        write_baseline(baseline_path, violations)
        print(f"wrote {len({v.fingerprint() for v in violations})} "
              f"fingerprints to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    fresh = [v for v in violations if v.fingerprint() not in baseline]

    for v in fresh:
        print(v.render())
    scope = (f"{checked} checked, {cached} cached"
             + (f", {len(only)} changed" if only is not None else ""))
    if fresh:
        by_rule: Dict[str, int] = {}
        for v in fresh:
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        summary = ", ".join(f"{k}: {n}" for k, n in sorted(by_rule.items()))
        print(f"repro-lint: {len(fresh)} new violation(s) ({summary}); "
              f"{len(violations) - len(fresh)} grandfathered ({scope}).")
        return 1
    msg = f"repro-lint: clean ({len(violations)} grandfathered; {scope})"
    if only is None:
        # stale-baseline detection needs the full-tree violation set
        stale = baseline - {v.fingerprint() for v in violations}
        if stale:
            msg += (f"; {len(stale)} baseline entr"
                    f"{'y is' if len(stale) == 1 else 'ies are'} stale — "
                    f"consider --update-baseline")
    print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
