"""edgebatch-provenance: padded EdgeBatch fields are masked before use.

``EdgeBatch.w`` uses ``-inf`` as the "absent arc" sentinel and
``EdgeBatch.src``/``.dst`` hold garbage in the padded tail, so raw
arithmetic on either silently corrupts cycle times (``-inf - -inf`` is
NaN; summing a padded column counts ghost arcs).  The sentinel
rule catches *literal* ``NEG_INF`` arithmetic; this rule is its
dataflow upgrade: it follows values that *flow out of* ``.w``/``.src``
on a tracked batch and flags arithmetic or reductions on them unless
the value passed through ``missing_mask``/``isneginf`` masking (or was
handed to an engine entry point, which masks internally) first.

Tracked batches are ``EdgeBatch(...)`` constructor results or names
containing ``batch``/``eb``; the engine modules that implement the
masking are the protocol home and exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from ..dataflow import CFG, Entry, _own_exprs, propagate
from ..lint import FileCtx, Violation, dotted_name
from ..protocols import AttrEvent, Protocol, Transition
from .trace_safety import in_hot_path

RULE_ID = "edgebatch-provenance"

_HOME = ("src/repro_torch/core/maxplus_sparse.py",
         "src/repro_torch/core/maxplus_vec.py",
         "src/repro_torch/kernels/segment_max.py")

#: Declarative face of the protocol (docs table); the field-flow pass
#: below implements it over def-use chains.
EDGEBATCH_PROTOCOL = Protocol(
    name="edgebatch",
    rule_id=RULE_ID,
    description="values read from EdgeBatch.w/.src are masked via "
                "missing_mask/isneginf (or consumed by an engine entry "
                "point) before raw arithmetic or reductions",
    constructors=("EdgeBatch",),
    name_hints=("batch", "eb"),
    home=_HOME,
    initial="raw",
    hint_initial="raw",
    states=("raw", "masked"),
    attr_events=(AttrEvent("w", "read_field"),
                 AttrEvent("src", "read_field")),
    transitions=(Transition("mask", ("*",), "masked"),),
    errors={
        ("raw", "arith"):
            "raw arithmetic on an unmasked EdgeBatch field: the padded "
            "tail is -inf/garbage, so the result is NaN or counts "
            "ghost arcs; apply missing_mask first",
    },
)

_MASKERS = ("missing_mask", "np.isneginf", "numpy.isneginf",
            "jnp.isneginf", "np.isinf", "numpy.isinf", "jnp.isinf",
            "np.isfinite", "numpy.isfinite", "jnp.isfinite")

_REDUCERS = ("sum", "mean", "prod", "cumsum", "max", "min", "dot",
             "matmul", "exp", "log", "sqrt", "abs", "average")

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
              ast.Mod, ast.Pow)

State = Tuple[Tuple[str, FrozenSet[str]], ...]


def _batch_hinted(name: Optional[str]) -> bool:
    if not name:
        return False
    leaf = name.rsplit(".", 1)[-1].lower()
    return "batch" in leaf or leaf in ("eb", "sub")


def _field_read(expr: ast.AST, batch_vars: Iterable[str]
                ) -> Optional[str]:
    """'.w'/'.src' read off a tracked batch -> the field name."""
    if isinstance(expr, ast.Attribute) and expr.attr in ("w", "src"):
        recv = dotted_name(expr.value)
        if recv is not None and (recv in set(batch_vars)
                                 or _batch_hinted(recv)):
            return expr.attr
    return None


def _constructed_batches(fn: ast.AST) -> FrozenSet[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            ctor = dotted_name(node.value.func)
            if ctor and ctor.rsplit(".", 1)[-1] == "EdgeBatch":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return frozenset(out)


def _is_masker(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    return name is not None and (
        name in _MASKERS or name.rsplit(".", 1)[-1] == "missing_mask")


class EdgeBatchProvenanceRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if ctx.path in _HOME or ctx.path.startswith(("tests/",
                                                     "benchmarks/")):
            return []
        if not in_hot_path(ctx):
            return []
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_fn(ctx, node))
        return out

    def _check_fn(self, ctx: FileCtx, fn: ast.AST) -> List[Violation]:
        batches = _constructed_batches(fn)
        # quick reject: no tracked field read anywhere in the function
        if not any(_field_read(n, batches) for n in ast.walk(fn)):
            return []
        cfg = CFG(fn)
        init: State = ()

        def _events(m: Dict[str, FrozenSet[str]], node: ast.stmt,
                    report: Optional[List[ast.AST]] = None) -> None:
            # 1. track `v = batch.w` bindings
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                if _field_read(node.value, batches):
                    m[tgt] = frozenset({"raw"})
                elif tgt in m:
                    del m[tgt]  # rebound to something else
            for expr in _own_exprs(node):
                for sub in ast.walk(expr):
                    # 2. masking marks the operand var masked
                    if isinstance(sub, ast.Call) and _is_masker(sub):
                        for arg in sub.args:
                            if isinstance(arg, ast.Name) and \
                                    arg.id in m:
                                m[arg.id] = frozenset({"masked"})
                    # 3. raw arithmetic / reductions on tracked vars or
                    #    inline field reads
                    elif isinstance(sub, ast.BinOp) and isinstance(
                            sub.op, _ARITH_OPS):
                        for side in (sub.left, sub.right):
                            if self._raw_operand(side, m, batches):
                                if report is not None:
                                    report.append(sub)
                    elif isinstance(sub, ast.Call):
                        name = dotted_name(sub.func) or ""
                        leaf = name.rsplit(".", 1)[-1]
                        if leaf in _REDUCERS:
                            for arg in sub.args:
                                if self._raw_operand(arg, m, batches):
                                    if report is not None:
                                        report.append(sub)
                        else:
                            # obligation transfers to the callee
                            for arg in list(sub.args) + [
                                    kw.value for kw in sub.keywords]:
                                if isinstance(arg, ast.Name) and \
                                        arg.id in m:
                                    del m[arg.id]

        def transfer(node: ast.AST, state: State) -> State:
            if isinstance(node, Entry) or not isinstance(node, ast.stmt):
                return state
            m = dict(state)
            _events(m, node)
            return tuple(sorted(m.items()))

        def join(states: Iterable[State]) -> State:
            merged: Dict[str, FrozenSet[str]] = {}
            for st in states:
                for k, v in st:
                    merged[k] = merged.get(k, frozenset()) | v
            return tuple(sorted(merged.items()))

        in_states = propagate(cfg, init, transfer, join)

        out: List[Violation] = []
        seen = set()
        for stmt in cfg.statements():
            state = in_states.get(stmt)
            if state is None:
                continue
            sites: List[ast.AST] = []
            _events(dict(state), stmt, report=sites)
            for site in sites:
                if id(site) in seen:
                    continue
                seen.add(id(site))
                out.append(ctx.violation(
                    self.id, site,
                    EDGEBATCH_PROTOCOL.errors[("raw", "arith")]))
        return out

    def _raw_operand(self, expr: ast.AST,
                     m: Dict[str, FrozenSet[str]],
                     batches: FrozenSet[str]) -> bool:
        """unmasked on every path: a tracked var whose state is exactly
        {'raw'}, or an inline `batch.w` field read."""
        if isinstance(expr, ast.Name):
            return m.get(expr.id) == frozenset({"raw"})
        if isinstance(expr, ast.Subscript):
            return self._raw_operand(expr.value, m, batches)
        return _field_read(expr, batches) is not None
