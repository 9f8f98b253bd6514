"""effect-purity: dataflow-inferred host effects where they cost.

Syntactically a linter cannot tell ``float(rng.uniform())`` (host value,
free) from ``float(step_fn(x))`` (a per-iteration device→host sync).
This rule uses :mod:`repro_torch.analysis.dataflow` origin inference:

* **loop syncs** — a scalar-sync call inside a host loop is flagged
  only when the operand is *not* provably host-only (some definition
  chain reaches a function parameter or an unknown call);
* **unbatched transfers** — two-plus separate host transfers from one
  tuple-unpacked device computation are flagged only when the
  transferred names are not host-only;
* **traced host effects** — ``print``/``open``/file-system/clock/
  logging calls and ``global`` writes inside traced bodies and the
  ``*_torch`` device twins: under ``torch.compile`` or a CUDA-graph
  replay they run once at capture time and never again, which is a
  silent logic change, not just a slowdown.

The remedy for the first two is the same on the card: one ``.cpu()`` or
``.tolist()`` of a stacked tensor outside the loop.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..dataflow import FunctionAnalysis, analyze_function
from ..lint import FileCtx, Violation, body_nodes, dotted_name, \
    traced_functions
from .trace_safety import _base_name, in_hot_path

RULE_ID = "effect-purity"

#: Module roots whose calls are host effects inside a traced body.
_EFFECT_MODULES = {"os", "sys", "time", "logging", "subprocess",
                   "socket", "shutil", "tempfile"}
_EFFECT_BUILTINS = {"print", "open", "input", "breakpoint"}


def _host(an: FunctionAnalysis, expr: ast.AST) -> bool:
    """host_only, but conservative (False) when the expression is not
    reachable from the function's own CFG (nested lambdas etc.)."""
    if an.enclosing_stmt(expr) is None:
        return False
    return an.host_only(expr)


class EffectPurityRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if not in_hot_path(ctx):
            return []
        out: List[Violation] = []
        traced = traced_functions(ctx)
        twins = {
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.endswith("_torch")}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node in traced or node in twins:
                out.extend(self._check_traced_effects(ctx, node))
            if node not in traced:
                an = analyze_function(node)
                out.extend(self._check_loop_syncs(ctx, node, an))
                out.extend(self._check_unbatched_transfers(ctx, node, an))
        return out

    # -- facet 1: per-iteration device syncs in host loops -----------------

    def _check_loop_syncs(self, ctx: FileCtx, fn: ast.AST,
                          an: FunctionAnalysis) -> List[Violation]:
        out: List[Violation] = []
        seen: Set[int] = set()
        for node in body_nodes(fn):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or id(sub) in seen:
                    continue
                seen.add(id(sub))
                flagged = None
                operand: Optional[ast.AST] = None
                if isinstance(sub.func, ast.Name) and \
                        sub.func.id == "float" and sub.args and \
                        not isinstance(sub.args[0], ast.Constant):
                    flagged, operand = "float(...)", sub.args[0]
                elif isinstance(sub.func, ast.Attribute):
                    if sub.func.attr == "item" and not sub.args:
                        flagged, operand = ".item()", sub.func.value
                    else:
                        name = dotted_name(sub.func)
                        if name in ("np.asarray", "numpy.asarray") \
                                and sub.args:
                            flagged = "np.asarray(...)"
                            operand = sub.args[0]
                if flagged is None or operand is None:
                    continue
                if _host(an, operand):
                    continue  # host-origin scalar: no device sync
                out.append(ctx.violation(
                    self.id, sub,
                    f"{flagged} inside a loop in hot function "
                    f"'{fn.name}' syncs a possibly-device value every "
                    f"iteration; keep the values on the device and take "
                    f"one .cpu() or .tolist() of a stacked tensor outside "
                    f"the loop"))
        return out

    # -- facet 2: unbatched device→host transfers --------------------------

    def _check_unbatched_transfers(self, ctx: FileCtx, fn: ast.AST,
                                   an: FunctionAnalysis
                                   ) -> List[Violation]:
        out: List[Violation] = []
        stmts = list(body_nodes(fn))
        groups: List[tuple] = []  # (assign node, {unpacked names})
        for node in stmts:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Tuple) \
                    and isinstance(node.value, ast.Call):
                if _host(an, node.value):
                    continue  # host computation: transfers are free
                names = {elt.id for elt in node.targets[0].elts
                         if isinstance(elt, ast.Name)}
                if len(names) >= 2:
                    groups.append((node, names))
        if not groups:
            return out
        sync_counts: Dict[int, Set[str]] = {i: set()
                                            for i in range(len(groups))}
        for node in stmts:
            if not isinstance(node, ast.Call):
                continue
            target = None
            callee = dotted_name(node.func)
            if callee in ("np.asarray", "numpy.asarray", "np.array",
                          "numpy.array", "np.copy", "numpy.copy") \
                    and node.args:
                target = _base_name(node.args[0])
            elif isinstance(node.func, ast.Name) and \
                    node.func.id == "float" and node.args:
                target = _base_name(node.args[0])
            if not target:
                continue
            for i, (assign, names) in enumerate(groups):
                if target in names and node.lineno > assign.lineno:
                    sync_counts[i].add(target)
        for i, (assign, names) in enumerate(groups):
            hit = sync_counts[i]
            if len(hit) >= 2:
                out.append(ctx.violation(
                    self.id, assign,
                    f"{len(hit)} separate host transfers "
                    f"({', '.join(sorted(hit))}) from one device "
                    f"computation in '{fn.name}'; fetch them together "
                    f"with one .cpu() or .tolist() of a stacked "
                    f"tensor"))
        return out

    # -- facet 3: host effects inside traced bodies ------------------------

    def _check_traced_effects(self, ctx: FileCtx, fn: ast.AST
                              ) -> List[Violation]:
        out: List[Violation] = []
        for node in body_nodes(fn):
            if isinstance(node, ast.Global):
                out.append(ctx.violation(
                    self.id, node,
                    f"'global' write inside traced function "
                    f"'{fn.name}' runs once at trace time, not per "
                    f"call; thread the state through arguments"))
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                base = name.split(".", 1)[0]
                if name in _EFFECT_BUILTINS or (
                        "." in name and base in _EFFECT_MODULES):
                    out.append(ctx.violation(
                        self.id, node,
                        f"host effect '{name}(...)' inside traced "
                        f"function '{fn.name}' executes at capture time "
                        f"only — it silently disappears from every "
                        f"replay; hoist it out of the traced body"))
        return out
