"""trace-safety: host syncs and Python control flow inside traced code.

A ``float()``/``.item()``/``np.*`` call on a tensor inside a traced body
(an ``autograd.Function``'s ``forward``/``backward``, a function handed
to ``torch.func``, ``torch.compile`` or a CUDA-graph capture) either
stalls the stream on a device-to-host copy, breaks the capture, or —
under ``torch.compile`` — bakes one call's value into the graph.  A
Python ``if``/``while`` on a tensor argument is a host sync and a graph
break.  (The host-
loop sync heuristics that used to live here moved to the dataflow-
based ``effect-purity`` rule, which can tell host scalars from device
values and so no longer needs grandfathering.)
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..lint import (_KNOWN_FILE_PREFIXES, FileCtx, Violation, body_nodes,
                    dotted_name, traced_functions)

RULE_ID = "trace-safety"

_KNOWN_SRC_PREFIXES = _KNOWN_FILE_PREFIXES


def in_hot_path(ctx: FileCtx) -> bool:
    """Hot modules per config; bare snippets (tests) count as hot."""
    if ctx.path.startswith(ctx.config.hot_prefixes):
        return True
    return not ctx.path.startswith(_KNOWN_SRC_PREFIXES)


def _is_np(name: str) -> bool:
    return name in ("np", "numpy")


def _base_name(node: ast.AST) -> str:
    """Leftmost Name of an expression like ``a[i].b`` -> 'a'."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


class TraceSafetyRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if not in_hot_path(ctx):
            return []
        out: List[Violation] = []
        traced = traced_functions(ctx)
        for fn in traced:
            out.extend(self._check_traced_body(ctx, fn))
        return out

    # -- facet 1+2+3: inside traced bodies ---------------------------------

    def _check_traced_body(self, ctx: FileCtx, fn: ast.AST
                           ) -> List[Violation]:
        out: List[Violation] = []
        params = _param_names(fn)
        for node in body_nodes(fn):
            if isinstance(node, ast.Call):
                out.extend(self._check_call_in_trace(ctx, fn, node))
            elif isinstance(node, (ast.If, ast.While)):
                bad = _tracer_names_in_test(node.test, params)
                if bad:
                    names = ", ".join(sorted(bad))
                    out.append(ctx.violation(
                        self.id, node,
                        f"Python branch on possibly-traced value(s) "
                        f"{names} inside traced function "
                        f"'{fn.name}'; use torch.where or hoist "
                        f"the decision out of the traced body"))
        return out

    def _check_call_in_trace(self, ctx: FileCtx, fn: ast.AST,
                             node: ast.Call) -> List[Violation]:
        out: List[Violation] = []
        callee = node.func
        if isinstance(callee, ast.Name):
            if callee.id in ("float", "bool") and node.args and \
                    not isinstance(node.args[0], ast.Constant):
                out.append(ctx.violation(
                    self.id, node,
                    f"{callee.id}() on a non-constant inside traced "
                    f"function '{fn.name}' forces a host sync (or a "
                    f"concretization error); keep the value on device"))
            elif callee.id == "int" and node.args and isinstance(
                    node.args[0], (ast.Subscript, ast.Call)):
                out.append(ctx.violation(
                    self.id, node,
                    f"int() on a computed value inside traced function "
                    f"'{fn.name}' is a host sync; static ints should "
                    f"arrive as arguments"))
        elif isinstance(callee, ast.Attribute):
            if callee.attr in ("item", "tolist") and not node.args:
                out.append(ctx.violation(
                    self.id, node,
                    f".{callee.attr}() inside traced function "
                    f"'{fn.name}' is a host sync"))
            else:
                name = dotted_name(callee)
                if name and "." in name:
                    base, leaf = name.split(".", 1)
                    if _is_np(base) and "." not in leaf and \
                            leaf not in ctx.config.np_trace_constants:
                        out.append(ctx.violation(
                            self.id, node,
                            f"np.{leaf}(...) inside traced function "
                            f"'{fn.name}' executes on host at trace "
                            f"time; use torch.{leaf} so it stays on the "
                            f"device"))
        return out

def _param_names(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = {a.arg for a in args.args + args.kwonlyargs
             + getattr(args, "posonlyargs", [])}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size"}
_EXEMPT_CALLS = {"len", "isinstance", "getattr", "hasattr", "callable"}


def _tracer_names_in_test(test: ast.AST, params: Set[str]) -> Set[str]:
    """Param names used as values (not via shape/ndim/len) in a branch
    test.  ``is None`` / ``is not None`` comparisons are exempt."""
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return set()

    offending: Set[str] = set()

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return  # x.shape[...] is static under trace
        if isinstance(node, ast.Call):
            fname = node.func.id if isinstance(node.func, ast.Name) else ""
            if fname in _EXEMPT_CALLS:
                return
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        if isinstance(node, ast.Name) and node.id in params:
            offending.add(node.id)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(test)
    return offending
