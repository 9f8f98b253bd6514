"""sentinel-discipline: the -inf "absent arc" sentinel is structural.

The port's ``MISSING`` (the reference's ``NEG_INF``, which the port
keeps as an alias) marks a *missing* edge in the padded engines, not a
number:
``NEG_INF - NEG_INF`` (and ``0 * NEG_INF``) are NaN, and under f32 a
finite pipeline can *produce* -inf by overflow, at which point a raw
``== NEG_INF`` comparison silently misclassifies a real arc as padding.
Arithmetic on the sentinel and raw equality tests are therefore flagged
(``maxplus_vec.missing_mask`` is the sanctioned test); so is any
redefinition of the sentinel outside its home module — there must be
exactly one ``MISSING`` object in the port.
"""

from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation

RULE_ID = "sentinel-discipline"

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
              ast.Mod, ast.Pow)


def _is_sentinel(node: ast.AST, names) -> bool:
    return isinstance(node, ast.Name) and node.id in names


class SentinelDisciplineRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        names = set(ctx.config.sentinel_names)
        is_home = ctx.path == ctx.config.sentinel_home
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, _ARITH_OPS):
                if _is_sentinel(node.left, names) or _is_sentinel(
                        node.right, names):
                    out.append(ctx.violation(
                        self.id, node,
                        "arithmetic on the NEG_INF sentinel: "
                        "-inf - -inf and 0 * -inf are NaN (and f32 "
                        "pipelines overflow to -inf); mask absent "
                        "arcs instead of computing through them"))
            elif isinstance(node, ast.UnaryOp) and isinstance(
                    node.op, ast.USub) and _is_sentinel(node.operand,
                                                        names):
                out.append(ctx.violation(
                    self.id, node,
                    "negating NEG_INF produces +inf, which the "
                    "max-plus engines never expect in a weight slot"))
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                for op, lhs, rhs in zip(node.ops, operands,
                                        operands[1:]):
                    if isinstance(op, (ast.Eq, ast.NotEq)) and (
                            _is_sentinel(lhs, names)
                            or _is_sentinel(rhs, names)):
                        out.append(ctx.violation(
                            self.id, node,
                            "raw ==/!= NEG_INF comparison; use "
                            "maxplus_vec.missing_mask(x) — equality "
                            "reads as a value test and misfires when "
                            "f32 overflow manufactures a -inf"))
                        break
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Name) and not is_home and (
                            "NEG_INF" in tgt.id or tgt.id in names):
                        out.append(ctx.violation(
                            self.id, node,
                            f"redefinition of sentinel '{tgt.id}' "
                            f"outside {ctx.config.sentinel_home}; "
                            f"import the canonical "
                            f"maxplus_vec.MISSING"))
        return out
