"""engine-contract: every public engine entry point declares its shapes.

The engines move ``[B,N,N]`` dense batches, ``[B,E]`` padded edge
batches and ``[R+1,N]`` timing tables through each other; a silent
rank/axis mixup usually *runs* (numpy broadcasts) and produces garbage
cycle times.  The ``@contract`` decorator documents the shape algebra
at the signature and — under ``REPRO_CHECK_CONTRACTS=1`` — enforces it.
This rule makes the decorator mandatory on public top-level functions
of the six engine modules so new entry points cannot skip it.
"""

from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation, dotted_name

RULE_ID = "engine-contract"


def _has_contract(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name and name.rsplit(".", 1)[-1] == "contract":
            return True
    return False


class EngineContractRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if ctx.path not in ctx.config.engine_modules:
            return []
        out: List[Violation] = []
        for node in ctx.tree.body:  # top-level defs only, not methods
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node.name.startswith("_"):
                continue
            if not _has_contract(node):
                out.append(ctx.violation(
                    self.id, node,
                    f"public engine function '{node.name}' has no "
                    f"@contract decorator; declare its shape spec "
                    f"(see repro_torch.analysis.contracts)"))
        return out
