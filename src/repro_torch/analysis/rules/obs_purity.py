"""obs-purity: observability never reaches inside traced code.

``repro_torch.obs`` spans read host wall clocks, metrics mutate
process-local registries under a lock, and the flight recorder writes
JSONL — all host effects.  Inside an ``autograd.Function`` body, a
``torch.compile``d function or a CUDA-graph capture they either run once
at capture time (recording nothing and timing the *capture*, not the
computation) or break the graph.  The supported pattern is
host-level only: a ``@span_fn`` decorator *above* the entry point (the
wrapper body never traces) or a ``with span(...)`` around the call that
launches the traced work.  This rule flags, in hot modules:

* any call through a name imported from ``repro_torch.obs`` (``span``,
  ``obs_metrics.counter``, a recorder's ``emit``...) inside a traced
  body;
* an ``import``/``from ... import`` of an obs module inside a traced
  body (lazy imports don't make host effects trace-safe);
* a ``span_fn``/``span`` decorator on a function the package marks as
  traced — it would bake the wrapper's clock reads into every capture.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..lint import FileCtx, Violation, body_nodes, dotted_name, \
    traced_functions
from .trace_safety import in_hot_path

RULE_ID = "obs-purity"

_SPAN_DECORATORS = ("span", "span_fn")


def _is_obs_module(module: str) -> bool:
    """True for 'repro_torch.obs', 'repro_torch.obs.spans', 'obs.metrics'
    (relative ``from ..obs.metrics import ...`` resolves to
    module='obs.metrics')."""
    parts = module.split(".")
    return "obs" in parts and (parts[0] in ("repro_torch", "obs")
                               or "repro_torch" in parts)


def obs_bound_names(tree: ast.AST) -> Set[str]:
    """Local names bound to repro_torch.obs imports anywhere in the
    file."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and _is_obs_module(node.module):
            for alias in node.names:
                names.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _is_obs_module(alias.name):
                    names.add((alias.asname or alias.name).split(".")[0])
    return names


def _base_name(node: ast.AST) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


class ObsPurityRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if not in_hot_path(ctx):
            return []
        bound = obs_bound_names(ctx.tree)
        out: List[Violation] = []
        for fn in traced_functions(ctx):
            for node in body_nodes(fn):
                if isinstance(node, ast.Call):
                    base = _base_name(node.func)
                    if base in bound:
                        out.append(ctx.violation(
                            self.id, node,
                            f"obs call '{dotted_name(node.func) or base}"
                            f"(...)' inside traced function '{fn.name}': "
                            f"span clocks / metric locks / recorder "
                            f"writes are host effects — instrument the "
                            f"host-level caller instead"))
                elif isinstance(node, ast.ImportFrom):
                    if node.module and _is_obs_module(node.module):
                        out.append(ctx.violation(
                            self.id, node,
                            f"repro_torch.obs imported inside traced "
                            f"function '{fn.name}'; a lazy import does not "
                            f"make host effects trace-safe"))
                elif isinstance(node, ast.Import):
                    if any(_is_obs_module(a.name) for a in node.names):
                        out.append(ctx.violation(
                            self.id, node,
                            f"repro_torch.obs imported inside traced "
                            f"function '{fn.name}'; a lazy import does not "
                            f"make host effects trace-safe"))
            for dec in fn.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                name = dotted_name(target) or ""
                if name.rsplit(".", 1)[-1] in _SPAN_DECORATORS:
                    out.append(ctx.violation(
                        self.id, dec,
                        f"span decorator on traced function '{fn.name}' "
                        f"bakes host clock reads into every capture; "
                        f"decorate the host-level entry point"))
        return out
