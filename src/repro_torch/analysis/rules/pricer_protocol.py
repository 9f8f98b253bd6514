"""pricer-protocol: DeltaPricer certificate discipline.

``DeltaPricer.price`` returns a :class:`PricedMove` — a *certificate*
(cycle time + potentials + critical arcs) valid against the pricer's
current graph.  ``commit`` applies it and mutates the graph, so the
temporal contract is:

* ``commit`` only with a live certificate — committing before any
  ``price``, or committing a ``PricedMove`` after an intervening
  ``price``/``update``/``reanchor``/``commit`` changed the graph,
  silently corrupts the Eq. 3/4 incremental max-cycle-mean state;
* ``force_full=True`` (a literal) defeats the delta path and belongs in
  tests/benchmarks only — production callers thread a variable so the
  CLI can choose.

Tracking is per-object over the CFG: variables bound from
``DeltaPricer(...)`` (or whose name contains ``pricer``) are followed;
``schedule.price(...)`` — a different, stateless ``price`` — is never
tracked.  Reporting is "must"-style: a certificate is flagged only when
it is stale on *every* path into the commit.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from ..dataflow import CFG, Entry, _own_exprs, propagate
from ..lint import FileCtx, Violation, dotted_name
from ..protocols import MethodEvent, Protocol, Transition
from .trace_safety import in_hot_path

RULE_ID = "pricer-protocol"

_HOME = ("src/repro_torch/core/maxplus_sparse.py",)

#: Declarative machine (docs table + runtime replay); the static pass
#: below adds per-certificate tracking on top of it.
PRICER_PROTOCOL = Protocol(
    name="pricer",
    rule_id=RULE_ID,
    description="DeltaPricer.price -> commit pairing; no stale "
                "PricedMove commits after an intervening "
                "price/update/reanchor; literal force_full=True only "
                "in tests/benchmarks",
    constructors=("DeltaPricer",),
    name_hints=("pricer",),
    home=_HOME,
    initial="anchored",
    hint_initial="external",
    states=("anchored", "priced"),
    method_events=(
        MethodEvent("price", "price"),
        MethodEvent("update", "update"),
        MethodEvent("commit", "commit"),
        MethodEvent("reanchor", "reanchor"),
    ),
    transitions=(
        Transition("price", ("*",), "priced"),
        Transition("update", ("*",), "anchored"),
        Transition("commit", ("*",), "anchored"),
        Transition("reanchor", ("*",), "anchored"),
    ),
    errors={
        ("anchored", "commit"):
            "commit with no live certificate: nothing was priced "
            "against the current graph",
    },
)

# abstract value domain for tracked keys --------------------------------
# pricer key "p"            -> subset of {"anchored", "priced"}
# certificate key "p::c"    -> subset of {"live", "stale"}
State = Tuple[Tuple[str, FrozenSet[str]], ...]


def _receiver(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return dotted_name(call.func.value)
    return None


def _is_pricer_key(key: str) -> bool:
    return "::" not in key


def _tracked_pricers(fn: ast.AST) -> Dict[str, bool]:
    """pricer key -> constructed-here?  Keys are constructor-bound
    targets plus any ``*pricer*`` receivers of protocol methods."""
    out: Dict[str, bool] = {}
    methods = {ev.method for ev in PRICER_PROTOCOL.method_events}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            ctor = dotted_name(node.value.func)
            if ctor and ctor.rsplit(".", 1)[-1] in \
                    PRICER_PROTOCOL.constructors:
                for tgt in node.targets:
                    key = dotted_name(tgt) if isinstance(
                        tgt, (ast.Name, ast.Attribute)) else None
                    if key:
                        out[key] = True
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            if node.func.attr in methods:
                recv = dotted_name(node.func.value)
                if recv and "pricer" in recv.rsplit(
                        ".", 1)[-1].lower():
                    out.setdefault(recv, False)
    return out


class PricerProtocolRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if ctx.path in _HOME:
            return []
        out: List[Violation] = []
        if not ctx.path.startswith(("tests/", "benchmarks/")):
            out.extend(self._check_force_full(ctx))
        if not in_hot_path(ctx):
            return out
        if not ctx.path.startswith(("tests/", "benchmarks/")):
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    out.extend(self._check_certificates(ctx, node))
        return out

    # -- facet: literal force_full=True outside tests/benchmarks -----------

    def _check_force_full(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("price", "update")):
                continue
            for kw in node.keywords:
                if kw.arg == "force_full" and isinstance(
                        kw.value, ast.Constant) and kw.value.value is True:
                    out.append(ctx.violation(
                        self.id, node,
                        "literal force_full=True defeats the delta "
                        "pricing path; production callers must thread "
                        "a variable (tests/benchmarks are exempt)"))
        return out

    # -- facet: price -> commit pairing, stale certificates ----------------

    def _check_certificates(self, ctx: FileCtx, fn: ast.AST
                            ) -> List[Violation]:
        pricers = _tracked_pricers(fn)
        if not pricers:
            return []
        cfg = CFG(fn)
        init_map = {
            p: frozenset({"anchored" if constructed else "priced"})
            for p, constructed in pricers.items()}
        # externally owned pricers start "priced" so a bare commit on
        # them is never a must-error (their history is unknown)
        init: State = tuple(sorted(init_map.items()))

        def _apply(m: Dict[str, FrozenSet[str]], node: ast.stmt) -> None:
            # escape: pricer passed as a call argument drops tracking
            for expr in _own_exprs(node):
                for sub in ast.walk(expr):
                    if isinstance(sub, ast.Call):
                        for arg in list(sub.args) + [
                                kw.value for kw in sub.keywords]:
                            key = dotted_name(arg) if isinstance(
                                arg, (ast.Name, ast.Attribute)) else None
                            if key in m and _is_pricer_key(key):
                                for k in [k for k in m
                                          if k == key or
                                          k.startswith(key + "::")]:
                                    del m[k]
            bind_target: Optional[str] = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                bind_target = node.targets[0].id
            for expr in _own_exprs(node):
                for sub in ast.walk(expr):
                    if not (isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute)):
                        continue
                    p = _receiver(sub)
                    if p not in m or not _is_pricer_key(p):
                        continue
                    method = sub.func.attr
                    if method == "price":
                        for k in list(m):
                            if k.startswith(p + "::"):
                                m[k] = frozenset({"stale"})
                        m[p] = frozenset({"priced"})
                        if bind_target and sub is node.value:
                            m[f"{p}::{bind_target}"] = frozenset({"live"})
                    elif method in ("update", "reanchor", "commit"):
                        for k in list(m):
                            if k.startswith(p + "::"):
                                m[k] = frozenset({"stale"})
                        m[p] = frozenset({"anchored"})
            # rebinding a certificate variable to anything else unbinds it
            if bind_target is not None and not (
                    isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "price"):
                for k in list(m):
                    if k.endswith("::" + bind_target):
                        del m[k]

        def transfer(node: ast.AST, state: State) -> State:
            if isinstance(node, Entry) or not isinstance(node, ast.stmt):
                return state
            m = dict(state)
            _apply(m, node)
            return tuple(sorted(m.items()))

        def join(states: Iterable[State]) -> State:
            merged: Dict[str, FrozenSet[str]] = {}
            for st in states:
                for k, v in st:
                    merged[k] = merged.get(k, frozenset()) | v
            return tuple(sorted(merged.items()))

        in_states = propagate(cfg, init, transfer, join)

        out: List[Violation] = []
        for stmt in cfg.statements():
            state = in_states.get(stmt)
            if state is None:
                continue
            m = dict(state)
            for expr in _own_exprs(stmt):
                for sub in ast.walk(expr):
                    if not (isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute)
                            and sub.func.attr == "commit"):
                        continue
                    p = _receiver(sub)
                    if p not in m or not _is_pricer_key(p):
                        continue
                    ck = (f"{p}::{sub.args[0].id}"
                          if sub.args and isinstance(sub.args[0], ast.Name)
                          else None)
                    if ck is not None and m.get(ck) == \
                            frozenset({"stale"}):
                        out.append(ctx.violation(
                            self.id, sub,
                            f"committing stale certificate "
                            f"'{sub.args[0].id}': an intervening "
                            f"price/update/reanchor/commit changed "
                            f"{p}'s graph since it was priced; "
                            f"re-price against the current graph"))
                    elif m[p] == frozenset({"anchored"}):
                        out.append(ctx.violation(
                            self.id, sub,
                            f"{p}.commit(...) "
                            + PRICER_PROTOCOL.errors[
                                ("anchored", "commit")]))
            _apply(m, stmt)
        return out
