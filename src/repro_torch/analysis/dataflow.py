"""Per-function control-flow + dataflow analysis for repro-lint.

The plain lint rules are syntactic: they pattern-match single AST nodes
and cannot tell ``float(rng.uniform(...))`` (a host value — never a
device sync) from ``float(step_fn(x))`` (a per-iteration device→host
sync).  This module adds the machinery the *protocol* rules need:

* :class:`CFG` — a statement-granularity control-flow graph of one
  function, with loop back edges, ``break``/``continue``, ``return``/
  ``raise`` to exit, and try/except edges (any statement of a ``try``
  body may jump to any handler);
* :func:`reaching_definitions` — classic forward may-analysis over the
  CFG (which assignments may reach each statement);
* :class:`FunctionAnalysis` — def-use chains on top of the reaching
  definitions, plus :meth:`FunctionAnalysis.host_only`, a transitive
  origin query: does *every* definition chain of this expression
  bottom out in host-side sources (numpy calls, stdlib, literals,
  seeded ``np.random`` generators) rather than function parameters or
  tensors?
* :func:`propagate` — a generic forward abstract-state fixpoint used by
  :mod:`repro_torch.analysis.protocols` to run typestate machines over the
  CFG.

Everything here is pure stdlib ``ast`` — no imports of the linted code.
"""

from __future__ import annotations

import ast
from typing import (Callable, Dict, Iterable, List, Optional, Set, Tuple,
                    TypeVar)

__all__ = ["CFG", "Entry", "reaching_definitions", "FunctionAnalysis",
           "analyze_function", "propagate", "assigned_names",
           "names_loaded"]


class Entry:
    """Synthetic CFG entry node: the definition site of every parameter."""

    lineno = 0
    col_offset = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<cfg-entry>"


class _Exit:
    lineno = 0
    col_offset = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<cfg-exit>"


class CFG:
    """Statement-granularity control-flow graph of one function body.

    Nodes are the function's ``ast.stmt`` objects themselves (identity
    hashing), plus a synthetic :class:`Entry` and exit.  Compound
    statements (``if``/``while``/``for``/``try``/``with``) are nodes in
    their own right — they evaluate their test/iterable — with edges
    into their bodies.  Nested function/class definitions are single
    nodes (their bodies belong to *their* CFGs).
    """

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.entry: Entry = Entry()
        self.exit: _Exit = _Exit()
        self.succs: Dict[ast.AST, Set[ast.AST]] = {self.entry: set(),
                                                   self.exit: set()}
        self.preds: Dict[ast.AST, Set[ast.AST]] = {self.entry: set(),
                                                   self.exit: set()}
        self._build()

    # -- construction ------------------------------------------------------

    def _edge(self, a: ast.AST, b: ast.AST) -> None:
        self.succs.setdefault(a, set()).add(b)
        self.preds.setdefault(b, set()).add(a)
        self.succs.setdefault(b, set())
        self.preds.setdefault(a, set())

    def _build(self) -> None:
        body = getattr(self.fn, "body", [])
        # loop stack entries: (continue_target, break_targets:list)
        exits = self._seq(body, [self.entry], loops=[])
        for e in exits:
            self._edge(e, self.exit)

    def _seq(self, stmts: List[ast.stmt], frontier: List[ast.AST],
             loops: List[Tuple[ast.AST, List[ast.AST]]]) -> List[ast.AST]:
        """Wire a statement list after ``frontier``; return its exits."""
        for stmt in stmts:
            for f in frontier:
                self._edge(f, stmt)
            frontier = self._stmt(stmt, loops)
            if not frontier:        # return/raise/break/continue: dead end
                return []
        return frontier

    def _stmt(self, stmt: ast.stmt,
              loops: List[Tuple[ast.AST, List[ast.AST]]]) -> List[ast.AST]:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._edge(stmt, self.exit)
            return []
        if isinstance(stmt, ast.Break):
            if loops:
                loops[-1][1].append(stmt)
            return []
        if isinstance(stmt, ast.Continue):
            if loops:
                self._edge(stmt, loops[-1][0])
            return []
        if isinstance(stmt, ast.If):
            then_exits = self._seq(stmt.body, [stmt], loops)
            if stmt.orelse:
                else_exits = self._seq(stmt.orelse, [stmt], loops)
            else:
                else_exits = [stmt]
            return then_exits + else_exits
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            breaks: List[ast.AST] = []
            loops.append((stmt, breaks))
            body_exits = self._seq(stmt.body, [stmt], loops)
            loops.pop()
            for e in body_exits:
                self._edge(e, stmt)          # back edge
            after: List[ast.AST] = [stmt]    # loop may run zero times
            after.extend(breaks)
            if stmt.orelse:
                after = self._seq(stmt.orelse, [stmt], loops) + breaks
            return after
        if isinstance(stmt, ast.Try):
            body_exits = self._seq(stmt.body, [stmt], loops)
            # Any statement of the try body (or the Try header itself)
            # may raise into any handler.
            raisers: List[ast.AST] = [stmt] + [
                n for n in stmt.body for n in self._all_stmts(n)]
            handler_exits: List[ast.AST] = []
            for handler in stmt.handlers:
                h_frontier = list(dict.fromkeys(raisers))
                handler_exits.extend(
                    self._seq(handler.body, h_frontier, loops))
            if stmt.orelse:
                body_exits = self._seq(stmt.orelse, body_exits, loops)
            exits = body_exits + handler_exits
            if stmt.finalbody:
                exits = self._seq(stmt.finalbody, exits or [stmt], loops)
            return exits
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._seq(stmt.body, [stmt], loops)
        # simple statement (incl. nested FunctionDef/ClassDef as one node)
        self.succs.setdefault(stmt, set())
        self.preds.setdefault(stmt, set())
        return [stmt]

    def _all_stmts(self, stmt: ast.stmt) -> List[ast.stmt]:
        """stmt plus every statement nested inside it (not nested defs)."""
        out = [stmt]
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return out
        for child in ast.walk(stmt):
            if child is not stmt and isinstance(child, ast.stmt) and \
                    not isinstance(child, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef)):
                out.append(child)
        return out

    # -- queries -----------------------------------------------------------

    @property
    def nodes(self) -> List[ast.AST]:
        return list(self.succs)

    def statements(self) -> List[ast.stmt]:
        return [n for n in self.succs
                if not isinstance(n, (Entry, _Exit))]


# ---------------------------------------------------------------------------
# Definitions and uses
# ---------------------------------------------------------------------------

def _comp_targets(node: ast.AST) -> Set[str]:
    """Names bound by comprehension generators (scope-local, not defs)."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.comprehension):
            for n in ast.walk(sub.target):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _target_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx,
                                                  (ast.Store, ast.Del)):
            out.add(n.id)
    return out


def assigned_names(stmt: ast.AST) -> Set[str]:
    """Variable names this single statement (re)binds."""
    out: Set[str] = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            out |= _target_names(t)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        out |= _target_names(stmt.target)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        out |= _target_names(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                out |= _target_names(item.optional_vars)
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        out.add(stmt.name)
    elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
        for alias in stmt.names:
            out.add((alias.asname or alias.name).split(".")[0])
    elif isinstance(stmt, ast.Try):
        for handler in stmt.handlers:
            if handler.name:
                out.add(handler.name)
    # walrus targets anywhere in the statement's expressions
    skip_defs = isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
    if not skip_defs:
        for n in _own_exprs(stmt):
            for sub in ast.walk(n):
                if isinstance(sub, ast.NamedExpr):
                    out |= _target_names(sub.target)
    return out


def _own_exprs(stmt: ast.AST) -> List[ast.AST]:
    """Expressions evaluated *by this statement itself* (not by the
    statements nested in its body/orelse/handlers)."""
    if isinstance(stmt, ast.If):
        return [stmt.test]
    if isinstance(stmt, ast.While):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items] + [
            i.optional_vars for i in stmt.items
            if i.optional_vars is not None]
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return list(stmt.decorator_list)
    return [c for c in ast.iter_child_nodes(stmt)
            if isinstance(c, ast.expr)]


def names_loaded(stmt: ast.AST) -> Set[str]:
    """Names this statement reads (Load context), excluding
    comprehension-local targets and nested-def bodies."""
    out: Set[str] = set()
    for expr in _own_exprs(stmt):
        local = _comp_targets(expr)
        for n in ast.walk(expr):
            if isinstance(n, (ast.Lambda,)):
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in local:
                out.add(n.id)
    # AugAssign reads its target too
    if isinstance(stmt, ast.AugAssign):
        out |= _target_names(stmt.target)
    return out


Def = Tuple[str, ast.AST]  # (variable, defining node)


def reaching_definitions(cfg: CFG) -> Dict[ast.AST, Set[Def]]:
    """IN[n] for every CFG node: the (var, def-site) pairs that may
    reach the entry of n.  The synthetic entry node defines every
    parameter."""
    params: Set[str] = set()
    args = getattr(cfg.fn, "args", None)
    if args is not None:
        for a in (args.args + args.kwonlyargs
                  + getattr(args, "posonlyargs", [])):
            params.add(a.arg)
        if args.vararg:
            params.add(args.vararg.arg)
        if args.kwarg:
            params.add(args.kwarg.arg)

    gen: Dict[ast.AST, Set[Def]] = {}
    kill: Dict[ast.AST, Set[str]] = {}
    for node in cfg.nodes:
        if isinstance(node, Entry):
            gen[node] = {(p, node) for p in params}
            kill[node] = set(params)
        else:
            names = assigned_names(node) if isinstance(node, ast.stmt) \
                else set()
            gen[node] = {(v, node) for v in names}
            kill[node] = set(names)

    out_sets: Dict[ast.AST, Set[Def]] = {n: set(gen[n]) for n in cfg.nodes}
    in_sets: Dict[ast.AST, Set[Def]] = {n: set() for n in cfg.nodes}
    work = list(cfg.nodes)
    while work:
        n = work.pop()
        new_in: Set[Def] = set()
        for p in cfg.preds.get(n, ()):
            new_in |= out_sets[p]
        if new_in != in_sets[n]:
            in_sets[n] = new_in
        new_out = gen[n] | {(v, d) for (v, d) in new_in
                            if v not in kill[n]}
        if new_out != out_sets[n]:
            out_sets[n] = new_out
            work.extend(cfg.succs.get(n, ()))
    return in_sets


# ---------------------------------------------------------------------------
# Host-origin inference
# ---------------------------------------------------------------------------

#: Module roots whose call results live on host, never on device.
HOST_MODULES = frozenset({
    "np", "numpy", "math", "os", "sys", "time", "random", "itertools",
    "functools", "collections", "json", "re", "pathlib", "string",
})

#: Builtins whose result is host-only iff all arguments are host-only.
_HOST_BUILTINS = frozenset({
    "float", "int", "bool", "str", "len", "abs", "min", "max", "sum",
    "sorted", "list", "tuple", "dict", "set", "frozenset", "range",
    "enumerate", "zip", "reversed", "round", "repr", "format", "any",
    "all",
})


class FunctionAnalysis:
    """Def-use chains + origin inference for one function."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.cfg = CFG(fn)
        self.reach_in = reaching_definitions(self.cfg)
        self._stmt_of: Dict[ast.AST, ast.AST] = {}
        for stmt in self.cfg.statements():
            for expr in _own_exprs(stmt):
                for sub in ast.walk(expr):
                    self._stmt_of.setdefault(sub, stmt)
            self._stmt_of.setdefault(stmt, stmt)

    def enclosing_stmt(self, node: ast.AST) -> Optional[ast.AST]:
        """The CFG statement that evaluates ``node`` (None if the node
        belongs to a nested def this CFG treats as opaque)."""
        return self._stmt_of.get(node)

    def defs_of(self, var: str, at: ast.AST) -> Set[ast.AST]:
        """Definition sites of ``var`` that may reach statement ``at``."""
        return {d for (v, d) in self.reach_in.get(at, ()) if v == var}

    def chains(self) -> Dict[Tuple[ast.AST, str], Set[ast.AST]]:
        """(use-stmt, var) -> possible defining nodes, for every load."""
        out: Dict[Tuple[ast.AST, str], Set[ast.AST]] = {}
        for stmt in self.cfg.statements():
            for var in names_loaded(stmt):
                out[(stmt, var)] = self.defs_of(var, stmt)
        return out

    # -- origin inference --------------------------------------------------

    def host_only(self, expr: ast.AST, at: Optional[ast.AST] = None) -> bool:
        """True when every dataflow chain of ``expr`` bottoms out in a
        host-side source.  Conservative: parameters, unresolved globals
        and unknown calls are *not* host-only."""
        if at is None:
            at = self.enclosing_stmt(expr)
            if at is None:
                return False
        return self._host(expr, at, frozenset())

    def _host(self, expr: ast.AST, at: ast.AST,
              seen: frozenset) -> bool:
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, ast.JoinedStr):
            return True
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            return all(self._host(e, at, seen) for e in expr.elts
                       if not isinstance(e, ast.Starred))
        if isinstance(expr, ast.Dict):
            return all(self._host(v, at, seen) for v in expr.values)
        if isinstance(expr, ast.Starred):
            return self._host(expr.value, at, seen)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            if not all(self._host(g.iter, at, seen)
                       for g in expr.generators):
                return False
            # over a host iterable the comprehension targets are host
            local = seen | {("comp-local", n)
                            for n in _comp_targets(expr)}
            if isinstance(expr, ast.DictComp):
                return (self._host(expr.key, at, local)
                        and self._host(expr.value, at, local))
            return self._host(expr.elt, at, local)
        if isinstance(expr, ast.BinOp):
            return (self._host(expr.left, at, seen)
                    and self._host(expr.right, at, seen))
        if isinstance(expr, ast.UnaryOp):
            return self._host(expr.operand, at, seen)
        if isinstance(expr, ast.BoolOp):
            return all(self._host(v, at, seen) for v in expr.values)
        if isinstance(expr, ast.Compare):
            return self._host(expr.left, at, seen) and all(
                self._host(c, at, seen) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return (self._host(expr.body, at, seen)
                    and self._host(expr.orelse, at, seen))
        if isinstance(expr, (ast.Subscript, ast.Attribute)):
            return self._host(expr.value, at, seen)
        if isinstance(expr, ast.NamedExpr):
            return self._host(expr.value, at, seen)
        if isinstance(expr, ast.Call):
            return self._host_call(expr, at, seen)
        if isinstance(expr, ast.Name):
            return self._host_name(expr.id, at, seen)
        return False

    def _host_call(self, call: ast.Call, at: ast.AST,
                   seen: frozenset) -> bool:
        func = call.func
        # np.foo(...) / math.foo(...) / os.path.join(...): host result.
        base = func
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(func, ast.Attribute) and isinstance(base, ast.Name):
            if base.id in HOST_MODULES:
                return True
            # method on a host-only object (rng.uniform, list.pop, ...)
            if self._host_name(base.id, at, seen):
                return True
            return False
        if isinstance(func, ast.Name):
            if func.id in ("range", "len"):
                # always a host int/range, whatever the argument is
                return True
            if func.id in _HOST_BUILTINS:
                args: List[ast.AST] = list(call.args)
                args.extend(kw.value for kw in call.keywords)
                return all(self._host(a, at, seen) for a in args)
            return False
        return False

    def _host_name(self, var: str, at: ast.AST, seen: frozenset) -> bool:
        if ("comp-local", var) in seen:
            return True
        key = (var, id(at))
        if key in seen:
            # Cycle through a loop-carried binding: this chain adds no
            # non-host source of its own.
            return True
        seen = seen | {key}
        defs = self.defs_of(var, at)
        if not defs:
            return False  # parameter-at-entry handled below, or global
        for d in defs:
            if isinstance(d, Entry):
                return False  # function parameter: may be a device value
            if not self._host_def(var, d, seen):
                return False
        return True

    def _host_def(self, var: str, d: ast.AST, seen: frozenset) -> bool:
        if isinstance(d, (ast.Import, ast.ImportFrom)):
            # Imported *names* are code objects/modules, not device data.
            return True
        if isinstance(d, ast.Assign):
            return self._host(d.value, d, seen)
        if isinstance(d, ast.AnnAssign):
            return d.value is not None and self._host(d.value, d, seen)
        if isinstance(d, ast.AugAssign):
            # x += v: old x reaches this statement too
            return (self._host(d.value, d, seen)
                    and self._host_name(var, d, seen))
        if isinstance(d, (ast.For, ast.AsyncFor)):
            return self._host(d.iter, d, seen)
        if isinstance(d, (ast.With, ast.AsyncWith)):
            return all(self._host(i.context_expr, d, seen)
                       for i in d.items)
        if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return True  # a def object, not data
        return False


def analyze_function(fn: ast.AST) -> FunctionAnalysis:
    """Build (and cache on the node) the per-function analysis."""
    cached = getattr(fn, "_repro_dataflow", None)
    if cached is None:
        cached = FunctionAnalysis(fn)
        try:
            fn._repro_dataflow = cached  # type: ignore[attr-defined]
        except (AttributeError, TypeError):  # pragma: no cover
            pass
    return cached


# ---------------------------------------------------------------------------
# Generic forward abstract-state fixpoint (typestate engine)
# ---------------------------------------------------------------------------

S = TypeVar("S")


def propagate(cfg: CFG, init: S,
              transfer: Callable[[ast.AST, S], S],
              join: Callable[[Iterable[S]], S],
              ) -> Dict[ast.AST, S]:
    """Run a forward dataflow pass to fixpoint.

    ``init`` seeds the synthetic entry node; ``transfer(node, state)``
    returns the state *after* executing ``node``; ``join`` merges the
    out-states of multiple predecessors.  Returns the IN state of every
    node (the state the typestate machine is in when the statement
    starts executing).  ``transfer`` must be monotone and states must
    support ``==``; the loop re-queues successors until nothing
    changes."""
    in_states: Dict[ast.AST, S] = {cfg.entry: init}
    out_states: Dict[ast.AST, S] = {}
    work: List[ast.AST] = [cfg.entry]
    iterations = 0
    limit = 50 * max(1, len(cfg.nodes)) * max(1, len(cfg.nodes))
    while work:
        iterations += 1
        if iterations > limit:  # pragma: no cover - non-monotone transfer
            break
        n = work.pop()
        preds = cfg.preds.get(n, ())
        if preds:
            state = join([out_states[p] for p in preds
                          if p in out_states] or [init])
        else:
            state = in_states.get(n, init)
        in_states[n] = state
        new_out = transfer(n, state)
        if out_states.get(n) != new_out:
            out_states[n] = new_out
            work.extend(cfg.succs.get(n, ()))
    return in_states
