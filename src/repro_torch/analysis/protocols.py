"""Declarative typestate machines for the project's temporal protocols.

The ``@contract`` layer checks *per-call* shapes; the invariants here
are *temporal* and spread across statements: a
``MembershipSlot`` must swap before a plan resize, a ``DeltaPricer``
certificate is only valid between ``price`` and ``commit``, an
``EdgeBatch`` weight column is only a number after masking.  This module
gives the lint rules one vocabulary for such protocols:

* a :class:`Protocol` is a declarative state machine — which
  constructors/names it tracks, how method calls and attribute reads map
  to events (:class:`MethodEvent` / :class:`AttrEvent`, optionally gated
  on a keyword flag), the transition table, and the ``(state, event) ->
  explanation`` error table;
* :func:`run_protocol` interprets a machine abstractly over a function's
  :class:`~repro_torch.analysis.dataflow.CFG` (union join at merges, fixpoint
  over loops) and reports an error only when *every* path reaches the
  statement in an erroneous state — "may" facts, "must" reporting, so a
  swap on one branch keeps the other branch's resize legal exactly like
  the runtime does;
* :class:`Replay` runs the same transition/error tables over a *runtime*
  event stream (e.g. a FlightRecorder trace), so a dynamic run can be
  checked against the identical machine the static rule used —
  ``tests/test_protocol_rules.py`` pins static and dynamic verdicts
  together.

Objects escape (state ``ESCAPED``, never erroneous) when they are passed
to a call, stored into a container/attribute, returned, or yielded:
protocol obligations transfer to the receiver, which this
function-at-a-time analysis does not see.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, \
    Sequence, Tuple

from .dataflow import CFG, Entry, analyze_function, assigned_names, \
    _own_exprs  # type: ignore[attr-defined]

__all__ = ["MethodEvent", "AttrEvent", "Transition", "Protocol",
           "ProtocolFinding", "run_protocol", "protocol_table_row",
           "Replay", "ReplayError", "ESCAPED"]

#: Pseudo-state of an object whose obligations left this function.
ESCAPED = "<escaped>"


@dataclass(frozen=True)
class MethodEvent:
    """Maps a method call on a tracked object to a machine event.

    ``when_kwarg`` gates the mapping on a keyword argument being present
    and not a literal ``False``/``None`` (a *variable* flag counts as
    present — the analysis cannot prove it false, and "must" reporting
    keeps that sound).  The first matching event in declaration order
    wins, so list the gated variant before the bare one."""

    method: str
    event: str
    when_kwarg: Optional[str] = None


@dataclass(frozen=True)
class AttrEvent:
    """Maps a plain attribute *read* on a tracked object to an event."""

    attr: str
    event: str


@dataclass(frozen=True)
class Transition:
    event: str
    src: Tuple[str, ...]   # ("*",) matches any state
    dst: str


@dataclass(frozen=True)
class Protocol:
    """One temporal protocol: tracking, events, transitions, errors."""

    name: str
    rule_id: str
    description: str
    #: Constructor names whose call results are tracked from ``initial``.
    constructors: Tuple[str, ...] = ()
    #: Substrings of variable / dotted-attribute names tracked from
    #: ``hint_initial`` (objects whose history predates this function).
    name_hints: Tuple[str, ...] = ()
    #: Module paths (repo-relative) that *implement* the protocol and
    #: are exempt from it.
    home: Tuple[str, ...] = ()
    initial: str = "fresh"
    hint_initial: str = "external"
    states: Tuple[str, ...] = ()
    method_events: Tuple[MethodEvent, ...] = ()
    attr_events: Tuple[AttrEvent, ...] = ()
    transitions: Tuple[Transition, ...] = ()
    #: (state, event) -> human explanation; reaching one is a violation.
    errors: Mapping[Tuple[str, str], str] = field(default_factory=dict)

    def classify_call(self, call: ast.Call) -> Optional[str]:
        """Event name of ``<tracked>.method(...)``, or None."""
        if not isinstance(call.func, ast.Attribute):
            return None
        method = call.func.attr
        kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        for ev in self.method_events:
            if ev.method != method:
                continue
            if ev.when_kwarg is None:
                return ev.event
            val = kwargs.get(ev.when_kwarg)
            if val is None:
                continue
            if isinstance(val, ast.Constant) and val.value in (False, None):
                continue
            return ev.event
        return None

    def step(self, states: FrozenSet[str], event: str) -> FrozenSet[str]:
        """Post-states of firing ``event`` from a state set."""
        out = set()
        for s in states:
            if s == ESCAPED:
                out.add(ESCAPED)
                continue
            dst = None
            for t in self.transitions:
                if t.event == event and (t.src == ("*",) or s in t.src):
                    dst = t.dst
                    break
            out.add(dst if dst is not None else s)
        return frozenset(out)

    def error_of(self, states: FrozenSet[str], event: str) -> Optional[str]:
        """Explanation iff *every* non-escaped state is erroneous for
        ``event`` (must semantics).  None when any path is fine."""
        live = [s for s in states if s != ESCAPED]
        if not live:
            return None
        msgs = [self.errors.get((s, event)) for s in live]
        if all(m is not None for m in msgs):
            return msgs[0]
        return None


@dataclass(frozen=True)
class ProtocolFinding:
    node: ast.AST
    key: str
    event: str
    states: FrozenSet[str]
    message: str


# ---------------------------------------------------------------------------
# Static interpretation over a function CFG
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _hinted(proto: Protocol, key: str) -> bool:
    leaf = key.rsplit(".", 1)[-1]
    return any(h in leaf for h in proto.name_hints)


State = Tuple[Tuple[str, FrozenSet[str]], ...]  # sorted (key, states) pairs


def _to_map(state: State) -> Dict[str, FrozenSet[str]]:
    return dict(state)


def _to_state(m: Mapping[str, FrozenSet[str]]) -> State:
    return tuple(sorted(m.items()))


def _constructor_of(proto: Protocol, value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = _dotted(value.func)
    if name is None:
        return False
    return name.rsplit(".", 1)[-1] in proto.constructors


def _tracked_keys_in(proto: Protocol, fn: ast.AST) -> List[str]:
    """Name-hinted keys used anywhere in the function body."""
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Attribute, ast.Name)):
            key = _dotted(node)
            if key and _hinted(proto, key):
                keys.add(key)
    return sorted(keys)


def _events_of_stmt(proto: Protocol, stmt: ast.AST,
                    keys: Iterable[str]) -> List[Tuple[str, str, ast.AST]]:
    """(key, event, site) triples this statement fires, in source order."""
    key_set = set(keys)
    out: List[Tuple[str, str, ast.AST]] = []
    call_receivers: List[ast.AST] = []
    for expr in _own_exprs(stmt):
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                call_receivers.append(node.func.value)
                key = _dotted(node.func.value)
                if key in key_set:
                    event = proto.classify_call(node)
                    if event is not None:
                        out.append((key, event, node))
    # attribute reads that are not the receiver of an evented call
    recv_ids = {id(r) for r in call_receivers}
    for expr in _own_exprs(stmt):
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load) and id(node.value) not in recv_ids:
                key = _dotted(node.value)
                if key in key_set:
                    for ev in proto.attr_events:
                        if ev.attr == node.attr:
                            out.append((key, ev.event, node))
    out.sort(key=lambda t: (getattr(t[2], "lineno", 0),
                            getattr(t[2], "col_offset", 0)))
    return out


def _escaped_keys(stmt: ast.AST, keys: Iterable[str]) -> List[str]:
    """Tracked keys whose object leaves this function at this statement:
    passed as a call argument, stored into an attribute/subscript/
    container, returned, or yielded."""
    key_set = set(keys)
    hits: List[str] = []

    def _key_of(node: ast.AST) -> Optional[str]:
        k = _dotted(node)
        return k if k in key_set else None

    for expr in _own_exprs(stmt):
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    k = _key_of(arg)
                    if k:
                        hits.append(k)
            elif isinstance(node, (ast.List, ast.Tuple, ast.Set)):
                for elt in node.elts:
                    k = _key_of(elt)
                    if k:
                        hits.append(k)
            elif isinstance(node, ast.Dict):
                for v in node.values:
                    k = _key_of(v)
                    if k:
                        hits.append(k)
    if isinstance(stmt, (ast.Return, ast.Expr)):
        value = stmt.value
        if isinstance(value, (ast.Yield, ast.YieldFrom)):
            value = value.value
        if value is not None:
            k = _key_of(value)
            if k:
                hits.append(k)
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if not isinstance(tgt, ast.Name):  # obj.attr = slot / d[k] = slot
                k = _key_of(stmt.value)
                if k:
                    hits.append(k)
    return hits


def run_protocol(proto: Protocol, fn: ast.AST) -> List[ProtocolFinding]:
    """Interpret ``proto`` over one function (or module) body."""
    analysis = analyze_function(fn)
    cfg: CFG = analysis.cfg
    hinted = _tracked_keys_in(proto, fn)

    init_map: Dict[str, FrozenSet[str]] = {
        k: frozenset({proto.hint_initial}) for k in hinted}
    init = _to_state(init_map)

    def transfer(node: ast.AST, state: State) -> State:
        if isinstance(node, Entry) or not isinstance(node, ast.stmt):
            return state
        m = _to_map(state)
        # (re)bindings first: `x = DeltaPricer(...)` tracks x fresh;
        # `x = something_else` unbinds a constructor-tracked x.
        if isinstance(node, ast.Assign) and len(node.targets) >= 1:
            for tgt in node.targets:
                key = _dotted(tgt) if isinstance(
                    tgt, (ast.Name, ast.Attribute)) else None
                if key is None:
                    continue
                if _constructor_of(proto, node.value):
                    m[key] = frozenset({proto.initial})
                elif key in m:
                    m[key] = (frozenset({proto.hint_initial})
                              if _hinted(proto, key)
                              else frozenset())
        else:
            rebound = assigned_names(node)
            for key in list(m):
                if key.split(".", 1)[0] in rebound and "." not in key:
                    m[key] = (frozenset({proto.hint_initial})
                              if _hinted(proto, key) else frozenset())
        for key, event, _site in _events_of_stmt(proto, node, m):
            m[key] = proto.step(m[key], event)
        for key in _escaped_keys(node, m):
            m[key] = frozenset({ESCAPED})
        return _to_state({k: v for k, v in m.items() if v})

    def join(states: Iterable[State]) -> State:
        merged: Dict[str, FrozenSet[str]] = {}
        for st in states:
            for k, v in st:
                merged[k] = merged.get(k, frozenset()) | v
        return _to_state(merged)

    from .dataflow import propagate

    in_states = propagate(cfg, init, transfer, join)

    findings: List[ProtocolFinding] = []
    seen = set()
    for stmt in cfg.statements():
        state = in_states.get(stmt)
        if state is None:
            continue
        m = _to_map(state)
        # replay the statement's own rebinds before its events, exactly
        # as transfer does, so `pm = dp.price()` sees pre-price states
        if isinstance(stmt, ast.Assign) and _constructor_of(proto,
                                                            stmt.value):
            pass
        for key, event, site in _events_of_stmt(proto, stmt, m):
            states = m.get(key, frozenset())
            msg = proto.error_of(states, event)
            dedup = (id(site), key, event)
            if msg is not None and dedup not in seen:
                seen.add(dedup)
                findings.append(ProtocolFinding(
                    node=site, key=key, event=event, states=states,
                    message=msg))
            m[key] = proto.step(states, event)
    return findings


def protocol_table_row(proto: Protocol) -> Tuple[str, str, str, str]:
    """(rule id, states, error states, description) for the docs table."""
    err_states = sorted({f"{s}--{e}" for (s, e) in proto.errors})
    return (proto.rule_id, " / ".join(proto.states),
            ", ".join(err_states), proto.description)


# ---------------------------------------------------------------------------
# Runtime replay (trace cross-check)
# ---------------------------------------------------------------------------

class ReplayError(Exception):
    """A runtime event stream violated the protocol machine."""


class Replay:
    """Run a protocol's transition/error tables over a runtime event
    stream — one state per tracked key (no abstraction: the runtime
    knows exactly which object did what).

    >>> r = Replay(SLOT_MACHINE)     # doctest: +SKIP
    >>> r.feed("membership_swap")
    >>> r.feed("plan_resize")        # legal: membership swapped first
    """

    def __init__(self, proto: Protocol, start: Optional[str] = None):
        self.proto = proto
        self.state = start if start is not None else proto.initial
        self.log: List[Tuple[str, str, str]] = []  # (before, event, after)
        self.errors: List[str] = []

    def feed(self, event: str, *, strict: bool = True) -> str:
        before = self.state
        msg = self.proto.errors.get((before, event))
        if msg is not None:
            self.errors.append(
                f"{self.proto.name}: event {event!r} in state {before!r}: "
                f"{msg}")
            if strict:
                raise ReplayError(self.errors[-1])
        after = self.proto.step(frozenset({before}), event)
        self.state = next(iter(after))
        self.log.append((before, event, self.state))
        return self.state
