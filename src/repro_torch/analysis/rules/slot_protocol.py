"""slot-protocol: the versioned hot-swap discipline of fed.gossip.

The training loop rebuilds its train step from ``slot.plan``/``
slot.version``; the invariants that keep that sound are temporal:

* on a membership-change path, ``MembershipSlot.swap`` must
  happen-before any resizing swap (``PlanSlot.swap(...,
  allow_resize=True)`` or ``ScheduleSlot.swap_schedule(...,
  silos=...)``) — otherwise the loop re-lowers against a mesh whose
  membership it has not observed;
* a slot's fields (``plan``/``schedule``/``active``/``version``) are
  mutated only by the ``swap*`` methods in the protocol's home module
  (``fed/gossip.py``) — direct stores skip versioning, metrics and
  rollback;
* ``version`` is meaningful only after a swap: reading it off a
  freshly constructed slot observes the pre-protocol ``0``.

Reporting is "must"-style on top of a union join: the ordering facet
fires only when *no* path into the resize performed a membership swap,
so a swap under ``if self.membership_slot is not None:`` keeps the
shared continuation legal exactly like the runtime does.
"""

from __future__ import annotations

import ast
from typing import FrozenSet, Iterable, List, Optional

from ..dataflow import CFG, Entry, propagate, _own_exprs
from ..lint import FileCtx, Violation, dotted_name
from ..protocols import AttrEvent, MethodEvent, Protocol, Replay, \
    Transition, run_protocol
from .trace_safety import in_hot_path

RULE_ID = "slot-protocol"

_HOME = ("src/repro_torch/fed/gossip.py",)

_SLOT_FIELDS = ("plan", "schedule", "active", "version", "history")

#: Per-object machine: a slot constructed in this function must swap
#: before its version is read.  Name-hinted (externally owned) slots
#: carry unknown history and are never flagged.
SLOT_PROTOCOL = Protocol(
    name="slot",
    rule_id=RULE_ID,
    description="MembershipSlot.swap happens-before resizing "
                "PlanSlot/ScheduleSlot swaps; slot fields mutate only "
                "via swap*; version reads only after a swap",
    constructors=("MembershipSlot", "PlanSlot", "ScheduleSlot"),
    name_hints=(),
    home=_HOME,
    initial="fresh",
    states=("fresh", "swapped"),
    method_events=(
        MethodEvent("swap", "swap"),
        MethodEvent("swap_schedule", "swap"),
    ),
    attr_events=(AttrEvent("version", "read_version"),),
    transitions=(Transition("swap", ("*",), "swapped"),),
    errors={
        ("fresh", "read_version"):
            "version read on a never-swapped slot observes the "
            "pre-protocol 0; swap first (or branch on the slot, not "
            "its version)",
    },
)


#: The cross-object ordering machine.  The static facet below
#: interprets it over each function's CFG; :func:`replay_slot_trace`
#: runs the *same* tables over a FlightRecorder event stream, so the
#: runtime cross-check in ``tests/test_protocol_rules.py`` pins the
#: static and dynamic verdicts together.
ORDERING_PROTOCOL = Protocol(
    name="slot-ordering",
    rule_id=RULE_ID,
    description="membership swap happens-before any resizing swap "
                "within one actuation",
    home=_HOME,
    initial="idle",
    states=("idle", "membership_fresh"),
    transitions=(
        Transition("membership_swap", ("*",), "membership_fresh"),
        Transition("resize", ("membership_fresh",), "membership_fresh"),
        Transition("redesign", ("*",), "idle"),
    ),
    errors={
        ("idle", "resize"):
            "resizing swap with no membership swap in this actuation: "
            "the training loop would re-lower against an unobserved "
            "mesh",
    },
)


def trace_record_event(record) -> Optional[str]:
    """Map a FlightRecorder record (dict) to an ordering-machine event.

    ``membership`` records are membership swaps; ``swap`` records count
    as resizes only when their ``resized`` extra field is truthy (plain
    same-universe swaps are always legal); ``redesign`` closes the
    actuation.  Other kinds carry no protocol meaning."""
    kind = record.get("kind")
    if kind == "membership":
        return "membership_swap"
    if kind == "swap" and record.get("resized"):
        return "resize"
    if kind == "redesign":
        return "redesign"
    return None


def replay_slot_trace(records, *, strict: bool = True) -> Replay:
    """Run a runtime event stream through :data:`ORDERING_PROTOCOL`.

    ``records`` is an iterable of FlightRecorder dicts (e.g. from
    ``repro_torch.obs.events.validate_trace``).  Raises
    :class:`~repro_torch.analysis.protocols.ReplayError` on the first
    protocol violation when ``strict``; otherwise collects them on the
    returned replay's ``errors``."""
    replay = Replay(ORDERING_PROTOCOL)
    for record in records:
        event = trace_record_event(record)
        if event is not None:
            replay.feed(event, strict=strict)
    return replay


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _kwarg_active(call: ast.Call, key: str) -> bool:
    """True when ``key=`` is passed and is not a literal False/None."""
    for kw in call.keywords:
        if kw.arg == key:
            if isinstance(kw.value, ast.Constant) and \
                    kw.value.value in (False, None):
                return False
            return True
    return False


def _is_membership_swap(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "swap"):
        return False
    recv = dotted_name(call.func.value)
    return recv is not None and "membership" in _leaf(recv).lower()


def _is_resize(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "swap" and _kwarg_active(call, "allow_resize"):
        recv = dotted_name(call.func.value)
        # membership slots have no resize concept; don't double-count
        return not (recv and "membership" in _leaf(recv).lower())
    if call.func.attr == "swap_schedule" and _kwarg_active(call, "silos"):
        return True
    return False


class SlotProtocolRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        if ctx.path in _HOME or ctx.path.startswith(("tests/",
                                                     "benchmarks/")):
            return []
        if not in_hot_path(ctx):
            return []
        out: List[Violation] = []
        out.extend(self._check_direct_mutation(ctx))
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_ordering(ctx, node))
                for finding in run_protocol(SLOT_PROTOCOL, node):
                    out.append(ctx.violation(
                        self.id, finding.node,
                        f"{finding.key}: {finding.message}"))
        return out

    # -- facet: direct mutation of slot fields -----------------------------

    def _check_direct_mutation(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if not isinstance(tgt, ast.Attribute):
                    continue
                if tgt.attr not in _SLOT_FIELDS:
                    continue
                recv = dotted_name(tgt.value)
                if recv is None or "slot" not in _leaf(recv).lower():
                    continue
                out.append(ctx.violation(
                    self.id, node,
                    f"direct store to {recv}.{tgt.attr} bypasses the "
                    f"swap protocol (no version bump, no metrics, no "
                    f"rollback); go through swap/swap_schedule"))
        return out

    # -- facet: membership swap happens-before resize ----------------------

    def _check_ordering(self, ctx: FileCtx, fn: ast.AST
                        ) -> List[Violation]:
        cfg = CFG(fn)
        # abstract state: the subset of ORDERING_PROTOCOL states the
        # machine may be in when the statement starts
        init: FrozenSet[str] = frozenset({ORDERING_PROTOCOL.initial})

        def transfer(node: ast.AST, state: FrozenSet[str]
                     ) -> FrozenSet[str]:
            if isinstance(node, Entry) or not isinstance(node, ast.stmt):
                return state
            for expr in _own_exprs(node):
                for sub in ast.walk(expr):
                    if isinstance(sub, ast.Call) and \
                            _is_membership_swap(sub):
                        return ORDERING_PROTOCOL.step(
                            state, "membership_swap")
            return state

        def join(states: Iterable[FrozenSet[str]]) -> FrozenSet[str]:
            merged: FrozenSet[str] = frozenset()
            for s in states:
                merged |= s
            return merged

        in_states = propagate(cfg, init, transfer, join)

        out: List[Violation] = []
        for stmt in cfg.statements():
            state = in_states.get(stmt)
            if state is None or "membership_fresh" in state:
                continue
            own = [sub for expr in _own_exprs(stmt)
                   for sub in ast.walk(expr)]
            for sub in own:
                if not isinstance(sub, ast.Call) or not _is_resize(sub):
                    continue
                out.append(ctx.violation(
                    self.id, sub,
                    f"resizing swap with no MembershipSlot.swap on any "
                    f"path into it in '{fn.name}'; the training loop "
                    f"would re-lower against an unobserved mesh — swap "
                    f"membership first (or record an audit note instead "
                    f"of resizing)"))
        return out
