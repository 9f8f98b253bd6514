"""Declarative shape contracts for engine entry points (a stdlib-only
copy of the reference's ``repro/analysis/contracts.py``: the same spec
language, the same ``REPRO_CHECK_CONTRACTS`` switch and the same
``__contract__`` record on the wrapper).

Every public function in the six engine modules (``core/maxplus_vec``,
``core/maxplus_sparse``, ``core/delays``, ``core/schedule``,
``core/mixing``, ``kernels/segment_max``) carries a ``@contract``
decorator describing the shapes it accepts and returns.  Disabled, the
decorator costs one read of a module global per call (the variable is
read once, at import); under ``REPRO_CHECK_CONTRACTS=1`` (the default
in the test suite, set by ``tests/conftest.py``) or after ``enable()``
every call is checked against its spec and a ``ContractError`` names
the function, argument, expected spec and observed shape on mismatch.
``CHECKED_CALLS`` counts the checked calls; a ``@contract()`` with no
spec (a shape-free entry point, such as the per-arc delay functions)
checks nothing and counts none.

Spec mini-language (one spec string per argument, positionally; keyword
arguments via ``**kw_specs``; the return value via ``ret=``):

====================  ====================================================
``None``              argument participates in the signature but is
                      unchecked (documented as shape-free)
``"[B,N,N]"``         array-like with that rank; each dim token either
                      binds a name, checks a previously bound name,
                      is a literal int, ``_`` (ignore), or an arithmetic
                      expression over bound names (``"[N+1,B,N]"``)
``"[...,N,N]"``       leading ``...`` allows any number of extra
                      leading dims
``"[]"``              rank-0 (scalar) array
``"N"``               a static Python int; binds ``N``
``"#E"``              any sized sequence; binds ``E = len(arg)``
``"eb[B,E,N]"``       an ``EdgeBatch``-like object: ``src``/``dst``/``w``
                      share a 2-d shape checked against ``[B,E]`` and
                      ``num_nodes`` is checked against ``N``
``"*spec"``           optional — skipped when the argument is ``None``
``"a|b"``             alternation: first matching branch wins
====================  ====================================================

Dim names bind on first sight and must agree at every later use within
one call, across arguments and the return value.  The checker reads only
``.shape``/``len()``: it never converts a value to an array, so a CUDA
tensor is never copied to the host (a value with no shape is a
``ContractError``), and a ``"N"`` spec refuses a tensor instead of
reading it back.  The module imports neither numpy nor torch: every
engine module imports it.
"""

from __future__ import annotations

import functools
import inspect
import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["contract", "ContractError", "checking_enabled", "enable",
           "disable"]

_ENV_VAR = "REPRO_CHECK_CONTRACTS"
_ENABLED: bool = os.environ.get(_ENV_VAR, "") == "1"  # enable()/disable() set it
CHECKED_CALLS = 0  # calls checked against their contract, in this process


class ContractError(TypeError):
    """A call violated its declared shape contract.

    A ``TypeError`` only, as in the reference: callers that treat a
    ``ValueError`` as "this candidate does not apply" let it through."""


def checking_enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


# ---------------------------------------------------------------------------
# Spec parsing.  A parsed spec is a list of alternatives; each alternative
# is a tuple ("array", ellipsis, tokens) | ("scalar", name) |
# ("seqlen", name) | ("edgebatch", tokens).  Tokens are ("bind", name),
# ("lit", int), ("skip",) or ("expr", source).
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[A-Za-z_]\w*$")
_EXPR_RE = re.compile(r"^[\w\s+\-*()]+$")
_PARSE_CACHE: Dict[str, Tuple] = {}


def _parse_token(tok: str) -> Tuple:
    tok = tok.strip()
    if tok == "_":
        return ("skip",)
    if tok.lstrip("-").isdigit():
        return ("lit", int(tok))
    if _NAME_RE.match(tok):
        return ("bind", tok)
    if _EXPR_RE.match(tok):
        return ("expr", tok)
    raise ValueError(f"bad dim token {tok!r} in contract spec")


def _parse_dims(body: str) -> List[Tuple]:
    body = body.strip()
    if not body:
        return []
    return [_parse_token(t) for t in body.split(",")]


def _parse_alt(spec: str) -> Tuple:
    spec = spec.strip()
    if spec.startswith("eb[") and spec.endswith("]"):
        return ("edgebatch", _parse_dims(spec[3:-1]))
    if spec.startswith("[") and spec.endswith("]"):
        body = spec[1:-1]
        ellipsis = False
        if body.startswith("..."):
            ellipsis = True
            body = body[3:].lstrip(",")
        return ("array", ellipsis, _parse_dims(body))
    if spec.startswith("#"):
        name = spec[1:].strip()
        if not _NAME_RE.match(name):
            raise ValueError(f"bad seq-len spec {spec!r}")
        return ("seqlen", name)
    if _NAME_RE.match(spec):
        return ("scalar", spec)
    raise ValueError(f"bad contract spec {spec!r}")


def _parse_spec(spec: str) -> Tuple:
    cached = _PARSE_CACHE.get(spec)
    if cached is None:
        optional = spec.startswith("*")
        body = spec[1:] if optional else spec
        cached = (optional, tuple(_parse_alt(a) for a in body.split("|")))
        _PARSE_CACHE[spec] = cached
    return cached


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------

def _shape_of(value: Any) -> Optional[Tuple[int, ...]]:
    shape = getattr(value, "shape", None)
    if shape is not None:
        try:
            return tuple(int(d) for d in shape)
        except Exception:  # abstract/polymorphic dims: give up, don't fail
            return None
    if isinstance(value, (list, tuple)):
        return _sequence_shape(value)
    if isinstance(value, (int, float, complex, bool)):
        return ()
    return None


def _sequence_shape(value) -> Optional[Tuple[int, ...]]:
    """``np.shape`` of a (nested) list or tuple, from ``len()`` and the
    elements' own ``.shape`` only; ``None`` for a ragged nest."""
    inner: Optional[Tuple[int, ...]] = None
    for item in value:
        if isinstance(item, (list, tuple)) or hasattr(item, "shape"):
            got = _shape_of(item)
        else:
            got = ()  # a scalar leaf (number, string, object)
        if got is None or (inner is not None and got != inner):
            return None
        inner = got
    return (len(value),) + (inner or ())


def _eval_expr(src: str, env: Dict[str, int]) -> int:
    for name in re.findall(r"[A-Za-z_]\w*", src):
        if name not in env:
            raise _Mismatch(f"dim {name!r} in {src!r} is unbound")
    try:
        return int(eval(src, {"__builtins__": {}}, dict(env)))  # noqa: S307
    except _Mismatch:
        raise
    except Exception as exc:
        raise _Mismatch(f"could not evaluate dim expr {src!r}: {exc}")


class _Mismatch(Exception):
    pass


def _match_dims(tokens: List[Tuple], shape: Tuple[int, ...],
                env: Dict[str, int]) -> None:
    if len(tokens) != len(shape):
        raise _Mismatch(
            f"rank {len(shape)} != expected rank {len(tokens)}")
    # Two passes: bind bare names first, then evaluate expressions, so
    # "[N+1,B,N]" works regardless of token order.
    deferred = []
    for tok, dim in zip(tokens, shape):
        kind = tok[0]
        if kind == "skip":
            continue
        if kind == "lit":
            if dim != tok[1]:
                raise _Mismatch(f"dim {dim} != literal {tok[1]}")
        elif kind == "bind":
            bound = env.get(tok[1])
            if bound is None:
                env[tok[1]] = int(dim)
            elif bound != dim:
                raise _Mismatch(f"dim {tok[1]}={bound} but saw {dim}")
        else:  # expr
            deferred.append((tok[1], dim))
    for src, dim in deferred:
        want = _eval_expr(src, env)
        if dim != want:
            raise _Mismatch(f"dim {dim} != {src} (= {want})")


def _match_alt(alt: Tuple, value: Any, env: Dict[str, int]) -> None:
    kind = alt[0]
    if kind == "array":
        _, ellipsis, tokens = alt
        shape = _shape_of(value)
        if shape is None:
            raise _Mismatch("value has no shape")
        if ellipsis:
            if len(shape) < len(tokens):
                raise _Mismatch(
                    f"rank {len(shape)} < minimum rank {len(tokens)}")
            shape = shape[len(shape) - len(tokens):]
        _match_dims(tokens, shape, env)
    elif kind == "scalar":
        if type(value).__module__.split(".")[0] == "torch":
            raise _Mismatch("expected a static Python int, not a tensor")
        try:
            got = int(value)
        except Exception:
            raise _Mismatch("expected a static Python int")
        name = alt[1]
        bound = env.get(name)
        if bound is None:
            env[name] = got
        elif bound != got:
            raise _Mismatch(f"dim {name}={bound} but saw {got}")
    elif kind == "seqlen":
        try:
            got = len(value)
        except Exception:
            raise _Mismatch("expected a sized sequence")
        name = alt[1]
        bound = env.get(name)
        if bound is None:
            env[name] = got
        elif bound != got:
            raise _Mismatch(f"len {name}={bound} but saw {got}")
    else:  # edgebatch
        tokens = alt[1]
        for attr in ("src", "dst", "w", "num_nodes"):
            if not hasattr(value, attr):
                raise _Mismatch(f"expected an EdgeBatch (missing .{attr})")
        s = _shape_of(value.src)
        d = _shape_of(value.dst)
        w = _shape_of(value.w)
        if s is None or s != d or s != w:
            raise _Mismatch(
                f"EdgeBatch src/dst/w shapes disagree: {s} {d} {w}")
        if len(tokens) != 3:
            raise _Mismatch("eb[...] spec needs exactly [B,E,N] tokens")
        # num_nodes first: it binds N, which edge-count expressions like
        # "E+N" (overlay pool + self-loop slots) may reference.
        _match_dims(tokens[2:], (int(value.num_nodes),), env)
        _match_dims(tokens[:2], s, env)


def _check_value(label: str, spec: Optional[str], value: Any,
                 env: Dict[str, int], fn_name: str) -> None:
    if spec is None:
        return
    optional, alts = _parse_spec(spec)
    if optional and value is None:
        return
    errors = []
    for alt in alts:
        trial = dict(env)
        try:
            _match_alt(alt, value, trial)
        except _Mismatch as exc:
            errors.append(str(exc))
            continue
        env.clear()
        env.update(trial)
        return
    shape = _shape_of(value)
    raise ContractError(
        f"{fn_name}: {label} violates contract {spec!r} "
        f"(observed shape {shape}, type {type(value).__name__}): "
        + "; ".join(errors))


# ---------------------------------------------------------------------------
# Decorator
# ---------------------------------------------------------------------------

def contract(*arg_specs: Optional[str], ret: Optional[str] = None,
             **kw_specs: Optional[str]):
    """Attach a shape contract to a function.

    Positional specs pair with the function's parameters in order (extra
    parameters are unchecked); ``kw_specs`` address parameters by name;
    ``ret`` checks the return value against dims bound by the inputs.
    """

    def decorate(fn):
        sig = inspect.signature(fn)
        params = [p.name for p in sig.parameters.values()]
        if len(arg_specs) > len(params):
            raise ValueError(
                f"contract on {fn.__name__}: {len(arg_specs)} specs for "
                f"{len(params)} parameters")
        pairs = [(name, spec) for name, spec in zip(params, arg_specs)
                 if spec is not None]
        pairs += [(name, spec) for name, spec in kw_specs.items()
                  if spec is not None]
        for name, _ in pairs:
            if name not in sig.parameters:
                raise ValueError(
                    f"contract on {fn.__name__}: unknown parameter {name!r}")
        for _, spec in pairs:
            _parse_spec(spec)  # fail at decoration time, not call time
        if ret is not None:
            _parse_spec(ret)
        empty = not pairs and ret is None  # "@contract()": nothing to check

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ENABLED or empty:
                return fn(*args, **kwargs)
            global CHECKED_CALLS
            CHECKED_CALLS += 1
            try:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
            except TypeError:
                return fn(*args, **kwargs)  # let the call raise natively
            env: Dict[str, int] = {}
            for name, spec in pairs:
                if name in bound.arguments:
                    _check_value(f"argument {name!r}", spec,
                                 bound.arguments[name], env, fn.__name__)
            result = fn(*args, **kwargs)
            if ret is not None:
                _check_value("return value", ret, result, env, fn.__name__)
            return result

        wrapper.__contract__ = {
            "args": arg_specs, "kwargs": dict(kw_specs), "ret": ret}
        wrapper.__wrapped__ = fn
        return wrapper

    return decorate
