"""dtype-discipline: f64 is load-bearing, defaults are not.

The bit-for-bit equivalence chain (legacy == dense == sparse, port ==
reference) and the survivor-migration identity hold only in float64.  A
dtype-less ``np.zeros`` in an engine module inherits whatever the
platform default is; a dtype-less ``torch.zeros``/``empty``/``full`` is
*float32* (``torch.get_default_dtype()``), and a dtype-less
``torch.tensor`` infers from its data.  And any f32 cast (``float32``,
``.float()``, ``.half()``...) inside the bit-identity consensus/migration
functions breaks the identity silently — the result is merely *close*,
which is exactly the failure mode the equivalence tests exist to rule
out.
"""

from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation, dotted_name

RULE_ID = "dtype-discipline"

_CTORS = {"zeros", "ones", "empty", "full"}
_TORCH_CTORS = _CTORS | {"tensor"}
_F32_TOKENS = {"float32", "f32", "bfloat16", "bf16", "float16", "fp16",
               "half"}
# tensor methods that cast to a narrow float type
_F32_METHODS = {"float"}


class DtypeDisciplineRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        if ctx.path in ctx.config.engine_modules:
            out.extend(self._check_ctors(ctx))
        out.extend(self._check_bit_identity(ctx))
        return out

    def _check_ctors(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None or "." not in name:
                continue
            base, leaf = name.rsplit(".", 1)
            if base == "torch" and leaf in _TORCH_CTORS:
                # torch takes dtype only by keyword (sizes may be varargs)
                if not any(kw.arg == "dtype" for kw in node.keywords):
                    out.append(ctx.violation(
                        self.id, node,
                        f"torch.{leaf}(...) without dtype= in an engine "
                        f"module: the f64 bit-identity chain must not "
                        f"depend on torch's default dtype (float32!)"))
                continue
            if base not in ("np", "numpy", "jnp") or leaf not in _CTORS:
                continue
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
            # np.full(shape, fill, dtype) — third positional counts too.
            if leaf == "full" and len(node.args) >= 3:
                has_dtype = True
            elif leaf != "full" and len(node.args) >= 2:
                has_dtype = True
            if not has_dtype:
                out.append(ctx.violation(
                    self.id, node,
                    f"{base}.{leaf}(...) without dtype= in an engine "
                    f"module: the f64 bit-identity chain must not "
                    f"depend on platform defaults"
                    + (" (jnp defaults to float32!)"
                       if base == "jnp" else "")))
        return out

    def _check_bit_identity(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        targets = set(ctx.config.bit_identity_funcs)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node.name not in targets:
                continue
            for sub in ast.walk(node):
                token = None
                if isinstance(sub, ast.Attribute) and \
                        sub.attr in _F32_TOKENS:
                    token = sub.attr
                elif isinstance(sub, ast.Name) and sub.id in _F32_TOKENS:
                    token = sub.id
                elif isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str) and \
                        sub.value in _F32_TOKENS:
                    token = sub.value
                elif isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute) and \
                        sub.func.attr in _F32_METHODS and not sub.args \
                        and not sub.keywords:
                    token = f".{sub.func.attr}()"
                if token:
                    out.append(ctx.violation(
                        self.id, sub,
                        f"'{token}' inside bit-identity function "
                        f"'{node.name}': consensus/migration must stay "
                        f"f64 end-to-end or the bit-for-bit migration "
                        f"identity breaks"))
        return out
