"""rng-discipline: all randomness must thread explicit state.

MATCHA stream identity and cross-silo determinism depend on every
random draw flowing through a seeded ``np.random.Generator``, a
``random.Random(seed)`` instance, or a seeded ``torch.Generator``.
Global ``np.random.*`` mutates hidden process state; an argless
``default_rng()`` seeds from the OS; ``torch.manual_seed`` reseeds the
process-wide torch stream, and a ``torch.rand``/``randn``/... draw
without ``generator=`` reads it.  All make runs irreproducible and —
worse — *silently* order-dependent across silos.
"""

from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation, dotted_name

RULE_ID = "rng-discipline"

# stdlib `random` module functions that draw from the global stream.
_GLOBAL_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "seed", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "triangular", "vonmisesvariate"}

# torch calls that reseed the process-wide stream.
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                       "torch.random.manual_seed", "torch.random.seed",
                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                       "torch.cuda.seed", "torch.cuda.seed_all"}
# torch draws that read the global stream unless given generator=.
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}


class RngDisciplineRule:
    id = RULE_ID

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        allowed = set(ctx.config.allowed_np_random)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if name is None:
                    continue
                parts = name.split(".")
                if len(parts) == 3 and parts[0] in ("np", "numpy") \
                        and parts[1] == "random" \
                        and parts[2] not in allowed:
                    out.append(ctx.violation(
                        self.id, node,
                        f"global-state RNG '{name}': draws mutate the "
                        f"hidden numpy global stream; thread an "
                        f"explicit np.random.default_rng(seed) "
                        f"Generator instead"))
                elif len(parts) == 2 and parts[0] == "random" \
                        and parts[1] in _GLOBAL_RANDOM_FNS:
                    out.append(ctx.violation(
                        self.id, node,
                        f"global-state RNG '{name}': use a "
                        f"random.Random(seed) instance so the stream "
                        f"is owned by the caller"))
            elif isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                if callee is None:
                    continue
                leaf = callee.rsplit(".", 1)[-1]
                if leaf == "default_rng" and not node.args \
                        and not node.keywords:
                    out.append(ctx.violation(
                        self.id, node,
                        "default_rng() without a seed draws entropy "
                        "from the OS; pass an explicit seed or "
                        "SeedSequence"))
                elif callee in _TORCH_GLOBAL_SEEDS:
                    out.append(ctx.violation(
                        self.id, node,
                        f"global-state RNG '{callee}(...)' reseeds the "
                        f"process-wide torch stream; thread a "
                        f"torch.Generator(device=...).manual_seed(seed) "
                        f"instead"))
                elif callee.startswith("torch.") \
                        and callee.count(".") == 1 \
                        and leaf in _TORCH_DRAWS and not any(
                            kw.arg == "generator" for kw in node.keywords):
                    out.append(ctx.violation(
                        self.id, node,
                        f"'{callee}(...)' without generator= draws from "
                        f"the process-wide torch stream; pass a seeded "
                        f"torch.Generator"))
        return out
