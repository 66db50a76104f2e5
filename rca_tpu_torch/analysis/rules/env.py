"""Rule ``env-discipline``: raw ``os.environ`` reads live in config.py
only.

Every env knob in ``rca_tpu_torch/`` resolves through the range/choice-
validated accessors in :mod:`rca_tpu_torch.config` (``env_str`` /
``env_int`` / ``env_raw``), so a typo'd value fails loudly in exactly one
place instead of silently selecting a default deep in the engine.  Scope
is the ``rca_tpu_torch`` package: ``chip_smoke.py`` and the tests manage
process environments deliberately and are exempt.
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

ALLOWED_FILE = "rca_tpu_torch/config.py"

MESSAGE = (
    "raw os.environ read outside rca_tpu_torch/config.py — route it "
    "through a range-validated accessor (config.env_str / env_int / "
    "env_raw)"
)


@register
class EnvDisciplineRule(Rule):
    name = "env-discipline"
    summary = ("os.environ / os.getenv only in rca_tpu_torch/config.py — "
               "everything else uses the validated accessors")
    why = ("a scattered raw read means a typo'd knob silently falls back "
           "to a default: the operator asked for a layout/depth/cache and "
           "quietly did not get it")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("rca_tpu_torch/") and relpath != ALLOWED_FILE

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if (isinstance(node, ast.Attribute)
                    and node.attr in ("environ", "getenv")
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "os"):
                hits.append(ctx.finding(self, node.lineno, MESSAGE,
                                        func=func))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
        return hits
