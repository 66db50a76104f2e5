"""Rule ``swallowed-faults``: no silently-discarded exceptions outside the
resilience layer.

``except Exception: pass`` / bare ``except: pass`` anywhere outside
``rca_tpu_torch/resilience/`` fails the rule.  A swallowed fault must go
through a policy — :func:`rca_tpu_torch.resilience.policy.suppressed`
records it into the bounded fault log the streaming health records drain,
so "it failed and nobody ever knew" cannot happen.  Narrow handlers
(``except OSError: pass``) stay allowed: catching a SPECIFIC exception is
a decision; catching everything and discarding it is a bug farm.  Scope:
the whole scan set (the port's tests and ``chip_smoke.py`` too).
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

ALLOWED_PREFIX = "rca_tpu_torch/resilience/"

MESSAGE = (
    "swallowed fault — replace `except Exception: pass` with "
    "rca_tpu_torch.resilience.policy.suppressed(op)"
)


def is_swallow(handler: ast.ExceptHandler) -> bool:
    """True for ``except Exception:``/bare ``except:`` whose body is only
    ``pass`` (docstring-style constants also count as doing nothing)."""
    if handler.type is not None:
        # only the catch-everything shapes are banned
        if not (isinstance(handler.type, ast.Name)
                and handler.type.id in ("Exception", "BaseException")):
            return False
    return all(
        isinstance(stmt, ast.Pass)
        or (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant))
        for stmt in handler.body
    )


@register
class SwallowedFaultsRule(Rule):
    name = "swallowed-faults"
    summary = ("no `except Exception: pass` outside "
               "rca_tpu_torch/resilience/ — swallowed faults go through "
               "policy.suppressed()")
    why = ("a fault discarded outside the policy layer leaves no record in "
           "the bounded fault log, so degraded behavior in production has "
           "no evidence trail")

    def applies_to(self, relpath: str) -> bool:
        return not relpath.startswith(ALLOWED_PREFIX)

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.ExceptHandler) and is_swallow(node):
                hits.append(ctx.finding(self, node.lineno, MESSAGE,
                                        func=func))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
        return hits
