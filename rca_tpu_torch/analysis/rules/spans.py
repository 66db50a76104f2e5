"""Rule ``span-discipline``: spans open only via the Tracer seam, and
every opened span closes.

The tracing subsystem (``rca_tpu_torch/observability``) keeps its overhead
honest through two structural invariants this rule makes unlandable:

- **no raw spans**: ``Span(...)`` is constructed ONLY inside
  ``rca_tpu_torch/observability/spans.py`` (the seam).  A hand-built span
  bypasses the ring buffer's bounds, the null-tracer zero-cost path, and
  the id-minting discipline that keeps traces connected;
- **with-block only**: every ``.span(...)`` call is the context
  expression of a ``with`` statement — the form whose ``finally``
  guarantees the span records even when the body raises.  Phases whose
  start and end live in different methods use
  ``tracer.record(start, end, ...)``, which takes COMPLETE timestamps
  and cannot leak.

Wall-clock hygiene inside ``observability/`` is the nondet-discipline
rule's job; this rule owns the structural span contract.  Scope: the
whole scan set.
"""

from __future__ import annotations

import ast
from typing import List, Set

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

#: the one file allowed to construct Span objects
SEAM = "rca_tpu_torch/observability/spans.py"

MSG_RAW_SPAN = (
    "raw Span(...) construction outside the tracer seam "
    f"({SEAM}) — mint spans through tracer.span(...) / "
    "tracer.record(...) so they land in the bounded buffer and the "
    "RCA_TRACE=0 path stays zero-cost"
)
MSG_BARE_SPAN = (
    "bare .span(...) call — tracer.span() is a context manager and "
    "MUST be the context expression of a `with` block (its finally is "
    "what guarantees the span closes); for cross-method phases use "
    "tracer.record(start, end, ...) with complete timestamps"
)


@register
class SpanDisciplineRule(Rule):
    name = "span-discipline"
    summary = ("spans open only via the Tracer seam and always close "
               "(with-block); no raw Span construction outside it")
    why = ("an unclosed span truncates the trace of exactly the request "
           "that failed, and a hand-built span bypasses the bounded "
           "ring buffer — both turn the observability layer into a "
           "liability precisely when it is being read")

    def applies_to(self, relpath: str) -> bool:
        # repo-wide (tests included): the seam must hold everywhere
        return relpath.endswith(".py")

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []
        in_seam = ctx.relpath == SEAM

        # calls that ARE a with-item context expression are the blessed
        # form; collect their ids first, then flag every other .span(
        with_items: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        with_items.add(id(expr))

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.Call):
                callee = node.func
                if (not in_seam and isinstance(callee, ast.Name)
                        and callee.id == "Span"):
                    hits.append(ctx.finding(
                        self, node.lineno, MSG_RAW_SPAN, func=func,
                    ))
                if (isinstance(callee, ast.Attribute)
                        and callee.attr == "span"
                        and id(node) not in with_items):
                    hits.append(ctx.finding(
                        self, node.lineno, MSG_BARE_SPAN, func=func,
                    ))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
        return hits
