"""Rule ``no-dict-scan``: vectorized capture paths stay vectorized.

Capture assembles its views from columnar slices
(:mod:`rca_tpu_torch.cluster.columnar`); the win evaporates if an edit
quietly re-introduces a ``for pod in pods`` loop inside one of the
assembly functions.  This rule guards exactly those functions: inside the
columnar capture scope, any function whose docstring carries the
``[no-dict-scan]`` marker must contain NO ``for``/``while`` statements —
per-row work belongs in the row-write encoders (which run once per
mutation), not in the per-capture assembly.

Comprehensions over the small registries (distinct label sets, node
names, service metadata) are the documented allowlist: they are
O(distinct) rather than O(pods).  A loop that genuinely must exist in a
marked function takes a ``# graftlint: disable=no-dict-scan`` with a
justification, same as every other rule.
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

#: files whose marked functions are the vectorized capture surface
SCOPE = (
    "rca_tpu_torch/cluster/columnar.py",
    "rca_tpu_torch/features/extract.py",
    # live ingest: the watch-pump adapter's payload() is the per-capture
    # surface — per-mutation loops stay behind _sync
    "rca_tpu_torch/cluster/live_columnar.py",
)

MARKER = "[no-dict-scan]"

MESSAGE = (
    "{stmt} loop in {func}(), a [no-dict-scan]-marked vectorized capture "
    "function — per-row work belongs in the row-write encoders (paid per "
    "mutation), not in per-capture assembly; use column slices, or move "
    "the loop behind the marker boundary"
)


@register
class NoDictScanRule(Rule):
    name = "no-dict-scan"
    summary = ("no for/while statements inside [no-dict-scan]-marked "
               "capture-assembly functions — columnar capture stays "
               "O(dirty rows), not O(objects)")
    why = ("one per-pod Python loop creeping back into the assembly path "
           "silently re-inflates a 100k-pod sweep from milliseconds to "
           "seconds — the regression the columnar capture removed")

    def applies_to(self, relpath: str) -> bool:
        return relpath in SCOPE

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []

        def check_function(fn: ast.AST) -> None:
            doc = ast.get_docstring(fn) or ""
            if MARKER not in doc:
                return
            for node in ast.walk(fn):
                if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    stmt = "while" if isinstance(node, ast.While) else "for"
                    hits.append(ctx.finding(
                        self, node.lineno,
                        MESSAGE.format(stmt=stmt, func=fn.name),
                        func=fn.name,
                    ))

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                check_function(node)
        return hits
