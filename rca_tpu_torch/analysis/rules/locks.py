"""Rule ``lock-discipline``: every ``acquire()`` has a guaranteed release.

``lock.acquire()`` whose release is not guaranteed by an
immediately-following ``try/finally: lock.release()`` deadlocks every
other thread the first time the guarded body raises; ``with lock:`` is
the only shape a new early return cannot break.  Scope: all of
``rca_tpu_torch/``.  Guarded-by races (an attribute a lock owns, written
without it) are an interprocedural analysis's job, not this rule's.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

MESSAGE_ACQUIRE = (
    "`.acquire()` without an immediately-following try/finally release — "
    "use `with lock:` (an exception in the guarded body deadlocks every "
    "other thread)"
)


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    summary = "acquire() needs try/finally (prefer `with`)"
    why = ("an unreleased lock deadlocks the serve worker; every thread "
           "that touches the lock afterwards parks forever — a hang, "
           "never a crash")
    # the rsan shim's acquire() IS the passthrough this rule polices —
    # its release is the caller's contract, exactly like the primitive's
    allow = {
        "rca_tpu_torch/analysis/concurrency/rsan.py": {"acquire",
                                                       "__enter__"},
    }

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("rca_tpu_torch/")

    def scan(self, ctx: FileContext) -> List[Finding]:
        # each acquire() is judged exactly once, at its immediate
        # statement: safe only as `x.acquire()` directly followed by
        # `try: ... finally: x.release()` in the same body
        parents: Dict[ast.AST, ast.AST] = {}
        funcs: Dict[ast.AST, str] = {ctx.tree: "<module>"}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    funcs[child] = node.name

        def enclosing_func(node: ast.AST) -> str:
            cur = node
            while cur is not None:
                if cur in funcs:
                    return funcs[cur]
                cur = parents.get(cur)
            return "<module>"

        def body_of(stmt: ast.stmt) -> Optional[List[ast.stmt]]:
            parent = parents.get(stmt)
            for field in ("body", "orelse", "finalbody"):
                body = getattr(parent, field, None)
                if isinstance(body, list) and stmt in body:
                    return body
            return None

        hits: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                continue
            stmt = node
            while stmt in parents and not isinstance(stmt, ast.stmt):
                stmt = parents[stmt]
            safe = False
            body = body_of(stmt) if isinstance(stmt, ast.stmt) else None
            if (body is not None and isinstance(stmt, ast.Expr)
                    and stmt.value is node):
                i = body.index(stmt)
                nxt = body[i + 1] if i + 1 < len(body) else None
                safe = isinstance(nxt, ast.Try) and any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "release"
                    for fin in nxt.finalbody
                    for n in ast.walk(fin)
                )
            if not safe:
                hits.append(ctx.finding(
                    self, node.lineno, MESSAGE_ACQUIRE,
                    func=enclosing_func(node),
                ))
        return hits
