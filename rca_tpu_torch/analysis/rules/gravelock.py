"""Rules ``race-guard`` + ``lock-order``: the gravelock static analyses
(the port's copy of ``rca_tpu.analysis.rules.gravelock``).

Both rules consult the whole-package concurrency model
(:mod:`rca_tpu_torch.analysis.concurrency`) built once per lint run from
``ctx.root`` — thread-root discovery, interprocedural held-lock
propagation, guarded-by inference, nested-acquire graph — and emit only
the findings that live in the file currently being scanned, so the
normal graftlint suppression/baseline machinery applies per line.

``race-guard`` is the guarded-by half that ``lock-discipline`` leaves
out: it knows which threads reach each write, which locks are held
across call boundaries, and which instances can actually alias — so it
covers all of ``rca_tpu_torch/`` without drowning the build in
single-threaded false positives.

``lock-order`` reports cycles in the nested-acquire graph as potential
deadlocks, with the full acquire chains (who held what where, and where
the nested acquisition happened) in the message.
"""

from __future__ import annotations

from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register


def _model(ctx: FileContext):
    from rca_tpu_torch.analysis.concurrency import model_for

    return model_for(ctx.root)


@register
class RaceGuardRule(Rule):
    name = "race-guard"
    summary = ("shared attributes written from >=2 thread roots hold "
               "their inferred guard lock at every write site")
    why = ("a lost update in serve/resilience state is a stuck request "
           "or a silently-wrong counter, never a crash — the race only "
           "fires under production concurrency, where no test is "
           "watching")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("rca_tpu_torch/")

    def scan(self, ctx: FileContext) -> List[Finding]:
        from rca_tpu_torch.analysis.concurrency.races import (
            analyze_class_attrs,
            analyze_races,
        )

        model = _model(ctx)
        hits: List[Finding] = []
        for f in analyze_races(model):
            if f.relpath == ctx.relpath:
                hits.append(ctx.finding(self, f.lineno, f.message(),
                                        func=f.func))
        for f in analyze_class_attrs(model):
            if f.relpath == ctx.relpath:
                hits.append(ctx.finding(self, f.lineno, f.message(),
                                        func=f.func))
        return hits


@register
class LockOrderRule(Rule):
    name = "lock-order"
    summary = ("the interprocedural nested-acquire graph stays acyclic "
               "(cycles are potential deadlocks, chains reported)")
    why = ("an A->B order in one call path and B->A in another deadlocks "
           "the first time the two threads interleave — typically in "
           "production under load, holding the serve queue hostage")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("rca_tpu_torch/")

    def scan(self, ctx: FileContext) -> List[Finding]:
        from rca_tpu_torch.analysis.concurrency.lockorder import (
            analyze_lock_order,
        )

        model = _model(ctx)
        return [
            ctx.finding(self, f.lineno, f.message(), func=f.func)
            for f in analyze_lock_order(model)
            if f.relpath == ctx.relpath
        ]
