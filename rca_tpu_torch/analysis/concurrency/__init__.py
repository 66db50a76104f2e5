"""gravelock for the port: interprocedural race & deadlock analysis +
runtime rsan (the port's copy of ``rca_tpu.analysis.concurrency``).

The static half builds one whole-package concurrency model of
``rca_tpu_torch/`` per lint run (:mod:`model`): thread roots and their
reachable functions, a call graph with held-lock propagation, per-class
guarded-by inference (:mod:`races`) and the interprocedural lock-order
graph (:mod:`lockorder`).  Findings surface through the graftlint rules
``race-guard`` and ``lock-order``
(rca_tpu_torch/analysis/rules/gravelock.py) with the normal suppression /
baseline / exit-code contract.

The dynamic half (:mod:`rsan`) is a lock sanitizer the
:mod:`rca_tpu_torch.util.threads` constructors route through when enabled
(``RCA_RSAN=1``): it records real acquisition orders and same-attribute
access pairs, and :mod:`crosscheck` fails the lint when an observed
order edge contradicts the static graph or an observed unguarded access
pair matches (or should have matched) a static finding.

Import discipline: this package must stay import-light — ``util.threads``
pulls :mod:`rsan` inside every lock construction when the sanitizer is
on, and the model modules are pure AST (no torch).
"""

from rca_tpu_torch.analysis.concurrency.model import (  # noqa: F401
    ConcurrencyModel,
    model_for,
)
