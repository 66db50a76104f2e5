"""graftlint for the port: static rules over ``rca_tpu_torch/``,
``chip_smoke.py`` and ``tests/test_torch_*.py`` — 15 of the JAX package's
18: gravelock's race and lock-order rules over the port's concurrency
model, and graftspec's ``dtype-discipline`` and ``shape-contract`` over
the port's abstract interpreter of torch ops (``dataplane/absint.py``),
among them; ``tracer-leak``, ``retrace-hazard`` and ``donation-guard``
have no subject in the port (no jit, no trace, no donated buffer) — with
the runtime recompile gate (``tracecheck.py``), the runtime lock
sanitizer's cross-check (``concurrency/crosscheck.py``) and the
fetch-budget cross-check (``dataplane/specsan.py``).

Usage::

    python -m rca_tpu_torch.analysis            # or: python -m rca_tpu_torch lint
    python -m rca_tpu_torch.analysis --json
    python -m rca_tpu_torch.analysis --rsan
    python -m rca_tpu_torch.analysis --all --device cpu

Programmatic surface: :func:`run_lint` (static rules),
:func:`run_tracecheck` (runtime recompile gate), :func:`all_rules`.
"""

from rca_tpu_torch.analysis.core import (
    Finding,
    LintResult,
    Rule,
    all_rules,
    default_baseline_path,
    load_baseline,
    register,
    repo_root,
    run_lint,
    write_baseline,
)
from rca_tpu_torch.analysis.tracecheck import run_tracecheck

__all__ = [
    "Finding",
    "LintResult",
    "Rule",
    "all_rules",
    "default_baseline_path",
    "load_baseline",
    "register",
    "repo_root",
    "run_lint",
    "run_tracecheck",
    "write_baseline",
]
