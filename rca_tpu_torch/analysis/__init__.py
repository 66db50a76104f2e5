"""The port's analysis plane: :func:`run_tracecheck`, the runtime recompile
gate (``tracecheck.py``).  The static rules and the ``lint`` command are
not ported yet."""

from rca_tpu_torch.analysis.tracecheck import run_tracecheck

__all__ = ["run_tracecheck"]
