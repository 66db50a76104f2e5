"""graftspec for the port, its runtime half: the fetch-budget contract
tables and the specsan cross-check (``lint --specsan``).

- :mod:`~rca_tpu_torch.analysis.dataplane.contracts` — the declarative
  byte budgets of the port's device→host transfers;
- :mod:`~rca_tpu_torch.analysis.dataplane.specsan` — run real engine +
  serve work with both entries of the fetch seam instrumented and diff
  the observed transfers against the contracts.
"""

from rca_tpu_torch.analysis.dataplane import contracts  # noqa: F401
from rca_tpu_torch.analysis.dataplane.specsan import (  # noqa: F401
    capture,
    confirm_findings,
    run_specsan,
)
