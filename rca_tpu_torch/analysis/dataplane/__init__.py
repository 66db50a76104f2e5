"""graftspec for the port: the contract tables, the abstract interpreter
behind the static rules and the specsan cross-check (``lint --specsan``).

- :mod:`~rca_tpu_torch.analysis.dataplane.contracts` — the declarative
  byte budgets of the port's device→host transfers, the ranked bodies'
  signatures, the dtype scopes and the staging modules;
- :mod:`~rca_tpu_torch.analysis.dataplane.absint` — symbolic (shape,
  dtype) facts over torch expressions, for ``shape-contract`` and
  ``dtype-discipline``;
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
