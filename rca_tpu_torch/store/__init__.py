"""Investigation persistence (file-locked JSON store)."""

from rca_tpu_torch.store.investigations import (
    ACCUMULATED_FINDINGS_CAP,
    InvestigationStore,
)

__all__ = ["ACCUMULATED_FINDINGS_CAP", "InvestigationStore"]
