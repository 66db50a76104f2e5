"""Coordinator: orchestration and evidence fusion."""

from rca_tpu_torch.coordinator.core import RCACoordinator
from rca_tpu_torch.coordinator.correlate import (
    correlate_deterministic,
    correlate_findings,
    correlate_torch,
    default_backend,
    group_findings,
    resolve_backend,
)

__all__ = [
    "RCACoordinator",
    "correlate_deterministic",
    "correlate_findings",
    "correlate_torch",
    "default_backend",
    "group_findings",
    "resolve_backend",
]
