"""Coordinator: orchestration, fusion, chat turns, hypothesis workflow."""

from rca_tpu_torch.coordinator.core import RCACoordinator
from rca_tpu_torch.coordinator.correlate import (
    correlate_deterministic,
    correlate_findings,
    correlate_torch,
    default_backend,
    group_findings,
    resolve_backend,
)
from rca_tpu_torch.coordinator.structured import (
    build_suggestions,
    cluster_state_counts,
    format_structured_response,
    merge_llm_structured,
)

__all__ = [
    "RCACoordinator",
    "build_suggestions",
    "cluster_state_counts",
    "correlate_deterministic",
    "correlate_findings",
    "correlate_torch",
    "default_backend",
    "format_structured_response",
    "group_findings",
    "merge_llm_structured",
    "resolve_backend",
]
