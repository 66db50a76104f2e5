"""Observability logs: per-stage timing, evidence audit files and the LLM
prompt JSONL log."""

from rca_tpu_torch.obslog.evidence import EvidenceLogger
from rca_tpu_torch.obslog.prompts import PromptLogger, get_logger

__all__ = ["EvidenceLogger", "PromptLogger", "get_logger"]
