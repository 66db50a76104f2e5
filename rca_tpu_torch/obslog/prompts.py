"""PromptLogger: JSONL audit trail of every LLM interaction.

Record-format parity with the reference (reference: utils/prompt_logger.py
:76-89 — ``{timestamp, investigation_id, user_query, prompt, response,
namespace, accumulated_findings, additional_context{provider, model,
temperature}}``; global singleton ``get_logger`` :129; files at
``logs/prompts/prompt_log_<ts>.jsonl``).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from rca_tpu_torch.util.threads import make_lock


def _default_root() -> str:
    from rca_tpu_torch.config import log_dir

    return f"{log_dir()}/prompts"


class PromptLogger:
    """Appends one JSON line per LLM interaction to a file under ``root``
    (default ``<RCA_LOG_DIR>/prompts``, ``logs/prompts`` when unset)."""

    def __init__(self, root: Optional[str] = None):
        self.root = Path(root if root is not None else _default_root())
        self.root.mkdir(parents=True, exist_ok=True)
        ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = self.root / f"prompt_log_{ts}.jsonl"
        self._lock = make_lock("PromptLogger._lock")

    def log_interaction(
        self,
        prompt: str,
        response: str,
        investigation_id: str = "",
        user_query: str = "",
        namespace: str = "",
        accumulated_findings: Optional[List[str]] = None,
        additional_context: Optional[Dict[str, Any]] = None,
    ) -> None:
        record = {
            "timestamp": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "investigation_id": investigation_id,
            "user_query": user_query,
            "prompt": prompt,
            "response": response,
            "namespace": namespace,
            "accumulated_findings": accumulated_findings or [],
            "additional_context": additional_context or {},
        }
        line = json.dumps(record, default=str)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")

    def log_system_event(self, event: str, details: Any = None) -> None:
        self.log_interaction(
            prompt="", response="",
            additional_context={"system_event": event, "details": details},
        )

    def read_all(self) -> List[Dict[str, Any]]:
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return out

    def as_log_fn(self, investigation_id: str = "", namespace: str = ""):
        """Adapter for :class:`rca_tpu_torch.llm.client.LLMClient`'s ``log_fn``."""

        def log_fn(record: Dict[str, Any]) -> None:
            self.log_interaction(
                prompt=record.get("prompt", ""),
                response=record.get("response", ""),
                investigation_id=investigation_id,
                namespace=namespace,
                additional_context=record.get("additional_context", {}),
            )

        return log_fn


_logger: Optional[PromptLogger] = None
_logger_lock = make_lock("obslog.prompts._logger_lock")


def get_logger(root: Optional[str] = None) -> PromptLogger:
    """Process-wide singleton (reference: prompt_logger.py:129); the first
    call's ``root`` (default as :class:`PromptLogger`'s) holds."""
    global _logger
    with _logger_lock:
        if _logger is None:
            _logger = PromptLogger(root)
        return _logger
