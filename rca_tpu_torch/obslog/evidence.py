"""EvidenceLogger: per-hypothesis / per-step / per-conclusion JSON audit files.

Format parity with the reference (reference: utils/logging_helper.py —
``log_hypothesis`` :32, ``log_investigation_step`` :69, ``log_conclusion``
:107, retrieval by filename scan + description match
``get_evidence_for_hypothesis`` :144).  Filenames keep the reference's
``<ts>_<component-kind>_<slug>_<kind>.json`` shape so archived evidence
remains greppable the same way.
"""

from __future__ import annotations

import datetime
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional


def _slug(text: str, max_len: int = 40) -> str:
    s = re.sub(r"[^A-Za-z0-9]+", "-", text).strip("-")
    return s[:max_len] or "item"


class EvidenceLogger:
    """Writes the audit files under ``root`` (default
    ``<RCA_LOG_DIR>/evidence``, ``logs/evidence`` when unset)."""

    def __init__(self, root: Optional[str] = None):
        if root is None:
            from rca_tpu_torch.config import log_dir

            root = f"{log_dir()}/evidence"
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _write(self, kind: str, component: str, title: str,
               payload: Dict[str, Any]) -> Path:
        ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = self.root / f"{ts}_{_slug(component)}_{_slug(title)}_{kind}.json"
        payload = {
            "logged_at": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "kind": kind,
            **payload,
        }
        path.write_text(json.dumps(payload, indent=2, default=str))
        return path

    def log_hypothesis(
        self,
        investigation_id: str,
        component: str,
        hypothesis: Dict[str, Any],
        evidence: Any = None,
    ) -> Path:
        return self._write(
            "hypothesis", component,
            str(hypothesis.get("description", "hypothesis")),
            {
                "investigation_id": investigation_id,
                "component": component,
                "hypothesis": hypothesis,
                "evidence": evidence,
            },
        )

    def log_investigation_step(
        self,
        investigation_id: str,
        component: str,
        step: Dict[str, Any],
        result: Any = None,
        verdict: Optional[Dict[str, Any]] = None,
    ) -> Path:
        return self._write(
            "step", component, str(step.get("description", "step")),
            {
                "investigation_id": investigation_id,
                "component": component,
                "step": step,
                "result": result,
                "verdict": verdict,
            },
        )

    def log_conclusion(
        self,
        investigation_id: str,
        component: str,
        conclusion: Dict[str, Any],
    ) -> Path:
        return self._write(
            "conclusion", component,
            str(conclusion.get("root_cause", "conclusion")),
            {
                "investigation_id": investigation_id,
                "component": component,
                "conclusion": conclusion,
            },
        )

    def get_evidence_for_hypothesis(
        self, description: str
    ) -> List[Dict[str, Any]]:
        """Scan logged hypothesis files whose description matches
        (reference: logging_helper.py:144)."""
        out = []
        for path in sorted(self.root.glob("*_hypothesis.json")):
            try:
                rec = json.loads(path.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            desc = str(
                (rec.get("hypothesis") or {}).get("description", "")
            )
            if description.lower() in desc.lower():
                out.append(rec)
        return out
