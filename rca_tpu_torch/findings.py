"""Finding / reasoning-step data model shared by every agent and the engine
(the port's copy of ``rca_tpu.findings``).

Schema parity with the reference's finding dicts
(reference: agents/base_agent.py:33-52 — ``{component, issue, severity,
evidence, recommendation, timestamp}``) and its severity ladder
(reference: agents/coordinator.py:148 — info < low < medium < high < critical).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

SEVERITY_ORDER: List[str] = ["info", "low", "medium", "high", "critical"]
SEVERITY_RANK: Dict[str, int] = {s: i for i, s in enumerate(SEVERITY_ORDER)}


def severity_rank(severity: str) -> int:
    """Rank of a severity string; unknown severities rank below ``info``."""
    return SEVERITY_RANK.get(str(severity).lower(), -1)


def max_severity(severities) -> str:
    """Highest severity in an iterable (defaults to ``info`` when empty)."""
    best = "info"
    for s in severities:
        if severity_rank(s) > severity_rank(best):
            best = s
    return best


def utcnow_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def humanize_age(creation_ts: str, now_ts: str) -> str:
    """'2d ago' / '3h ago' / '5m ago' from two ISO timestamps (reference:
    utils/k8s_client.py:949-1013 adds a createdAgo humanization to
    resource details).  Unparseable inputs return ''."""
    import datetime as _dt

    def parse(ts: str):
        return _dt.datetime.fromisoformat(str(ts).replace("Z", "+00:00"))

    try:
        delta = parse(now_ts) - parse(creation_ts)
    except (ValueError, TypeError):
        return ""
    seconds = max(int(delta.total_seconds()), 0)
    if seconds >= 86400:
        return f"{seconds // 86400}d ago"
    if seconds >= 3600:
        return f"{seconds // 3600}h ago"
    if seconds >= 60:
        return f"{seconds // 60}m ago"
    return f"{seconds}s ago"


def annotate_created_ago(data: dict, now_ts: str) -> dict:
    """Add the reference's ``createdAgo`` humanization to a resource-details
    dict (shared by both cluster clients so the logic cannot drift)."""
    meta = data.get("metadata", {}) or {}
    age = humanize_age(meta.get("creationTimestamp", ""), now_ts)
    if age:
        data["createdAgo"] = age
    return data


def attach_provenance(
    obj: Dict[str, Any], provenance: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    """Attach a causelens ``provenance`` block to a findings
    JSON object (a correlate result, a finding dict) — the ONE place the
    block's schema is checked before it rides outward, so a malformed
    producer fails here instead of at a consumer.  ``None`` is a no-op
    (explain off)."""
    if provenance is None:
        return obj
    if not isinstance(provenance, dict) or not isinstance(
        provenance.get("schema"), int
    ):
        raise ValueError(
            "provenance must be a schema-versioned dict "
            "(causelens provenance_block)"
        )
    obj["provenance"] = provenance
    return obj


def make_finding(
    component: str,
    issue: str,
    severity: str,
    evidence: Any,
    recommendation: str,
    timestamp: Optional[str] = None,
    **extra: Any,
) -> Dict[str, Any]:
    finding = {
        "component": component,
        "issue": issue,
        "severity": severity,
        "evidence": evidence,
        "recommendation": recommendation,
        "timestamp": timestamp or utcnow_iso(),
    }
    finding.update(extra)
    return finding


def make_reasoning_step(
    observation: str, conclusion: str, timestamp: Optional[str] = None
) -> Dict[str, str]:
    return {
        "observation": observation,
        "conclusion": conclusion,
        "timestamp": timestamp or utcnow_iso(),
    }
