"""Deterministic structured-response builder + suggestion scoring.

Parity with the reference's chat-turn backfill machinery (reference:
agents/mcp_coordinator.py — ``_format_structured_response`` :59-241: counts
by status/restart/exit-code, severity scoring CrashLoopBackOff=10 >
Error/Failed=8 > ImagePullBackOff=6 :192-201; severity-scored suggestion
builder :1424-1460; response-schema backfill :1370-1567).  The reference
computed these counts in per-pod Python loops; here they are vector ops
over the packed pod-feature array.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from rca_tpu_torch.agents.base import AnalysisContext
from rca_tpu_torch.features.schema import PodF

# waiting-reason severity ladder (reference: mcp_coordinator.py:192-201)
REASON_SCORES = {
    "CrashLoopBackOff": 10,
    "Error": 8,
    "Failed": 8,
    "OOMKilled": 8,
    "CreateContainerConfigError": 7,
    "ImagePullBackOff": 6,
    "ErrImagePull": 6,
    "Pending": 5,
    "NotReady": 4,
}


def cluster_state_counts(ctx: AnalysisContext) -> Dict[str, Any]:
    """Exact counts for the constrained chat prompt (the reference demanded
    the LLM restate these; we compute them once and never let the LLM
    invent them, reference: mcp_coordinator.py:1311-1333)."""
    fs = ctx.features
    pf = fs.pod_features
    P = fs.num_pods
    phases = {
        "Pending": int(pf[:, PodF.PHASE_PENDING].sum()),
        "Running": int(pf[:, PodF.PHASE_RUNNING].sum()),
        "Succeeded": int(pf[:, PodF.PHASE_SUCCEEDED].sum()),
        "Failed": int(pf[:, PodF.PHASE_FAILED].sum()),
        "Unknown": int(pf[:, PodF.PHASE_UNKNOWN].sum()),
    }
    problem_mask = (
        (pf[:, PodF.WAIT_CRASHLOOP] > 0)
        | (pf[:, PodF.WAIT_IMAGEPULL] > 0)
        | (pf[:, PodF.WAIT_CONFIG] > 0)
        | (pf[:, PodF.INIT_FAILED] > 0)
        | (pf[:, PodF.PHASE_FAILED] > 0)
        | (pf[:, PodF.PHASE_PENDING] > 0)
        | (pf[:, PodF.PHASE_UNKNOWN] > 0)
        | (pf[:, PodF.NOT_READY] > 0)
    )
    problem_idx = np.nonzero(problem_mask)[0]
    problems: List[Dict[str, Any]] = []
    for i in problem_idx.tolist():
        reasons = []
        if pf[i, PodF.WAIT_CRASHLOOP] > 0:
            reasons.append("CrashLoopBackOff")
        if pf[i, PodF.WAIT_IMAGEPULL] > 0:
            reasons.append("ImagePullBackOff")
        if pf[i, PodF.WAIT_CONFIG] > 0:
            reasons.append("CreateContainerConfigError")
        if pf[i, PodF.INIT_FAILED] > 0:
            reasons.append("InitContainerFailed")
        if pf[i, PodF.PHASE_FAILED] > 0:
            reasons.append("Failed")
        if pf[i, PodF.PHASE_PENDING] > 0:
            reasons.append("Pending")
        if pf[i, PodF.PHASE_UNKNOWN] > 0:
            reasons.append("Unknown")
        if not reasons and pf[i, PodF.NOT_READY] > 0:
            reasons.append("NotReady")
        score = max(
            (REASON_SCORES.get(x, 3) for x in reasons), default=3
        ) + min(int(pf[i, PodF.RESTARTS]), 5)
        problems.append(
            {
                "pod": fs.pod_names[i],
                "reasons": reasons,
                "restarts": int(pf[i, PodF.RESTARTS]),
                "severity_score": score,
            }
        )
    problems.sort(key=lambda p: -p["severity_score"])
    warning_events = sum(
        int(e.get("count", 1) or 1)
        for e in ctx.snapshot.events
        if e.get("type") != "Normal"
    )
    state = {
        "namespace": ctx.snapshot.namespace,
        "total_pods": P,
        "pods_by_phase": {k: v for k, v in phases.items() if v},
        "problem_pods": problems,
        "problem_pod_count": len(problems),
        "total_restarts": int(pf[:, PodF.RESTARTS].sum()),
        "warning_event_count": warning_events,
        "services": fs.service_names,
    }
    if ctx.snapshot.errors:
        # partial snapshot: keep the chat turn honest about what's missing —
        # presence + op names, not the full dump (the client buffer caps at
        # 100x300-char entries, far too much to embed in every LLM prompt)
        state["fetch_errors"] = ctx.snapshot.errors[-10:]
        state["fetch_error_count"] = len(ctx.snapshot.errors)
    return state


def format_structured_response(
    ctx: AnalysisContext, query: str = ""
) -> Dict[str, Any]:
    """The deterministic response the chat turn falls back to / backfills
    from (reference: mcp_coordinator.py:59-241)."""
    state = cluster_state_counts(ctx)
    points = [
        f"{state['total_pods']} pods in namespace "
        f"'{state['namespace']}': "
        + ", ".join(f"{v} {k}" for k, v in state["pods_by_phase"].items())
    ]
    if state["problem_pods"]:
        worst = state["problem_pods"][0]
        points.append(
            f"{state['problem_pod_count']} pod(s) show problems; most severe: "
            f"{worst['pod']} ({', '.join(worst['reasons'])}, "
            f"{worst['restarts']} restarts)"
        )
    else:
        points.append("No problem pods detected.")
    if state["warning_event_count"]:
        points.append(
            f"{state['warning_event_count']} warning events recorded."
        )
    sections = [
        {
            "title": "Problem pods",
            "content": [
                f"{p['pod']}: {', '.join(p['reasons'])} "
                f"(restarts {p['restarts']}, score {p['severity_score']})"
                for p in state["problem_pods"][:10]
            ] or ["none"],
        }
    ]
    summary = points[1] if state["problem_pods"] else points[0]
    return {
        "response_data": {"points": points, "sections": sections},
        "summary": summary,
        "suggestions": build_suggestions(state),
        "key_findings": [
            f"{p['pod']}: {', '.join(p['reasons'])}"
            for p in state["problem_pods"][:5]
        ],
        "cluster_state": state,
    }


def build_suggestions(
    state: Dict[str, Any], max_suggestions: int = 5
) -> List[Dict[str, Any]]:
    """Severity-scored next actions (reference: mcp_coordinator.py:1424-1460
    priority ladder; action types per :3173-3314 dispatch)."""
    out: List[Dict[str, Any]] = []
    for p in state["problem_pods"][:3]:
        reason = p["reasons"][0] if p["reasons"] else "NotReady"
        if reason in ("CrashLoopBackOff", "Failed", "Error"):
            out.append(
                {
                    "text": f"Check logs of {p['pod']}",
                    "priority": "high",
                    "reasoning": f"{reason} with {p['restarts']} restarts — "
                    "the crash cause is in the logs",
                    "action": {
                        "type": "check_logs",
                        "pod_name": p["pod"],
                        "previous": reason == "CrashLoopBackOff",
                    },
                }
            )
        elif reason in ("ImagePullBackOff", "ErrImagePull"):
            out.append(
                {
                    "text": f"Inspect events of {p['pod']}",
                    "priority": "high",
                    "reasoning": "image pull errors carry the registry "
                    "message in events",
                    "action": {
                        "type": "check_events",
                        "kind": "Pod",
                        "name": p["pod"],
                    },
                }
            )
        else:
            out.append(
                {
                    "text": f"Describe {p['pod']}",
                    "priority": "medium",
                    "reasoning": f"{reason} — the manifest/status detail "
                    "narrows the cause",
                    "action": {
                        "type": "check_resource",
                        "kind": "Pod",
                        "name": p["pod"],
                    },
                }
            )
    if state["warning_event_count"]:
        out.append(
            {
                "text": "Review warning events",
                "priority": "medium",
                "reasoning": f"{state['warning_event_count']} warning events "
                "may explain the symptoms",
                "action": {"type": "run_agent", "agent_type": "events"},
            }
        )
    out.append(
        {
            "text": "Run comprehensive analysis",
            "priority": "medium" if state["problem_pods"] else "low",
            "reasoning": "correlates metrics, logs, events, topology and "
            "traces into ranked root causes",
            "action": {"type": "run_agent", "agent_type": "comprehensive"},
        }
    )
    return out[:max_suggestions]


def merge_llm_structured(
    base: Dict[str, Any], llm_out: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    """Overlay LLM-provided fields on the deterministic response, keeping
    the deterministic value for anything missing/malformed (reference
    backfill: mcp_coordinator.py:1370-1567)."""
    if not isinstance(llm_out, dict):
        return base
    merged = dict(base)
    rd = llm_out.get("response_data")
    if isinstance(rd, dict) and rd.get("points"):
        merged["response_data"] = rd
    summary = llm_out.get("summary")
    if (
        isinstance(summary, str)
        and summary.strip()
        # the hermetic provider's canned placeholder must not displace the
        # counts-derived deterministic summary ("3 of 6 pods unhealthy...")
        # the backfill computed — placeholder text is worse than backfill
        and not summary.strip().lower().startswith("offline deterministic")
    ):
        merged["summary"] = summary.strip()
    sugg = llm_out.get("suggestions")
    if isinstance(sugg, list) and sugg:
        cleaned = []
        for s in sugg:
            if isinstance(s, dict) and s.get("text"):
                cleaned.append(
                    {
                        "text": str(s["text"]),
                        "priority": str(s.get("priority", "medium")),
                        "reasoning": str(s.get("reasoning", "")),
                        "action": s.get("action")
                        if isinstance(s.get("action"), dict)
                        else {"type": "query", "query": str(s["text"])},
                    }
                )
        if cleaned:
            merged["suggestions"] = cleaned
    kf = llm_out.get("key_findings")
    if isinstance(kf, list) and kf:
        merged["key_findings"] = [str(x) for x in kf if x][:10]
    return merged
