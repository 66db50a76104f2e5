"""Evidence-conditioned follow-up suggestions.

The reference regenerates 3-5 prioritized suggestions by LLM-analyzing the
evidence each suggestion-action just gathered (reference:
agents/mcp_coordinator.py:3370-3505 — though its `_generate_suggestions_
from_analysis` references an undefined variable at :3450 and always falls
back to generics).  This module does that flow right, in two tiers:

1. **Deterministic tier** — rule tables from evidence to targeted next
   actions, naming the objects the evidence implicates: log-pattern hits
   map to the K8s object that explains them (OOM kills → describe the pod
   + pull previous logs; connection refusals → topology agent on the
   callee), event reasons map to their diagnostic next hop (BackOff →
   previous logs of the pod; FailedScheduling → resource pressure),
   resource details map to state-specific checks (CrashLoopBackOff →
   previous logs; OOMKilled last state → memory limits), findings map to
   per-component checks.
2. **LLM tier** — when a capable (non-offline) provider is configured, it
   is asked for up to two ADDITIONAL suggestions conditioned on the same
   evidence, merged behind the deterministic ones (hermetic paths never
   need the network).

Different evidence therefore yields different, targeted suggestion lists;
the generic counts-derived list (structured.build_suggestions) remains only
as the final fallback when the evidence is unremarkable.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from rca_tpu_torch.coordinator.structured import (
    build_suggestions,
    cluster_state_counts,
)
from rca_tpu_torch.features.logscan import LOG_PATTERN_NAMES

_IDX = {name: i for i, name in enumerate(LOG_PATTERN_NAMES)}


def _sugg(text: str, priority: str, reasoning: str,
          action: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "text": text, "priority": priority,
        "reasoning": reasoning, "action": action,
    }


def _dedupe_cap(tiers: List[List[Dict[str, Any]]],
                cap: int = 5) -> List[Dict[str, Any]]:
    """Merge suggestion tiers: TIER FIRST (specific > LLM > generic), then
    priority within a tier — a generic high-priority count-derived action
    must never outrank the targeted suggestion the evidence produced (that
    ordering was an earlier failure mode).  Duplicate actions drop (first
    tier wins); capped."""
    rank = {"high": 0, "medium": 1, "low": 2}
    seen = set()
    out = []
    for tier in tiers:
        for s in sorted(tier, key=lambda s: rank.get(s.get("priority"), 3)):
            key = json.dumps(s.get("action", {}), sort_keys=True, default=str)
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    return out[:cap]


# -- deterministic tier: one rule table per evidence kind -------------------

def _from_log_patterns(pod: str, counts: np.ndarray,
                       was_previous: bool) -> List[Dict[str, Any]]:
    """Log-pattern hits → the object that explains them (reference rule
    intent: agents/logs_agent.py:451-477 recommendation table, turned into
    next ACTIONS instead of prose)."""
    c = np.asarray(counts)
    hit = lambda name: c[_IDX[name]] > 0  # noqa: E731
    out: List[Dict[str, Any]] = []
    if hit("oom_kill"):
        out.append(_sugg(
            f"Describe {pod} — check memory limits",
            "high",
            f"{int(c[_IDX['oom_kill']])} OOM-kill log hits: the container "
            "is being killed at its memory limit",
            {"type": "check_resource", "kind": "Pod", "name": pod},
        ))
    if hit("crash_loop") and not was_previous:
        out.append(_sugg(
            f"Check previous logs of {pod}",
            "high",
            "crash-loop hits — the failure reason is in the LAST "
            "container's output, not the current one",
            {"type": "check_logs", "pod_name": pod, "previous": True},
        ))
    if hit("connection_refused") or hit("timeout") or hit("dns_resolution"):
        names = [n for n in ("connection_refused", "timeout",
                             "dns_resolution") if hit(n)]
        out.append(_sugg(
            "Trace the failing dependency (topology analysis)",
            "high",
            f"{', '.join(names)} hits in {pod}: an upstream service is "
            "unreachable — the dependency graph localizes which",
            {"type": "run_agent", "agent_type": "topology"},
        ))
    if hit("image_pull"):
        out.append(_sugg(
            f"Inspect events of {pod}",
            "high",
            "image-pull errors carry the registry message in events",
            {"type": "check_events", "kind": "Pod", "name": pod},
        ))
    if hit("permission_denied") or hit("authentication"):
        out.append(_sugg(
            f"Describe {pod} — check service account / RBAC",
            "medium",
            "auth/permission errors in logs point at the pod's identity "
            "configuration",
            {"type": "check_resource", "kind": "Pod", "name": pod},
        ))
    if hit("volume_mount"):
        out.append(_sugg(
            f"Inspect events of {pod}",
            "medium",
            "volume-mount errors name the PVC/secret in events",
            {"type": "check_events", "kind": "Pod", "name": pod},
        ))
    if hit("config_error"):
        out.append(_sugg(
            "Run the resource analyzer (config references)",
            "medium",
            "config errors in logs — the resource sweep validates "
            "ConfigMap/Secret references",
            {"type": "run_agent", "agent_type": "resources"},
        ))
    return out


_EVENT_REASON_RULES = {
    # reason (substring, lowercase) → (action builder, priority, why)
    "oomkill": ("check_resource", "high",
                "OOM kills: the pod is over its memory limit"),
    "backoff": ("check_logs_previous", "high",
                "restart back-off: the crash reason is in the previous "
                "container's logs"),
    "unhealthy": ("check_logs", "high",
                  "failing probes: the probe failure detail is in the "
                  "pod's logs"),
    "failedscheduling": ("run_agent_resources", "high",
                         "unschedulable: check cluster resource pressure "
                         "and requests"),
    "failedmount": ("check_resource", "medium",
                    "mount failure: the volume/PVC detail is on the pod"),
    "failedcreate": ("check_resource", "medium",
                     "create failure: the controller detail narrows it"),
    "errimage": ("check_resource", "high",
                 "image errors: verify the image reference on the pod"),
    "failed": ("check_logs", "medium",
               "failure events: the pod logs carry the error"),
}


def _from_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Event reasons → targeted next hops, naming the involved objects."""
    out: List[Dict[str, Any]] = []
    seen_objects = set()
    for ev in events[:50]:
        reason = str(ev.get("reason", "")).lower()
        obj = ev.get("involved_object", ev.get("involvedObject", {})) or {}
        name = str(obj.get("name", ""))
        kind = str(obj.get("kind", "Pod"))
        if not name or (kind, name, reason) in seen_objects:
            continue
        for key, (act, priority, why) in _EVENT_REASON_RULES.items():
            if key in reason:
                seen_objects.add((kind, name, reason))
                if act in ("check_logs", "check_logs_previous") and kind != "Pod":
                    # logs live in pods; for a Job/Deployment/ReplicaSet
                    # event the safe next hop is describing the object
                    act = "check_resource"
                if act == "check_logs_previous":
                    action = {"type": "check_logs", "pod_name": name,
                              "previous": True}
                    text = f"Check previous logs of {name}"
                elif act == "check_logs":
                    action = {"type": "check_logs", "pod_name": name}
                    text = f"Check logs of {name}"
                elif act == "run_agent_resources":
                    action = {"type": "run_agent", "agent_type": "resources"}
                    text = f"Analyze resource pressure ({name} unschedulable)"
                else:
                    action = {"type": "check_resource", "kind": kind,
                              "name": name}
                    text = f"Describe {kind}/{name}"
                out.append(_sugg(
                    text, priority,
                    f"{ev.get('reason')} on {kind}/{name}: {why}", action,
                ))
                break
    return out


def _from_resource_details(kind: str, name: str,
                           details: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Resource state → state-specific checks (reference semantics:
    resource_analyzer per-group analyzers, as next actions).  ``check_logs``
    actions are only emitted for Pods — logs live in pods, and a
    Deployment/Job name is not a pod name."""
    out: List[Dict[str, Any]] = []
    is_pod = kind == "Pod"
    blob = json.dumps(details, default=str).lower()
    if "crashloopbackoff" in blob:
        out.append(_sugg(
            f"Check previous logs of {name}" if is_pod
            else f"Inspect events of {kind}/{name}",
            "high",
            f"{kind}/{name} is crash-looping — the cause is in the "
            "previous container's output",
            {"type": "check_logs", "pod_name": name, "previous": True}
            if is_pod
            else {"type": "check_events", "kind": kind, "name": name},
        ))
    if "oomkilled" in blob:
        out.append(_sugg(
            f"Review memory limits of {name}",
            "high",
            f"{kind}/{name} was OOMKilled — its limit is too low or it "
            "leaks; metrics show the usage curve",
            {"type": "run_agent", "agent_type": "metrics"},
        ))
    if "imagepull" in blob or "errimagepull" in blob:
        out.append(_sugg(
            f"Inspect events of {name}",
            "high",
            "image-pull failure — the registry error detail is in events",
            {"type": "check_events", "kind": "Pod", "name": name},
        ))
    if ('"ready": false' in blob or "unhealthy" in blob) and is_pod:
        out.append(_sugg(
            f"Check logs of {name}",
            "medium",
            f"{kind}/{name} is not ready — logs show why it fails its "
            "probes",
            {"type": "check_logs", "pod_name": name},
        ))
    restarts = 0
    try:
        for cs in (details.get("status", {}) or {}).get(
            "container_statuses", []
        ) or []:
            restarts = max(restarts, int(cs.get("restart_count", 0) or 0))
    except (AttributeError, TypeError, ValueError):
        pass
    if restarts > 0 and is_pod and not any(
        s["action"].get("type") == "check_logs" for s in out
    ):
        out.append(_sugg(
            f"Check logs of {name}",
            "medium",
            f"{restarts} restarts recorded — the termination reason is "
            "in the logs",
            {"type": "check_logs", "pod_name": name},
        ))
    return out


def _from_findings(findings: List[Dict[str, Any]],
                   agent_type: str) -> List[Dict[str, Any]]:
    """Analysis findings → per-component targeted checks."""
    out: List[Dict[str, Any]] = []
    for f in findings[:6]:
        comp = str(f.get("component", ""))
        # component strings look like "Pod/name", "Service/name", or bare
        name = comp.split("/", 1)[1] if "/" in comp else comp
        kind = comp.split("/", 1)[0] if "/" in comp else ""
        issue = str(f.get("issue", "")).lower()
        if not name:
            continue
        if any(w in issue for w in ("crash", "restart", "exit")):
            if kind in ("Pod", ""):
                action = {"type": "check_logs", "pod_name": name,
                          "previous": "crash" in issue}
                text = f"Check logs of {name}"
            else:
                # logs live in pods; for Service/Deployment findings the
                # object's events carry the crash detail
                action = {"type": "check_events", "kind": kind, "name": name}
                text = f"Inspect events of {kind}/{name}"
            out.append(_sugg(
                text, "high",
                f"{agent_type} finding: {f.get('issue')}", action,
            ))
        elif any(w in issue for w in ("event", "warning")):
            out.append(_sugg(
                f"Inspect events of {name}",
                "medium",
                f"{agent_type} finding: {f.get('issue')}",
                {"type": "check_events", "kind": kind or "Pod",
                 "name": name},
            ))
        elif any(w in issue for w in ("cpu", "memory", "oom", "limit")):
            out.append(_sugg(
                f"Describe {comp} — resource configuration",
                "medium",
                f"{agent_type} finding: {f.get('issue')}",
                {"type": "check_resource", "kind": kind or "Pod",
                 "name": name},
            ))
    # the correlation engine ranks causes from ALL signals: worth re-running
    # after any single-agent evidence changed the picture
    if findings and agent_type not in ("comprehensive", "correlated"):
        out.append(_sugg(
            "Re-run the comprehensive analysis",
            "low",
            f"{len(findings)} {agent_type} finding(s) gathered — re-fusing "
            "all signals updates the root-cause ranking",
            {"type": "run_agent", "agent_type": "comprehensive"},
        ))
    return out


# -- LLM tier ---------------------------------------------------------------

def _llm_followups(llm, evidence: Dict[str, Any],
                   namespace: str) -> List[Dict[str, Any]]:
    """Up to two ADDITIONAL LLM-proposed suggestions, conditioned on the
    gathered evidence (the reference's :3370 flow, minus its NameError).
    Offline/failed providers contribute nothing — and never break the
    deterministic tier (a provider 500 degrades to [])."""
    if llm is None:
        return []
    if getattr(getattr(llm, "provider", None), "name", "") == "offline":
        # the offline provider never emits suggestions; skip the round trip
        return []
    try:
        out = _llm_followups_inner(llm, evidence, namespace)
    except Exception:
        # any provider failure (network, 5xx, auth) must not cost the
        # caller the deterministic suggestions already computed
        return []
    return out


def _llm_followups_inner(llm, evidence: Dict[str, Any],
                         namespace: str) -> List[Dict[str, Any]]:
    out = llm.generate_structured_output(
        "Given this Kubernetes investigation evidence, propose up to 2 "
        "NEXT diagnostic actions as JSON "
        '{"suggestions": [{"text": "...", "priority": "high|medium|low", '
        '"reasoning": "...", "action": {"type": "run_agent|check_resource'
        '|check_logs|check_events|query", "...": "..."}}]}. '
        "Only include actions justified by the evidence.\nEvidence:\n"
        + json.dumps(evidence, default=str)[:5000],
        namespace=namespace, kind="followups",
    )
    if not isinstance(out, dict):
        return []
    raw = out.get("suggestions", [])
    good = []
    for s in raw[:2]:
        if (
            isinstance(s, dict) and s.get("text")
            and isinstance(s.get("action"), dict)
            and s["action"].get("type") in (
                "run_agent", "check_resource", "check_logs",
                "check_events", "query",
            )
        ):
            s.setdefault("priority", "medium")
            s.setdefault("reasoning", "model-proposed follow-up")
            good.append(s)
    return good


# -- entry point ------------------------------------------------------------

def evidence_followups(
    ctx,
    evidence: Dict[str, Any],
    llm=None,
    max_suggestions: int = 5,
) -> List[Dict[str, Any]]:
    """Targeted follow-ups from the evidence an action just gathered.

    ``evidence`` is a tagged union on ``kind``:

    - ``{"kind": "logs", "pod": str, "pattern_counts": array,
       "previous": bool}``
    - ``{"kind": "events", "events": [dict, ...]}``
    - ``{"kind": "resource", "resource_kind": str, "name": str,
       "details": dict}``
    - ``{"kind": "analysis", "agent_type": str, "findings": [dict, ...]}``

    Deterministic tier first (most specific), then the LLM tier, then the
    generic counts-derived list as backfill; deduped by action, capped."""
    kind = str(evidence.get("kind", ""))
    specific: List[Dict[str, Any]] = []
    if kind == "logs":
        specific = _from_log_patterns(
            str(evidence.get("pod", "")),
            np.asarray(evidence.get("pattern_counts",
                                    np.zeros(len(LOG_PATTERN_NAMES)))),
            bool(evidence.get("previous", False)),
        )
    elif kind == "events":
        specific = _from_events(list(evidence.get("events", [])))
    elif kind == "resource":
        specific = _from_resource_details(
            str(evidence.get("resource_kind", "Pod")),
            str(evidence.get("name", "")),
            evidence.get("details", {}) or {},
        )
    elif kind == "analysis":
        specific = _from_findings(
            list(evidence.get("findings", [])),
            str(evidence.get("agent_type", "")),
        )
    # skip the LLM round trip when the deterministic tier already fills the
    # cap — those entries outrank anything the LLM tier could add
    llm_tier = (
        [] if len(specific) >= max_suggestions
        else _llm_followups(llm, evidence, getattr(ctx, "namespace", ""))
    )
    generic = build_suggestions(cluster_state_counts(ctx))
    return _dedupe_cap([specific, llm_tier, generic], cap=max_suggestions)
