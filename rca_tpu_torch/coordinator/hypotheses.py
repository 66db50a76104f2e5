"""Guided hypothesis workflow: hypotheses → plan → steps → verdict → report.

Parity with the reference's interactive-session backend (reference:
agents/mcp_coordinator.py — ``generate_hypotheses`` :2232 (3-5 hypotheses
with confidence + investigation steps), ``get_investigation_plan`` :2377,
``execute_investigation_step`` :2542 (kubectl/logs/events per step kind),
``_analyze_investigation_evidence`` :2699 (supported/refuted/inconclusive +
confidence), ``_get_evidence_for_component`` :2857 (per-kind evidence),
``generate_root_cause_report`` :3026).  Every LLM-backed stage has a
deterministic twin so the workflow is fully functional offline.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from rca_tpu_torch.features.logscan import LOG_PATTERN_NAMES, scan_text

# deterministic hypothesis templates keyed by symptom keywords
# (the reference asked the LLM; offline we derive from the finding itself)
_TEMPLATES = [
    (("crashloop", "crash", "restart"), [
        ("Application crashes on startup due to a missing or invalid "
         "dependency (config, secret, or reachable backend)", 0.6),
        ("Liveness probe is misconfigured and kills a healthy container",
         0.3),
        ("Container exits after OOM or resource exhaustion", 0.25),
    ]),
    (("imagepull", "image"), [
        ("Image tag does not exist in the registry", 0.5),
        ("Registry credentials (imagePullSecrets) are missing or invalid",
         0.4),
        ("Registry is unreachable from the node network", 0.2),
    ]),
    (("oom", "memory"), [
        ("Memory limit is set below the application's working set", 0.6),
        ("A memory leak grows the footprint until the limit is hit", 0.35),
    ]),
    (("pending", "schedul"), [
        ("No node has capacity for the pod's resource requests", 0.5),
        ("Node taints or affinity rules exclude every node", 0.35),
        ("A referenced PVC is unbound, blocking scheduling", 0.25),
    ]),
    (("selector", "endpoint", "no pods"), [
        ("Service selector labels do not match the workload's pod labels",
         0.6),
        ("The backing workload was never deployed or was scaled to zero",
         0.3),
    ]),
    (("config", "secret"), [
        ("A referenced ConfigMap/Secret does not exist in the namespace",
         0.6),
        ("The referenced key exists but holds a wrong/renamed value", 0.3),
    ]),
    (("cpu", "throttl"), [
        ("CPU limit is set below the workload's sustained demand", 0.55),
        ("A runaway loop consumes all available CPU", 0.35),
    ]),
    (("env", "environment variable"), [
        ("A required environment variable is not set in the pod spec", 0.65),
        ("The env var references a missing ConfigMap/Secret key", 0.3),
    ]),
]

_FALLBACK = [
    ("The component's configuration changed recently and broke it", 0.35),
    ("An upstream dependency of the component is failing", 0.3),
    ("The component is resource-starved (CPU, memory, or IO)", 0.25),
]


def _default_steps(component: str) -> List[Dict[str, Any]]:
    kind = component.split("/", 1)[0] if "/" in component else "Pod"
    name = component.split("/", 1)[1] if "/" in component else component
    steps = [
        {"description": f"Describe {kind} {name} and inspect its status",
         "type": "describe", "kind": kind, "name": name},
        {"description": f"Fetch recent events for {kind} {name}",
         "type": "events", "kind": kind, "name": name},
    ]
    if kind == "Pod":
        steps.insert(
            1,
            {"description": f"Read current and previous logs of {name}",
             "type": "logs", "name": name},
        )
    return steps


def generate_hypotheses(
    coord, component: str, finding: Dict[str, Any], namespace: str,
    investigation_id: str = "",
) -> List[Dict[str, Any]]:
    """3-5 hypotheses with confidence + investigation steps."""
    issue = str(finding.get("issue", "")).lower()
    evidence = _get_evidence_for_component(coord, component, namespace)

    llm_out = coord.llm.generate_structured_output(
        "Component: " + component + "\nFinding: "
        + json.dumps({k: finding.get(k) for k in ("issue", "severity",
                                                  "evidence")}, default=str)[:3000]
        + "\nEvidence: " + json.dumps(evidence, default=str)[:3000]
        + '\n\nPropose 3-5 root-cause hypotheses as JSON: {"hypotheses": '
        '[{"description": "...", "confidence": 0.0, "investigation_steps": '
        '["..."]}]}',
        kind="hypotheses",
    )
    hypotheses: List[Dict[str, Any]] = []
    for h in (llm_out or {}).get("hypotheses", []) or []:
        if isinstance(h, dict) and h.get("description"):
            steps = [
                {"description": str(s), "type": "describe",
                 "kind": component.split("/")[0], "name": component.split("/")[-1]}
                if isinstance(s, str) else s
                for s in h.get("investigation_steps", []) or []
            ]
            hypotheses.append(
                {
                    "description": str(h["description"]),
                    "confidence": float(h.get("confidence", 0.3) or 0.3),
                    "component": component,
                    "investigation_steps": steps or _default_steps(component),
                }
            )
    if not hypotheses:
        ranked = _FALLBACK
        for keywords, templates in _TEMPLATES:
            if any(k in issue for k in keywords):
                ranked = templates
                break
        hypotheses = [
            {
                "description": desc,
                "confidence": conf,
                "component": component,
                "investigation_steps": _default_steps(component),
            }
            for desc, conf in ranked
        ]
    hypotheses.sort(key=lambda h: -h["confidence"])
    hypotheses = hypotheses[:5]
    if coord.evidence is not None:
        for h in hypotheses:
            coord.evidence.log_hypothesis(
                investigation_id, component, h, evidence=evidence,
            )
    return hypotheses


def get_investigation_plan(
    coord, hypothesis: Dict[str, Any], namespace: str
) -> Dict[str, Any]:
    steps = hypothesis.get("investigation_steps") or _default_steps(
        str(hypothesis.get("component", "Pod/unknown"))
    )
    return {
        "hypothesis": hypothesis.get("description", ""),
        "component": hypothesis.get("component", ""),
        "steps": [
            {**s, "index": i, "status": "pending"}
            for i, s in enumerate(steps)
        ],
    }


def execute_investigation_step(
    coord, step: Dict[str, Any], hypothesis: Dict[str, Any],
    namespace: str, investigation_id: str = "",
) -> Dict[str, Any]:
    """Run one evidence-gathering step, then judge the hypothesis."""
    stype = str(step.get("type", "describe"))
    name = str(step.get("name", ""))
    kind = str(step.get("kind", "Pod"))
    try:
        if stype == "logs":
            current = coord.cluster.get_pod_logs(
                namespace, name, tail_lines=100
            )
            previous = ""
            from rca_tpu_torch.resilience.policy import suppressed

            with suppressed("hypotheses.previous_logs"):
                previous = coord.cluster.get_pod_logs(
                    namespace, name, previous=True, tail_lines=100
                )
            result: Any = {"logs": current[-4000:],
                           "previous_logs": previous[-4000:]}
        elif stype == "events":
            result = coord.cluster.get_events(
                namespace,
                field_selector=(
                    f"involvedObject.kind={kind},involvedObject.name={name}"
                ),
            )[:30]
        else:  # describe / kubectl
            result = coord.cluster.get_resource_details(namespace, kind, name)
    except Exception as e:
        result = {"error": f"{type(e).__name__}: {e}"}

    verdict = _analyze_investigation_evidence(coord, hypothesis, step, result)
    if coord.evidence is not None:
        coord.evidence.log_investigation_step(
            investigation_id, str(hypothesis.get("component", "")),
            step, result=result, verdict=verdict,
        )
    return {"step": step, "result": result, "verdict": verdict}


def _analyze_investigation_evidence(
    coord, hypothesis: Dict[str, Any], step: Dict[str, Any], result: Any
) -> Dict[str, Any]:
    """supported / refuted / inconclusive + confidence (reference:
    mcp_coordinator.py:2699-2857)."""
    llm_out = coord.llm.generate_structured_output(
        "Hypothesis: " + str(hypothesis.get("description", ""))
        + "\nStep: " + str(step.get("description", ""))
        + "\nEvidence: " + json.dumps(result, default=str)[:4000]
        + '\n\nJudge the hypothesis. JSON: {"verdict": '
        '"supported|refuted|inconclusive", "confidence": 0.0, '
        '"reasoning": "..."}',
        kind="verdict",
    )
    verdict = (llm_out or {}).get("verdict")
    if verdict in ("supported", "refuted", "inconclusive"):
        return {
            "verdict": verdict,
            "confidence": float((llm_out or {}).get("confidence", 0.5) or 0.5),
            "reasoning": str((llm_out or {}).get("reasoning", "")),
        }
    # deterministic judgement: keyword overlap between hypothesis and
    # error-classed evidence
    text = json.dumps(result, default=str).lower()
    counts = scan_text(text)
    hit_classes = {
        LOG_PATTERN_NAMES[i] for i in range(len(counts)) if counts[i] > 0
    }
    desc = str(hypothesis.get("description", "")).lower()
    signal_map = {
        "oom_kill": ("memory", "oom"),
        "image_pull": ("image", "registry", "tag"),
        "config_error": ("config", "secret"),
        "connection_refused": ("dependency", "backend", "upstream",
                               "reachable"),
        "crash_loop": ("crash", "startup"),
        "permission_denied": ("rbac", "permission"),
        "dns_resolution": ("dns",),
        "timeout": ("timeout", "slow"),
        "authentication": ("credential", "auth", "token"),
        "exception": ("crash", "error", "broke", "failing", "variable",
                      "dependency"),
    }
    supported = any(
        any(k in desc for k in signal_map.get(cls, ()))
        for cls in hit_classes
    )
    if supported:
        return {
            "verdict": "supported",
            "confidence": 0.6,
            "reasoning": "Evidence contains error classes matching the "
            f"hypothesis: {sorted(hit_classes)}",
        }
    if hit_classes:
        return {
            "verdict": "inconclusive",
            "confidence": 0.4,
            "reasoning": "Evidence shows errors "
            f"({sorted(hit_classes)}) but not the hypothesized class",
        }
    return {
        "verdict": "inconclusive",
        "confidence": 0.3,
        "reasoning": "No error signal in the gathered evidence",
    }


def _get_evidence_for_component(
    coord, component: str, namespace: str
) -> Dict[str, Any]:
    """Per-kind evidence gathering (reference: mcp_coordinator.py:2857-3016)."""
    kind, _, name = component.partition("/")
    kind = kind or "Pod"
    out: Dict[str, Any] = {"component": component}
    try:
        if kind.lower() == "pod":
            pod = coord.cluster.get_pod(namespace, name)
            out["status"] = (pod or {}).get("status", {})
            from rca_tpu_torch.resilience.policy import suppressed

            with suppressed("hypotheses.log_tail"):
                out["log_tail"] = coord.cluster.get_pod_logs(
                    namespace, name, tail_lines=50
                )[-2000:]
        elif kind.lower() == "deployment":
            out["deployment"] = coord.cluster.get_deployment(namespace, name)
        elif kind.lower() == "service":
            out["service"] = coord.cluster.get_service(namespace, name)
            out["endpoints"] = [
                e for e in coord.cluster.get_endpoints(namespace)
                if e.get("metadata", {}).get("name") == name
            ]
        elif kind.lower() in ("pvc", "persistentvolumeclaim"):
            out["pvc"] = coord.cluster.get_pvc(namespace, name)
        else:
            out["details"] = coord.cluster.get_resource_details(
                namespace, kind, name
            )
        out["events"] = coord.cluster.get_events(
            namespace,
            field_selector=(
                f"involvedObject.kind={kind},involvedObject.name={name}"
            ),
        )[:20]
        nodes = coord.cluster.get_nodes()
        out["cluster_nodes"] = [
            {
                "name": n.get("metadata", {}).get("name", ""),
                "ready": any(
                    c.get("type") == "Ready" and c.get("status") == "True"
                    for c in n.get("status", {}).get("conditions", []) or []
                ),
            }
            for n in nodes
        ]
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def generate_root_cause_report(coord, session: Dict[str, Any]) -> str:
    """Markdown report from the guided session's history (reference:
    mcp_coordinator.py:3026-3116)."""
    component = str(session.get("component", "unknown"))
    hypothesis = session.get("accepted_hypothesis") or {}
    steps = session.get("steps", [])
    lines = [
        f"# Root Cause Report — {component}",
        "",
        "## Conclusion",
        f"**{hypothesis.get('description', 'No hypothesis accepted')}**",
        f"(confidence {hypothesis.get('confidence', 0):.0%})"
        if hypothesis else "",
        "",
        "## Investigation trail",
    ]
    for i, s in enumerate(steps):
        verdict = s.get("verdict", {})
        lines.append(
            f"{i + 1}. {s.get('step', {}).get('description', 'step')} → "
            f"**{verdict.get('verdict', 'n/a')}** "
            f"({verdict.get('confidence', 0):.0%}) — "
            f"{verdict.get('reasoning', '')}"
        )
    finding = session.get("finding")
    if finding:
        lines += [
            "",
            "## Originating finding",
            f"- {finding.get('issue', '')} [{finding.get('severity', '')}]",
            f"- Recommendation: {finding.get('recommendation', '')}",
        ]
    llm_text = coord.llm.generate_completion(
        "Polish this root-cause report, keeping all facts:\n"
        + "\n".join(lines),
        kind="report",
    )
    if llm_text and not llm_text.startswith("Offline analysis"):
        return llm_text
    return "\n".join(line for line in lines if line is not None)
