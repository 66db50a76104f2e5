"""Pure render helpers (no streamlit import) — testable without the UI.

These build the markdown/plot payloads the Streamlit layer displays, parity
with the reference's render logic (reference: components/report.py:57-196
tabbed report, components/visualization.py:647-764 topology scatter data,
components/chatbot_interface.py:90-143 starter suggestions).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from rca_tpu_torch.findings import SEVERITY_ORDER as _SEVERITY_ASC  # noqa: N811
from rca_tpu_torch.findings import max_severity

SEVERITY_ICONS = {
    "critical": "🔴", "high": "🟠", "medium": "🟡", "low": "🔵", "info": "⚪",
}

# severity + node-type palettes mirror the reference's per-type renderers
# (reference: components/visualization.py:424-431 severity color map,
# :692-699 node-type colors) so chart specs carry the same visual language
SEVERITY_COLORS = {
    "critical": "#FF0000", "high": "#FF6B6B", "medium": "#FFAC4B",
    "low": "#4B93FF", "info": "#6BCB77",
}
NODE_TYPE_COLORS = {
    "service": "#00BFFF", "workload": "#FF6B6B", "deployment": "#FF6B6B",
    "ingress": "#FFAC4B", "configmap": "#6BCB77", "secret": "#9775FA",
    "unknown": "#CCCCCC",
}
# display order (most severe first) DERIVED from the canonical
# ascending order in rca_tpu_torch.findings — one source of severity truth
SEVERITY_DISPLAY_ORDER = list(reversed(_SEVERITY_ASC))


def initial_suggestions(namespace: str) -> List[Dict[str, Any]]:
    """Canned starter actions (reference: chatbot_interface.py:90-143)."""
    return [
        {"text": "Run a comprehensive analysis", "priority": "high",
         "reasoning": "correlates all signals into ranked root causes",
         "action": {"type": "run_agent", "agent_type": "comprehensive"}},
        {"text": "Check for problem pods", "priority": "medium",
         "reasoning": "fast pod-level health overview",
         "action": {"type": "query",
                    "query": f"Which pods in {namespace} have problems?"}},
        {"text": "Review warning events", "priority": "medium",
         "reasoning": "events often name the failure directly",
         "action": {"type": "run_agent", "agent_type": "events"}},
        {"text": "Inspect service topology", "priority": "low",
         "reasoning": "dependency structure shows blast radius",
         "action": {"type": "run_agent", "agent_type": "topology"}},
        {"text": "Check resource utilization", "priority": "low",
         "reasoning": "CPU/memory pressure causes cascading symptoms",
         "action": {"type": "run_agent", "agent_type": "metrics"}},
    ]


def finding_markdown(f: Dict[str, Any]) -> str:
    icon = SEVERITY_ICONS.get(str(f.get("severity", "info")).lower(), "⚪")
    return (
        f"{icon} **{f.get('component', '?')}** — {f.get('issue', '')}\n\n"
        f"- severity: `{f.get('severity', '')}`  · source: "
        f"`{f.get('source', 'rule')}`\n"
        f"- recommendation: {f.get('recommendation', '')}"
    )


def root_causes_markdown(correlated: Dict[str, Any]) -> str:
    lines = [f"### Ranked root causes ({correlated.get('backend', '?')} backend)"]
    for i, rc in enumerate(correlated.get("root_causes", [])[:10]):
        icon = SEVERITY_ICONS.get(str(rc.get("severity", "info")), "⚪")
        lines.append(
            f"{i + 1}. {icon} **{rc['component']}** — score "
            f"{rc.get('score', 0):.3f}, {rc.get('finding_count', 0)} "
            f"finding(s), max severity {rc.get('severity', '')}"
        )
    if correlated.get("engine_latency_ms"):
        lines.append(
            f"\n*Propagation latency: "
            f"{correlated['engine_latency_ms']:.1f} ms*"
        )
    return "\n".join(lines)


def response_markdown(response_data: Dict[str, Any]) -> str:
    lines = [f"- {p}" for p in response_data.get("points", [])]
    for sec in response_data.get("sections", []):
        lines.append(f"\n**{sec.get('title', '')}**")
        content = sec.get("content", [])
        if isinstance(content, list):
            lines += [f"  - {c}" for c in content]
        else:
            lines.append(f"  {content}")
    return "\n".join(lines)


def topology_plot_data(graph_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Deterministic circular layout for the typed graph — node/edge coords
    ready for any scatter backend (reference used networkx spring_layout,
    components/visualization.py:647-764; a fixed layout keeps the UI stable
    across reruns)."""
    nodes = graph_dict.get("nodes", [])
    edges = graph_dict.get("edges", [])
    n = max(len(nodes), 1)
    pos = {}
    by_type: Dict[str, List[int]] = {}
    for i, node in enumerate(nodes):
        by_type.setdefault(node.get("type", "service"), []).append(i)
    # concentric rings per node type
    ring_radius = {"service": 1.0, "workload": 1.6, "ingress": 0.5,
                   "configmap": 2.1, "secret": 2.1}
    for ntype, members in by_type.items():
        r = ring_radius.get(ntype, 1.3)
        for k, i in enumerate(members):
            theta = 2 * math.pi * k / max(len(members), 1)
            pos[nodes[i]["id"]] = (r * math.cos(theta), r * math.sin(theta))
    # node-type coloring + per-type/per-relation legends (reference:
    # components/visualization.py:647-764 draws one colored scatter trace
    # per node type and per edge type, with a legend entry each)
    drawn = [
        e for e in edges if e["source"] in pos and e["target"] in pos
    ]
    relation_counts: Dict[str, int] = {}
    for e in drawn:
        rel = e.get("relation", "") or "related"
        relation_counts[rel] = relation_counts.get(rel, 0) + 1
    return {
        "nodes": [
            {"id": node["id"], "type": node.get("type", ""),
             "color": NODE_TYPE_COLORS.get(
                 node.get("type", ""), NODE_TYPE_COLORS["unknown"]),
             "x": pos[node["id"]][0], "y": pos[node["id"]][1]}
            for node in nodes
        ],
        "edges": [
            {
                "source": e["source"], "target": e["target"],
                # same normalized label the legend counts, so legend
                # entries always match drawable edge rows
                "relation": e.get("relation", "") or "related",
                "x0": pos[e["source"]][0],
                "y0": pos[e["source"]][1],
                "x1": pos[e["target"]][0],
                "y1": pos[e["target"]][1],
            }
            for e in drawn
        ],
        "node_legend": {
            ntype: NODE_TYPE_COLORS.get(ntype, NODE_TYPE_COLORS["unknown"])
            for ntype in sorted(by_type)
        },
        "edge_legend": dict(sorted(relation_counts.items())),
    }


def analysis_viz_data(agent_type: str, result: Dict[str, Any]) -> Dict[str, Any]:
    """Chart-ready payload per analysis type (reference:
    components/visualization.py renderers per type) — severity histogram for
    every agent plus type-specific series."""
    findings = result.get("findings", [])
    sev_counts: Dict[str, int] = {}
    for f in findings:
        sev = str(f.get("severity", "info")).lower()
        sev_counts[sev] = sev_counts.get(sev, 0) + 1
    out: Dict[str, Any] = {
        "agent_type": agent_type,
        "severity_histogram": sev_counts,
        "components": sorted({str(f.get("component", "")) for f in findings}),
    }
    if agent_type == "metrics":
        out["utilization"] = [
            {"component": f["component"], **f["evidence"]}
            for f in findings
            if isinstance(f.get("evidence"), dict)
            and "usage_percentage" in f["evidence"]
        ]
    elif agent_type == "resources":
        out["pod_buckets"] = result.get("data", {}).get("pod_buckets", {})
    elif agent_type == "logs":
        patterns: Dict[str, int] = {}
        comp_sev: Dict[str, Dict[str, int]] = {}
        for f in findings:
            ev = f.get("evidence")
            if isinstance(ev, dict) and ev.get("pattern"):
                patterns[ev["pattern"]] = (
                    patterns.get(ev["pattern"], 0) + int(ev.get("count", 1))
                )
            comp = str(f.get("component", "unknown"))
            sev = str(f.get("severity", "info")).lower()
            comp_sev.setdefault(comp, {})
            comp_sev[comp][sev] = comp_sev[comp].get(sev, 0) + 1
        out["pattern_counts"] = patterns
        out["component_severity"] = comp_sev
    elif agent_type == "topology":
        out["graph"] = result.get("data", {}).get("graph", {})
        out["service_pod_mapping"] = result.get("data", {}).get(
            "service_pod_mapping", {}
        )
    elif agent_type == "traces":
        out["error_rates"] = [
            {"component": f["component"],
             "error_rate": f["evidence"]["error_rate"]}
            for f in findings
            if isinstance(f.get("evidence"), dict)
            and "error_rate" in f["evidence"]
        ]
        out["latency"] = result.get("data", {}).get("latency", {})
        out["dependencies"] = result.get("data", {}).get("dependencies", {})
    elif agent_type == "events":
        out["reason_counts"] = result.get("data", {}).get("reason_counts", {})
        out["type_counts"] = result.get("data", {}).get("type_counts", {})
        kind_counts: Dict[str, int] = {}
        for f in findings:
            comp = str(f.get("component", "unknown"))
            kind = comp.split("/", 1)[0] if "/" in comp else comp
            kind_counts[kind] = kind_counts.get(kind, 0) + 1
        out["component_kind_counts"] = kind_counts
    # severity-tagged findings rows: the table every tab can render with
    # per-row severity coloring (reference: report/resource tables)
    out["finding_rows"] = [
        {
            "severity": str(f.get("severity", "info")).lower(),
            "icon": SEVERITY_ICONS.get(
                str(f.get("severity", "info")).lower(), "⚪"
            ),
            "component": str(f.get("component", "")),
            "issue": str(f.get("issue", ""))[:120],
        }
        for f in findings
    ]
    return out


def analysis_chart_series(viz: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Renderer-agnostic chart specs for one agent's viz payload
    (reference renders per-type Plotly views, components/visualization.py
    :8-764).  Each spec is ``{"title", "kind": "bar"|"table", "data"}`` —
    ``bar`` data is {label: value}, ``table`` data is a list of row dicts —
    so the Streamlit layer can draw st.bar_chart/st.dataframe without any
    plotly dependency."""
    charts: List[Dict[str, Any]] = []
    sev = viz.get("severity_histogram") or {}
    if sev:
        charts.append({
            "title": "Findings by severity", "kind": "bar",
            "data": {s: sev[s] for s in SEVERITY_DISPLAY_ORDER if s in sev},
            "colors": {
                s: SEVERITY_COLORS[s] for s in SEVERITY_DISPLAY_ORDER if s in sev
            },
        })
    agent = viz.get("agent_type", "")
    if agent == "metrics" and viz.get("utilization"):
        # CPU-vs-memory grouped view (reference: visualization.py:258-330
        # "Resource Usage Issues" splits the two resources into parallel
        # series over the affected pods)
        cpu = {
            row["component"]: row.get("usage_percentage", 0)
            for row in viz["utilization"]
            if str(row.get("resource", "")).lower() == "cpu"
        }
        mem = {
            row["component"]: row.get("usage_percentage", 0)
            for row in viz["utilization"]
            if str(row.get("resource", "")).lower() in ("memory", "mem")
        }
        if cpu or mem:
            charts.append({
                "title": "Resource usage issues (CPU vs memory)",
                "kind": "bar_grouped",
                "series": {"cpu": cpu, "memory": mem},
                "thresholds": [
                    {"value": 80, "label": "warn (80%)"},
                    {"value": 90, "label": "critical (90%)"},
                ],
            })
        # one component can carry several metrics findings (cpu AND memory)
        # — key by component+resource so neither overwrites the other.
        # Thresholds mirror the rule engine's 80%/90% utilization ladder
        # (reference: components/visualization.py utilization charts draw
        # the same warn/critical lines; agents/metrics_agent.py:88-151)
        charts.append({
            "title": "Utilization (% of limit)", "kind": "bar",
            "data": {
                (
                    f"{row['component']} ({row['resource']})"
                    if row.get("resource") else row["component"]
                ): row.get("usage_percentage", 0)
                for row in viz["utilization"]
            },
            "thresholds": [
                {"value": 80, "label": "warn (80%)"},
                {"value": 90, "label": "critical (90%)"},
            ],
        })
    elif agent == "logs":
        if viz.get("pattern_counts"):
            charts.append({
                "title": "Log error classes", "kind": "bar",
                "data": dict(viz["pattern_counts"]),
            })
        if viz.get("component_severity"):
            # component -> severity two-ring sunburst (reference:
            # components/visualization.py:399-447 builds exactly this
            # hierarchy with the severity color map)
            rows = []
            for comp, sevs in sorted(viz["component_severity"].items()):
                rows.append({
                    "id": comp, "parent": "",
                    "value": sum(sevs.values()), "color": "#CCCCCC",
                })
                for s in SEVERITY_DISPLAY_ORDER:
                    if s in sevs:
                        rows.append({
                            "id": f"{comp}/{s}", "parent": comp,
                            "value": sevs[s],
                            "color": SEVERITY_COLORS[s],
                        })
            charts.append({
                "title": "Log issues by component and severity",
                "kind": "sunburst", "data": rows,
            })
    elif agent == "resources" and viz.get("pod_buckets"):
        charts.append({
            "title": "Pod status buckets", "kind": "bar",
            "data": {k: v for k, v in viz["pod_buckets"].items() if v},
        })
    elif agent == "events":
        if viz.get("reason_counts"):
            charts.append({
                "title": "Events by reason", "kind": "bar",
                "data": dict(sorted(
                    viz["reason_counts"].items(),
                    key=lambda kv: -kv[1],
                )[:12]),
            })
        if viz.get("type_counts"):
            charts.append({
                "title": "Events by type", "kind": "bar",
                "data": dict(viz["type_counts"]),
            })
        if viz.get("component_kind_counts"):
            # donut of issues by component KIND (reference:
            # components/visualization.py:833-843, px.pie hole=0.4 over
            # the component-type split)
            charts.append({
                "title": "Event issues by component type", "kind": "pie",
                "hole": 0.4, "data": dict(viz["component_kind_counts"]),
            })
    elif agent == "traces":
        if viz.get("error_rates"):
            charts.append({
                "title": "Error rate per service", "kind": "bar",
                "data": {
                    row["component"]: row["error_rate"]
                    for row in viz["error_rates"]
                },
            })
        lat = viz.get("latency") or {}
        if lat:
            charts.append({
                "title": "p95 latency per service (ms)", "kind": "bar",
                "data": {
                    name: stats.get("p95", 0)
                    for name, stats in lat.items()
                },
            })
        deps = viz.get("dependencies") or {}
        if deps:
            # directed service-dependency edges with per-service issue
            # severity (reference: components/visualization.py:545-646
            # draws the dependency digraph with issue-colored nodes)
            by_comp: Dict[str, List[str]] = {}
            for row in viz.get("finding_rows", []):
                by_comp.setdefault(
                    row["component"].split("/", 1)[-1], []
                ).append(row["severity"])
            max_sev = {c: max_severity(s) for c, s in by_comp.items()}
            charts.append({
                "title": "Service dependencies", "kind": "digraph",
                "data": [
                    {"source": src, "target": dst,
                     "source_severity": max_sev.get(src, "info"),
                     "target_severity": max_sev.get(dst, "info")}
                    for src, dsts in sorted(deps.items())
                    for dst in dsts
                ],
            })
    elif agent == "topology" and viz.get("service_pod_mapping"):
        charts.append({
            "title": "Service → pod mapping", "kind": "table",
            "data": [
                {"service": svc, **(
                    info if isinstance(info, dict) else {"pods": info}
                )}
                for svc, info in viz["service_pod_mapping"].items()
            ],
        })
    # per-row severity-tagged findings table, every agent (reference:
    # resource/report tables with severity coloring)
    if viz.get("finding_rows"):
        charts.append({
            "title": "Findings", "kind": "findings_table",
            "data": viz["finding_rows"],
        })
    return charts


def comprehensive_chart_series(results: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-agent overview specs (reference: visualization.py:38-236
    _render_comprehensive_visualizations — severity distribution over ALL
    agents' findings plus a findings-per-agent bar)."""
    sev_counts: Dict[str, int] = {}
    per_agent: Dict[str, int] = {}
    for agent_type, result in results.items():
        if not isinstance(result, dict) or "findings" not in result:
            continue
        findings = result.get("findings") or []
        if findings:
            per_agent[agent_type] = len(findings)
        for f in findings:
            sev = str(f.get("severity", "info")).lower()
            sev_counts[sev] = sev_counts.get(sev, 0) + 1
    charts: List[Dict[str, Any]] = []
    if sev_counts:
        charts.append({
            "title": "Distribution of findings by severity", "kind": "bar",
            "data": {
                s: sev_counts[s] for s in SEVERITY_DISPLAY_ORDER if s in sev_counts
            },
            "colors": {
                s: SEVERITY_COLORS[s] for s in SEVERITY_DISPLAY_ORDER
                if s in sev_counts
            },
        })
    if per_agent:
        charts.append({
            "title": "Findings by agent", "kind": "bar",
            "data": dict(sorted(per_agent.items())),
        })
    return charts


def correlated_markdown(correlated: Dict[str, Any]) -> str:
    """Correlated-findings tab body: grouped findings per component
    (reference: components/report.py Correlated tab)."""
    groups = correlated.get("groups", {})
    if not groups:
        return "_No correlated findings._"
    lines = [f"**{len(groups)} component(s) with findings**", ""]
    ranked_order = [r["component"] for r in correlated.get("root_causes", [])]
    rest = [c for c in groups if c not in ranked_order]
    for comp in ranked_order + sorted(rest):
        if comp not in groups:
            continue
        findings = groups[comp]
        worst = max_severity(
            str(f.get("severity", "info")) for f in findings
        )
        icon = SEVERITY_ICONS.get(worst.lower(), "⚪")
        lines.append(
            f"- {icon} **{comp}** — {len(findings)} finding(s) from "
            f"{', '.join(sorted({str(f.get('source', '')) for f in findings}))}"
        )
    return "\n".join(lines)


def wizard_stage_markdown(session: Dict[str, Any]) -> str:
    """Progress header for the 4-stage guided wizard (reference:
    components/interactive_session.py:107-114 stages)."""
    stages = ["Select finding", "Hypotheses", "Investigate", "Conclusion"]
    current = int(session.get("stage", 0))
    parts = []
    for i, s in enumerate(stages):
        mark = "✅" if i < current else ("▶️" if i == current else "⚪")
        parts.append(f"{mark} {s}")
    return "  →  ".join(parts)


_VERDICT_ICONS = {"supported": "🟢", "refuted": "🔴", "inconclusive": "🟡"}


def diagnostic_timeline_markdown(executed: List[Dict[str, Any]]) -> str:
    """Timeline of the diagnostic path taken so far — one line per executed
    investigation step with its evidence kind and verdict (reference:
    components/interactive_session.py renders a diagnostic-path timeline
    alongside the wizard)."""
    if not executed:
        return "_No steps executed yet._"
    lines = ["**Diagnostic path**", ""]
    for i, s in enumerate(executed):
        step = s.get("step", {}) or {}
        verdict = s.get("verdict", {}) or {}
        v = str(verdict.get("verdict", "n/a")).lower()
        icon = _VERDICT_ICONS.get(v, "⚪")
        lines.append(
            f"{i + 1}. {icon} {step.get('description', step.get('type', 'step'))}"
            f" — **{verdict.get('verdict', 'n/a')}**"
            f" ({float(verdict.get('confidence', 0) or 0):.0%})"
            f" · {str(verdict.get('reasoning', ''))[:120]}"
        )
    return "\n".join(lines)


def report_markdown(results: Dict[str, Any]) -> str:
    """Full comprehensive-analysis report (reference: components/report.py)."""
    correlated = results.get("correlated", {})
    parts = [
        "# Root Cause Analysis Report",
        "",
        results.get("summary", ""),
        "",
        root_causes_markdown(correlated),
        "",
        "## Per-agent findings",
    ]
    for agent, res in results.items():
        if not isinstance(res, dict) or "findings" not in res:
            continue
        parts.append(f"\n### {agent} ({len(res['findings'])} findings)")
        parts.append(res.get("summary", ""))
        for f in res["findings"][:15]:
            parts.append("")
            parts.append(finding_markdown(f))
    return "\n".join(parts)
