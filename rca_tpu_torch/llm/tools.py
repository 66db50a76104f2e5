"""Per-signal tool registries bound to the ClusterClient protocol.

The reference declared per-agent OpenAI function schemas
(reference: agents/mcp_metrics_agent.py:35-114, mcp_logs_agent.py:35-139,
mcp_events_agent.py:35-120, mcp_topology_agent.py:35-128,
mcp_traces_agent.py:36-136) but its LLM client never invoked them
(reference: utils/llm_client_improved.py:68 ignores ``tools``).  Here every
schema is paired with an executable bound to the one typed
:class:`~rca_tpu_torch.cluster.protocol.ClusterClient`, so the loop in
:meth:`rca_tpu_torch.llm.client.LLMClient.analyze` really runs them — and since both the real and
mock backends implement the same protocol, every tool works against both
(the reference's mock-only tool breakage, SURVEY.md §2.6, cannot recur).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

MAX_TOOL_RESULT_CHARS = 6000


@dataclasses.dataclass
class ToolSpec:
    name: str
    description: str
    parameters: Dict[str, Any]
    fn: Callable[..., Any]

    def schema(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": self.parameters,
        }

    def execute(self, arguments: Dict[str, Any]) -> str:
        props = self.parameters.get("properties", {})
        kwargs = {k: v for k, v in (arguments or {}).items() if k in props}
        try:
            out = self.fn(**kwargs)
        except Exception as e:
            return json.dumps({"error": f"{type(e).__name__}: {e}"})
        try:
            text = json.dumps(out, default=str)
        except (TypeError, ValueError):
            text = str(out)
        if len(text) > MAX_TOOL_RESULT_CHARS:
            text = text[:MAX_TOOL_RESULT_CHARS] + "...[truncated]"
        return text


def _obj(props: Dict[str, dict], required: Optional[List[str]] = None) -> dict:
    return {
        "type": "object",
        "properties": props,
        "required": required or [],
    }


_STR = {"type": "string"}
_INT = {"type": "integer"}


def cluster_toolsets(client, namespace: str) -> Dict[str, List[ToolSpec]]:
    """Tool registry per signal agent, all bound to ``client``/``namespace``."""
    ns = namespace

    def pod_logs(pod_name: str, container: str = "", previous: bool = False,
                 tail_lines: int = 100):
        return client.get_pod_logs(
            ns, pod_name, container=container or None,
            previous=bool(previous), tail_lines=int(tail_lines),
        )

    def search_logs(pattern: str, tail_lines: int = 200):
        """Cross-pod substring search (reference: mcp_logs_agent.py:256-292)."""
        hits = []
        for pod in client.get_pods(ns):
            name = pod.get("metadata", {}).get("name", "")
            try:
                text = client.get_pod_logs(ns, name, tail_lines=int(tail_lines))
            except Exception:
                continue
            for line in (text or "").splitlines():
                if pattern.lower() in line.lower():
                    hits.append({"pod": name, "line": line.strip()[:300]})
                    if len(hits) >= 50:
                        return hits
        return hits

    def resource_events(kind: str, name: str):
        return client.get_events(
            ns,
            field_selector=(
                f"involvedObject.kind={kind},involvedObject.name={name}"
            ),
        )

    def deployment_resource_usage(deployment: str = ""):
        """Deployment-level usage: join deployment → pod metrics by pod-name
        prefix and aggregate (reference: mcp_metrics_agent.py:35-114 declares
        the tool, :201-204 joins by name substring — here the join actually
        executes and averages usage_percentage across the pods)."""
        pod_mets = (client.get_pod_metrics(ns) or {}).get("pods", {})

        def avg(vals):
            vals = [v for v in vals if isinstance(v, (int, float))]
            return round(sum(vals) / len(vals), 2) if vals else None

        deployments = client.get_deployments(ns)
        all_names = [
            d.get("metadata", {}).get("name", "") for d in deployments
        ]

        def owner_of(pod_name: str):
            """Longest deployment-name prefix wins, so pods of
            'backend-worker' never count toward 'backend'."""
            best = None
            for n in all_names:
                if pod_name == n or pod_name.startswith(n + "-"):
                    if best is None or len(n) > len(best):
                        best = n
            return best

        # each pod's owner once (not once per deployment): the join is
        # O(pods x deployments), which a 2,000-service namespace can pay
        owners = {p: owner_of(p) for p in pod_mets}
        out = []
        for dep in deployments:
            name = dep.get("metadata", {}).get("name", "")
            if deployment and name != deployment:
                continue
            pods = {
                p: m for p, m in pod_mets.items() if owners[p] == name
            }
            status = dep.get("status", {}) or {}
            out.append({
                "deployment": name,
                "replicas_desired": (dep.get("spec", {}) or {}).get("replicas"),
                "replicas_ready": status.get("readyReplicas", 0),
                "pods_with_metrics": len(pods),
                "cpu_usage_percentage_avg": avg(
                    (m.get("cpu", {}) or {}).get("usage_percentage")
                    for m in pods.values()
                ),
                "memory_usage_percentage_avg": avg(
                    (m.get("memory", {}) or {}).get("usage_percentage")
                    for m in pods.values()
                ),
                "per_pod": {
                    p: {
                        "cpu": (m.get("cpu", {}) or {}).get("usage"),
                        "memory": (m.get("memory", {}) or {}).get("usage"),
                    }
                    for p, m in pods.items()
                },
            })
        return out

    metrics = [
        ToolSpec("get_pod_metrics", "CPU/memory usage per pod in the namespace",
                 _obj({}), lambda: client.get_pod_metrics(ns)),
        ToolSpec("get_deployment_resource_usage",
                 "Aggregated CPU/memory usage per deployment (joins pod "
                 "metrics onto deployments; optionally one deployment)",
                 _obj({"deployment": _STR}), deployment_resource_usage),
        ToolSpec("get_node_metrics", "CPU/memory usage per cluster node",
                 _obj({}), client.get_node_metrics),
        ToolSpec("get_hpas", "HorizontalPodAutoscaler specs and status",
                 _obj({}), lambda: client.get_hpas(ns)),
        ToolSpec("get_resource_quotas", "ResourceQuota objects in the namespace",
                 _obj({}), lambda: client.get_resource_quotas(ns)),
        ToolSpec("get_deployments",
                 "Deployment specs (includes per-container resource requests/limits)",
                 _obj({}), lambda: client.get_deployments(ns)),
    ]
    logs = [
        ToolSpec("get_pod_logs", "Logs of one pod (optionally one container)",
                 _obj({"pod_name": _STR, "container": _STR,
                       "previous": {"type": "boolean"}, "tail_lines": _INT},
                      ["pod_name"]),
                 pod_logs),
        ToolSpec("search_logs_for_pattern",
                 "Search all pods' recent logs for a substring",
                 _obj({"pattern": _STR, "tail_lines": _INT}, ["pattern"]),
                 search_logs),
        ToolSpec("get_pods", "Pod list with status/containerStatuses",
                 _obj({}), lambda: client.get_pods(ns)),
    ]
    events = [
        ToolSpec("get_namespace_events", "All events in the namespace",
                 _obj({}), lambda: client.get_events(ns)),
        ToolSpec("get_resource_events", "Events for one object (kind + name)",
                 _obj({"kind": _STR, "name": _STR}, ["kind", "name"]),
                 resource_events),
    ]
    topology = [
        ToolSpec("get_services", "Service list with selectors",
                 _obj({}), lambda: client.get_services(ns)),
        ToolSpec("get_endpoints", "Endpoints (ready addresses) per service",
                 _obj({}), lambda: client.get_endpoints(ns)),
        ToolSpec("get_deployments", "Deployment list",
                 _obj({}), lambda: client.get_deployments(ns)),
        ToolSpec("get_ingresses", "Ingress routes",
                 _obj({}), lambda: client.get_ingresses(ns)),
        ToolSpec("get_network_policies", "NetworkPolicy objects",
                 _obj({}), lambda: client.get_network_policies(ns)),
    ]
    traces = [
        ToolSpec("get_trace_ids", "Recent trace ids",
                 _obj({"limit": _INT}),
                 lambda limit=20: client.get_trace_ids(ns, limit=int(limit))),
        ToolSpec("get_trace_details", "Spans of one trace",
                 _obj({"trace_id": _STR}, ["trace_id"]),
                 client.get_trace_details),
        ToolSpec("get_service_latency_stats", "p50/p95/p99 latency per service",
                 _obj({}), lambda: client.get_service_latency_stats(ns)),
        ToolSpec("get_error_rate_by_service", "Error rate per service",
                 _obj({}), lambda: client.get_error_rate_by_service(ns)),
        ToolSpec("get_service_dependencies", "Service dependency map",
                 _obj({}), lambda: client.get_service_dependencies(ns)),
        ToolSpec("find_slow_operations", "Operations slower than threshold_ms",
                 _obj({"threshold_ms": {"type": "number"}}),
                 lambda threshold_ms=500.0: client.find_slow_operations(
                     ns, threshold_ms=float(threshold_ms))),
    ]
    resources = [
        ToolSpec("get_pods", "Pod list with status", _obj({}),
                 lambda: client.get_pods(ns)),
        ToolSpec("get_deployments", "Deployment list", _obj({}),
                 lambda: client.get_deployments(ns)),
        ToolSpec("get_resource_details",
                 "Full manifest of one resource (kind + name)",
                 _obj({"kind": _STR, "name": _STR}, ["kind", "name"]),
                 lambda kind, name: client.get_resource_details(ns, kind, name)),
        ToolSpec("get_namespace_events", "All namespace events", _obj({}),
                 lambda: client.get_events(ns)),
    ]
    return {
        "metrics": metrics,
        "logs": logs,
        "events": events,
        "topology": topology,
        "traces": traces,
        "resources": resources,
    }
