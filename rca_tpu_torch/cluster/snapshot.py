"""Frozen point-in-time capture of one namespace — the engine's single input
(the port's copy of ``rca_tpu.cluster.snapshot``, dict capture only).

The reference re-fetched cluster state ad hoc inside every agent and the
coordinator (reference: agents/mcp_coordinator.py:322-620 builds a fresh
``agent_context`` per runner; agents/resource_analyzer.py:44-70 fetches seven
collections again).  Here one :class:`ClusterSnapshot` is captured once per
analysis and shared by all agents, the feature extractor, and the topology
builder — one consistent view, one set of API round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    """See module docstring."""
    namespace: str
    captured_at: str
    pods: List[dict]
    deployments: List[dict]
    statefulsets: List[dict]
    daemonsets: List[dict]
    cronjobs: List[dict]
    services: List[dict]
    endpoints: List[dict]
    ingresses: List[dict]
    network_policies: List[dict]
    configmaps: List[dict]
    secrets: List[dict]
    pvcs: List[dict]
    resource_quotas: List[dict]
    hpas: List[dict]
    nodes: List[dict]
    node_metrics: Dict[str, Any]
    pod_metrics: Dict[str, Any]
    events: List[dict]
    # pod name -> {container -> log text} (tail-limited at capture time)
    logs: Dict[str, Dict[str, str]]
    traces: Dict[str, Any]
    # fetch failures swallowed during capture ([{"op", "error"}]): non-empty
    # means this snapshot is PARTIAL and every consumer should say so
    errors: List[Dict[str, str]] = dataclasses.field(default_factory=list)

    @classmethod
    def capture(
        cls,
        client,
        namespace: str,
        log_tail_lines: int = 200,
        max_log_pods: Optional[int] = None,
        include_traces: bool = True,
    ) -> "ClusterSnapshot":
        """Capture everything the analysis needs in one pass (the dict
        sweep: every object sanitized, every sampled pod's logs fetched).

        ``max_log_pods=None`` fetches logs for every non-healthy pod plus a
        bounded sample of healthy ones — unlike the reference which sampled
        only the first 5 pods' logs (reference: mcp_coordinator.py:396-409)
        and could miss the faulty pod entirely.
        """
        from rca_tpu_torch.cluster.sanitize import sanitize_objects

        # drain stale errors so this snapshot reports only ITS failures
        if hasattr(client, "collect_errors"):
            client.collect_errors()
        pods = sanitize_objects(client.get_pods(namespace))
        logs: Dict[str, Dict[str, str]] = {}
        pods_for_logs = _prioritize_pods_for_logs(pods, max_log_pods)
        for pod in pods_for_logs:
            pod_name = pod.get("metadata", {}).get("name", "")
            containers = pod.get("spec", {}).get("containers", []) or []
            per_container: Dict[str, str] = {}
            for c in containers:
                try:
                    per_container[c["name"]] = client.get_pod_logs(
                        namespace, pod_name, container=c["name"],
                        tail_lines=log_tail_lines,
                    )
                except Exception:
                    per_container[c["name"]] = ""
            logs[pod_name] = per_container

        traces: Dict[str, Any] = {}
        if include_traces:
            try:
                traces = {
                    "latency": client.get_service_latency_stats(namespace),
                    "error_rates": client.get_error_rate_by_service(namespace),
                    "dependencies": client.get_service_dependencies(namespace),
                    "slow_ops": client.find_slow_operations(namespace),
                }
            except Exception:
                traces = {}

        san = sanitize_objects
        return cls(
            namespace=namespace,
            captured_at=client.get_current_time(),
            pods=pods,
            deployments=san(client.get_deployments(namespace)),
            statefulsets=san(client.get_statefulsets(namespace)),
            daemonsets=san(client.get_daemonsets(namespace)),
            cronjobs=san(client.get_cronjobs(namespace)),
            services=san(client.get_services(namespace)),
            endpoints=san(client.get_endpoints(namespace)),
            ingresses=san(client.get_ingresses(namespace)),
            network_policies=san(client.get_network_policies(namespace)),
            configmaps=san(client.get_configmaps(namespace)),
            secrets=san(client.get_secrets(namespace)),
            pvcs=san(client.get_pvcs(namespace)),
            resource_quotas=san(client.get_resource_quotas(namespace)),
            hpas=san(client.get_hpas(namespace)),
            nodes=san(client.get_nodes()),
            node_metrics=client.get_node_metrics() or {},
            pod_metrics=client.get_pod_metrics(namespace) or {},
            events=san(client.get_events(namespace)),
            logs=logs,
            traces=traces,
            errors=(
                client.collect_errors()
                if hasattr(client, "collect_errors") else []
            ),
        )

    # convenience lookups -------------------------------------------------
    def pod_by_name(self, name: str) -> Optional[dict]:
        for p in self.pods:
            if p.get("metadata", {}).get("name") == name:
                return p
        return None

    def service_names(self) -> List[str]:
        return [s.get("metadata", {}).get("name", "") for s in self.services]


def _prioritize_pods_for_logs(pods: List[dict], max_pods: Optional[int]):
    """Unhealthy pods first; cap total fetches when max_pods is set."""

    def health_key(pod: dict) -> int:
        status = pod.get("status", {})
        if status.get("phase") not in ("Running", "Succeeded"):
            return 0
        for cs in status.get("containerStatuses", []) or []:
            if not cs.get("ready") or cs.get("restartCount", 0) > 0:
                return 0
        return 1

    unhealthy, healthy = [], []
    for p in pods:
        (healthy if health_key(p) else unhealthy).append(p)
    if max_pods is None:
        # all unhealthy pods + up to 25 healthy ones
        return unhealthy + healthy[:25]
    return (unhealthy + healthy)[:max_pods]
