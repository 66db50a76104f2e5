"""Frozen point-in-time capture of one namespace — the engine's single input
(the port's copy of ``rca_tpu.cluster.snapshot``).

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
    """See module docstring.  ``columnar``, when present, is a
    :class:`rca_tpu_torch.cluster.columnar.ColumnarView` — the vectorized
    extractor inputs assembled at capture time from the client's columnar
    tables; the extractor uses it instead of the per-object dict scans
    (bit-identical by construction, property-tested).  Patched/derived
    snapshots must drop it (``dataclasses.replace(..., columnar=None)``)
    because a view describes exactly the capture that built it."""
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
    # columnar fast-path view; never part of the value
    columnar: Optional[Any] = dataclasses.field(
        default=None, compare=False, repr=False,
    )

    @classmethod
    def capture(
        cls,
        client,
        namespace: str,
        log_tail_lines: int = 200,
        max_log_pods: Optional[int] = None,
        include_traces: bool = True,
        columnar: bool = True,
        columnar_state: Optional[Any] = None,
        traces_from: Optional[Dict[str, Any]] = None,
    ) -> "ClusterSnapshot":
        """Capture everything the analysis needs in one pass.

        ``max_log_pods=None`` fetches logs for every non-healthy pod plus a
        bounded sample of healthy ones — unlike the reference which sampled
        only the first 5 pods' logs (reference: mcp_coordinator.py:396-409)
        and could miss the faulty pod entirely.

        When the client supports ``get_columnar`` and
        ``RCA_COLUMNAR`` is on, the object lists, feature columns, and
        log-scan counts come from the incrementally-maintained columnar
        tables instead of per-object re-sanitize/re-scan sweeps —
        O(dirty rows) instead of O(objects) per capture.  ``columnar_state``
        (a :class:`rca_tpu_torch.cluster.columnar.ColumnarClientState`) carries
        the mirror + cursor across repeated captures so only column DIFFS
        cross the client boundary;
        ``traces_from`` reuses a previous capture's trace payloads when
        the caller knows traces were untouched (the busy-poll patch
        contract).  Both are ignored on the dict path.
        """
        from rca_tpu_torch.cluster.sanitize import sanitize_objects
        from rca_tpu_torch.config import columnar_enabled

        # callable check (not bare hasattr): a client subclass opts out of
        # the columnar surface with ``get_columnar = None`` — e.g. fault-
        # simulating test clients whose overridden getters must be hit
        if (
            columnar
            and columnar_enabled()
            and log_tail_lines == 200
            and callable(getattr(client, "get_columnar", None))
        ):
            snap = cls._capture_columnar(
                client, namespace,
                max_log_pods=max_log_pods,
                include_traces=include_traces,
                columnar_state=columnar_state,
                traces_from=traces_from,
            )
            if snap is not None:
                return snap

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

    @classmethod
    def _capture_columnar(
        cls,
        client,
        namespace: str,
        max_log_pods: Optional[int],
        include_traces: bool,
        columnar_state: Optional[Any],
        traces_from: Optional[Dict[str, Any]],
    ) -> Optional["ClusterSnapshot"]:
        """Columnar capture: one ``get_columnar`` call (full
        tables once, column diffs after), log-text refetch only for pods
        whose rows changed, everything else assembled from the mirror.
        Returns None when the world is degenerate for columnar
        maintenance — the caller falls back to the dict sweep."""
        from rca_tpu_torch.cluster.columnar import (
            ColumnarClientState,
            ColumnarUnsupported,
        )

        state = columnar_state or ColumnarClientState()
        if hasattr(client, "collect_errors"):
            client.collect_errors()  # drain stale errors
        payload = client.get_columnar(namespace, state.cursor)
        try:
            full, changed, _removed = state.apply(namespace, payload)
        except ColumnarUnsupported:
            return None
        tables = state.tables
        view = tables.build_view(max_log_pods=max_log_pods)

        # sampled log texts: fetch only what the mirror cannot vouch for
        # (everything on a full payload; changed/uncached pods on diffs)
        pods_tbl = tables.kinds["pods"]
        logs: Dict[str, Dict[str, str]] = {}
        for name in view.sampled_names:
            cached = state.log_texts.get(name)
            if cached is None or full or name in changed:
                row = pods_tbl.pos.get(name)
                pod = pods_tbl.objects[row] if row is not None else {}
                per_container: Dict[str, str] = {}
                for c in pod.get("spec", {}).get("containers", []) or []:
                    try:
                        per_container[c["name"]] = client.get_pod_logs(
                            namespace, name, container=c["name"],
                            tail_lines=200,
                        )
                    except Exception:
                        per_container[c["name"]] = ""
                state.log_texts[name] = per_container
                cached = per_container
            logs[name] = cached

        traces: Dict[str, Any] = {}
        if include_traces:
            if traces_from is not None:
                traces = traces_from
            else:
                try:
                    traces = {
                        "latency": client.get_service_latency_stats(
                            namespace),
                        "error_rates": client.get_error_rate_by_service(
                            namespace),
                        "dependencies": client.get_service_dependencies(
                            namespace),
                        "slow_ops": client.find_slow_operations(namespace),
                    }
                except Exception:
                    traces = {}

        k = tables.kinds
        return cls(
            namespace=namespace,
            captured_at=client.get_current_time(),
            pods=list(k["pods"].objects),
            deployments=list(k["deployments"].objects),
            statefulsets=list(k["statefulsets"].objects),
            daemonsets=list(k["daemonsets"].objects),
            cronjobs=list(k["cronjobs"].objects),
            services=list(k["services"].objects),
            endpoints=list(k["endpoints"].objects),
            ingresses=list(k["ingresses"].objects),
            network_policies=list(k["network_policies"].objects),
            configmaps=list(k["configmaps"].objects),
            secrets=list(k["secrets"].objects),
            pvcs=list(k["pvcs"].objects),
            resource_quotas=list(k["resource_quotas"].objects),
            hpas=list(k["hpas"].objects),
            nodes=list(tables.nodes),
            node_metrics=client.get_node_metrics() or {},
            pod_metrics={"pods": dict(tables.metric_recs)},
            events=list(tables.events),
            logs=logs,
            traces=traces,
            errors=(
                client.collect_errors()
                if hasattr(client, "collect_errors") else []
            ),
            columnar=view,
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
