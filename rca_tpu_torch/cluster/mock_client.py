"""Hermetic mock cluster client backed by a :class:`World`: the port's copy
of ``rca_tpu.cluster.mock_client``, the columnar feed included.

Drop-in replacement for the live client (same :class:`ClusterClient`
protocol), playing the role of the reference's ``MockK8sClient``
(reference: utils/mock_k8s_client.py) but parameterized by a programmatic
world so the same code serves the 5-service faulted fixture and the
50/2k/10k/50k-service synthetic configs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from rca_tpu_torch.cluster.world import MOCK_TIME, World
from rca_tpu_torch.findings import utcnow_iso


def _name(obj: dict) -> str:
    return obj.get("metadata", {}).get("name", "")


class MockClusterClient:
    """In-memory :class:`ClusterClient` implementation."""

    def __init__(self, world: World, frozen_time: bool = True):
        self.world = world
        self._frozen_time = frozen_time

    # ---- connection / identity -------------------------------------------
    def is_connected(self) -> bool:
        return True

    def get_current_time(self) -> str:
        # the one wall-clock seam in the mock (nondet-discipline
        # allowlists exactly this function): frozen by default so
        # recorded/replayed captures are host-independent
        return MOCK_TIME if self._frozen_time else utcnow_iso()

    def get_cluster_info(self) -> Dict[str, Any]:
        return {
            "name": self.world.cluster_name,
            "nodes": len(self.world.nodes),
            "namespaces": self.world.namespaces(),
            "errors": [],
            "mock": True,
        }

    def collect_errors(self, clear: bool = True) -> List[Dict[str, str]]:
        return []  # in-memory world: fetches cannot fail

    def get_namespaces(self) -> List[str]:
        return self.world.namespaces()

    # ---- pods ------------------------------------------------------------
    def get_pods(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.pods.get(namespace, []))

    def get_pod(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for pod in self.world.pods.get(namespace, []):
            if _name(pod) == name:
                return pod
        return None

    def get_pod_logs(
        self,
        namespace: str,
        pod_name: str,
        container: Optional[str] = None,
        previous: bool = False,
        tail_lines: Optional[int] = None,
    ) -> str:
        store = self.world.previous_logs if previous else self.world.logs
        by_container = store.get(namespace, {}).get(pod_name, {})
        if not by_container:
            return ""
        if container is None:
            container = next(iter(by_container))
        text = by_container.get(container, "")
        if tail_lines is not None:
            lines = text.splitlines()[-tail_lines:] if tail_lines > 0 else []
            text = "\n".join(lines)
        return text

    def get_recently_terminated_pods(self, namespace: str) -> List[Dict[str, Any]]:
        out = []
        for pod in self.world.pods.get(namespace, []):
            for cs in pod.get("status", {}).get("containerStatuses", []) or []:
                if "terminated" in (cs.get("state") or {}):
                    out.append(pod)
                    break
        return out

    # ---- workloads -------------------------------------------------------
    def get_deployments(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.deployments.get(namespace, []))

    def get_deployment(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for d in self.world.deployments.get(namespace, []):
            if _name(d) == name:
                return d
        return None

    def get_statefulsets(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.statefulsets.get(namespace, []))

    def get_daemonsets(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.daemonsets.get(namespace, []))

    def get_cronjobs(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.cronjobs.get(namespace, []))

    # ---- services / networking -------------------------------------------
    def get_services(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.services.get(namespace, []))

    def get_service(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for s in self.world.services.get(namespace, []):
            if _name(s) == name:
                return s
        return None

    def get_endpoints(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.endpoints.get(namespace, []))

    def get_ingresses(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.ingresses.get(namespace, []))

    def get_network_policies(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.network_policies.get(namespace, []))

    # ---- config / storage ------------------------------------------------
    def get_configmaps(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.configmaps.get(namespace, []))

    def get_secrets(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.secrets.get(namespace, []))

    def get_pvcs(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.pvcs.get(namespace, []))

    def get_pvc(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for p in self.world.pvcs.get(namespace, []):
            if _name(p) == name:
                return p
        return None

    def get_resource_quotas(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.resource_quotas.get(namespace, []))

    # ---- nodes / metrics / autoscaling -----------------------------------
    def get_nodes(self) -> List[Dict[str, Any]]:
        return list(self.world.nodes)

    def get_node_metrics(self) -> Dict[str, Any]:
        return dict(self.world.node_metrics)

    def get_pod_metrics(self, namespace: str) -> Dict[str, Any]:
        return dict(self.world.pod_metrics.get(namespace, {}))

    def get_hpas(self, namespace: str) -> List[Dict[str, Any]]:
        return list(self.world.hpas.get(namespace, []))

    # ---- events ----------------------------------------------------------
    def get_events(
        self, namespace: str, field_selector: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        events = list(self.world.events.get(namespace, []))
        if not field_selector:
            return events
        # Supports the selector forms the agents actually use
        # (reference: utils/k8s_client.py:606, mcp_events_agent.py:216):
        # "type!=Normal", "type=Warning",
        # "involvedObject.kind=Pod,involvedObject.name=foo"
        for clause in field_selector.split(","):
            clause = clause.strip()
            if "!=" in clause:
                key, val = clause.split("!=", 1)
                events = [e for e in events if str(_field(e, key)) != val]
            elif "=" in clause:
                key, val = clause.split("=", 1)
                events = [e for e in events if str(_field(e, key)) == val]
        return events

    # ---- traces ----------------------------------------------------------
    def get_trace_ids(self, namespace: str, limit: int = 20) -> List[str]:
        ids = self.world.traces.get("trace_ids", {}).get(namespace, [])
        return list(ids)[:limit]

    def get_trace_details(self, trace_id: str) -> Dict[str, Any]:
        return dict(self.world.traces.get("traces", {}).get(trace_id, {}))

    def get_service_latency_stats(self, namespace: str) -> Dict[str, Any]:
        return dict(self.world.traces.get("latency", {}).get(namespace, {}))

    def get_error_rate_by_service(self, namespace: str) -> Dict[str, Any]:
        return dict(self.world.traces.get("error_rates", {}).get(namespace, {}))

    def get_service_dependencies(self, namespace: str) -> Dict[str, Any]:
        return dict(self.world.traces.get("dependencies", {}).get(namespace, {}))

    def find_slow_operations(
        self, namespace: str, threshold_ms: float = 500.0
    ) -> List[Dict[str, Any]]:
        ops = self.world.traces.get("slow_ops", {}).get(namespace, [])
        return [op for op in ops if op.get("duration_ms", 0) >= threshold_ms]

    # ---- columnar capture surface -----------------------------------------
    def get_columnar(
        self, namespace: str, cursor: Optional[str] = None
    ) -> Dict[str, Any]:
        """Columnar world-state feed: the full table dump on a fresh (or
        expired) cursor, column-diff row ops after.  The journal that
        backs ``watch_changes`` drives the row writes, so the two feeds
        expire together.  ``supported: False`` (degenerate world —
        duplicate object names) sends the caller back to the dict scans."""
        from rca_tpu_torch.cluster.columnar import ColumnarWorld

        master = self.world._columnar.get(namespace)
        if master is None:
            master = ColumnarWorld.master(self.world, namespace)
            self.world._columnar[namespace] = master
        return master.payload(cursor)

    # ---- incremental changes (watch surface) ------------------------------
    def watch_changes(
        self, namespace: str, cursor: Optional[str]
    ) -> Dict[str, Any]:
        """Journal-backed incremental change feed (the hermetic twin of
        kubernetes watch streams).

        ``cursor=None`` opens the feed at the journal head.  Returns
        ``{"supported", "cursor", "expired", "changes"}`` where each change
        is ``{"kind", "name"}`` (deduped, this namespace only).  A cursor
        older than the journal's retained window reports ``expired`` — the
        caller must resync from a full snapshot, exactly like a 410 Gone
        on a real watch."""
        w = self.world
        if cursor is None:
            return {"supported": True, "cursor": str(w.journal_seq),
                    "expired": False, "changes": []}
        try:
            seq = int(cursor)
        except ValueError:
            return {"supported": True, "cursor": str(w.journal_seq),
                    "expired": True, "changes": []}
        entries = w.changes_since(seq)
        if entries is None:
            return {"supported": True, "cursor": str(w.journal_seq),
                    "expired": True, "changes": []}
        by_key = {}
        changes = []
        for e in entries:
            if e["namespace"] != namespace:
                continue
            key = (e["kind"], e["name"])
            rec = by_key.get(key)
            if rec is None:
                # seq doubles as the stamped resourceVersion (touch):
                # row-write consumers key re-encodes on it
                rec = {"kind": e["kind"], "name": e["name"],
                       "rv": str(e["seq"])}
                by_key[key] = rec
                changes.append(rec)
            else:
                rec["rv"] = str(e["seq"])  # dedupe keeps the newest rv
        return {"supported": True, "cursor": str(w.journal_seq),
                "expired": False, "changes": changes}

    # ---- generic ---------------------------------------------------------
    _KIND_STORES = {
        "pod": "pods",
        "deployment": "deployments",
        "statefulset": "statefulsets",
        "daemonset": "daemonsets",
        "cronjob": "cronjobs",
        "service": "services",
        "endpoints": "endpoints",
        "ingress": "ingresses",
        "networkpolicy": "network_policies",
        "configmap": "configmaps",
        "secret": "secrets",
        "persistentvolumeclaim": "pvcs",
        "pvc": "pvcs",
        "resourcequota": "resource_quotas",
        "horizontalpodautoscaler": "hpas",
        "hpa": "hpas",
    }

    def get_resource_details(
        self, namespace: str, kind: str, name: str
    ) -> Dict[str, Any]:
        store_name = self._KIND_STORES.get(kind.lower())
        if store_name is None:
            return {"error": f"unsupported resource kind: {kind}"}
        objects = getattr(self.world, store_name).get(namespace, [])
        match = None
        for obj in objects:
            if _name(obj) == name:
                match = obj
                break
        if match is None:
            for obj in objects:  # prefix fallback after all exact checks
                if _name(obj).startswith(name):
                    match = obj
                    break
        if match is None:
            return {
                "error": f"{kind}/{name} not found in namespace {namespace}"
            }
        # COPY before annotating: the stored world object must not mutate
        from rca_tpu_torch.findings import annotate_created_ago

        return annotate_created_ago(dict(match), self.get_current_time())

    def run_kubectl(self, args: List[str]) -> str:
        """Mock kubectl escape hatch — renders a describe-ish text view."""
        if len(args) >= 3 and args[0] == "describe":
            details = self.get_resource_details(
                _extract_ns(args) or "default", args[1], args[2]
            )
            import json

            return json.dumps(details, indent=2, default=str)
        return f"(mock kubectl) {' '.join(args)}"


def _field(event: dict, dotted_key: str) -> Any:
    cur: Any = event
    for part in dotted_key.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _extract_ns(args: List[str]) -> Optional[str]:
    for i, a in enumerate(args):
        if a in ("-n", "--namespace") and i + 1 < len(args):
            return args[i + 1]
    return None
