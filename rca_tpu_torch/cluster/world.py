"""In-memory cluster world model + builder helpers: the port's copy of
``rca_tpu.cluster.world``.

A :class:`World` is the hermetic backing store for :class:`MockClusterClient`
and the output of the synthetic-cascade generators.  It plays the role of the
reference's hand-written mock state (reference: utils/mock_k8s_client.py
builds ~1,300 lines of literal dicts in ``__init__``) but is constructed
programmatically from small builder functions, so worlds of 5 or 50,000
services come from the same code path.

All objects are Kubernetes-API-shaped plain dicts.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

MOCK_TIME = "2026-01-01T00:00:00Z"


def _ns_map() -> Dict[str, list]:
    return {}


@dataclasses.dataclass
class World:
    """Full cluster state, keyed by namespace where applicable."""

    cluster_name: str = "rca-mock-cluster"
    # namespace -> list of objects
    pods: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    services: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    deployments: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    statefulsets: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    daemonsets: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    cronjobs: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    events: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    endpoints: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    ingresses: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    network_policies: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    configmaps: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    secrets: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    pvcs: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    resource_quotas: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    hpas: Dict[str, List[dict]] = dataclasses.field(default_factory=_ns_map)
    # namespace -> pod -> container -> log text
    logs: Dict[str, Dict[str, Dict[str, str]]] = dataclasses.field(default_factory=dict)
    previous_logs: Dict[str, Dict[str, Dict[str, str]]] = dataclasses.field(
        default_factory=dict
    )
    # namespace -> {"pods": {pod: {"containers": {c: {...}}, "cpu": .., "memory": ..}}}
    pod_metrics: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    # cluster-scoped
    nodes: List[dict] = dataclasses.field(default_factory=list)
    node_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # traces: {"trace_ids": {...}, "traces": {...}, "latency": {...},
    #          "error_rates": {...}, "dependencies": {...}, "slow_ops": [...]}
    traces: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # ground truth for synthetic worlds (fault-injection bookkeeping)
    ground_truth: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- mutation journal (the watch surface) ------------------------------
    # Incremental-change feed backing MockClusterClient.watch_changes, the
    # hermetic twin of kubernetes watch streams.  Mutations made through
    # the real K8s API always pass the API server; in the mock, DIRECT
    # dict edits are "out-of-band" — call :meth:`touch` after one (or use
    # :meth:`add`, which journals automatically) for a watcher to see it.
    journal: List[dict] = dataclasses.field(default_factory=list)
    journal_seq: int = 0
    journal_cap: int = 10_000  # older entries trim; stale cursors expire
    journal_floor: int = 0     # seq of the oldest retained entry

    # -- derived lookup/columnar state (never part of the world's value) --
    # per-(store, namespace) name->position index: touch() was a linear
    # scan per mutation, which made building a 100k-pod world quadratic
    # (~2 min at 10k pods just stamping resourceVersions).  Verified on
    # access (list identity + length + name-at-position), rebuilt on any
    # mismatch, so out-of-band list surgery degrades to a rebuild, never
    # to a wrong stamp.
    _pos_index: Dict[tuple, dict] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False,
    )
    # namespace -> ColumnarWorld master (rca_tpu_torch.cluster.columnar),
    # created lazily by MockClusterClient.get_columnar
    _columnar: Dict[str, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False,
    )

    def namespaces(self) -> List[str]:
        names = set()
        for store in (self.pods, self.services, self.deployments, self.events):
            names.update(store.keys())
        return sorted(names) or ["default"]

    def touch(self, kind: str, namespace: str, name: str) -> None:
        """Record that object ``kind``/``name`` changed (create, update, or
        delete — watchers re-fetch, so the op is irrelevant).  ``kind`` is
        the singular store name ("pod", "service", ...) plus the pseudo
        kinds "pod_metrics", "event", and "logs".

        Mirrors the API server's write semantics by bumping the touched
        object's ``metadata.resourceVersion`` (to the journal seq): real
        clusters stamp every write, and the incremental feature extractor
        (features/extract.py) keys its row cache on it — a mock whose
        mutations kept a frozen rv would make that cache untestable."""
        self.journal_seq += 1
        store_name = self._KIND_PLURAL.get(kind, "")
        store = getattr(self, store_name, None)
        if isinstance(store, dict):
            obj = self.find(store_name, namespace, name)
            if obj is not None:
                md = obj.get("metadata")
                if isinstance(md, dict):
                    md["resourceVersion"] = str(self.journal_seq)
        self.journal.append(
            {"seq": self.journal_seq, "kind": kind,
             "namespace": namespace, "name": name}
        )
        if len(self.journal) > self.journal_cap:
            drop = len(self.journal) - self.journal_cap
            del self.journal[:drop]
            self.journal_floor = self.journal[0]["seq"]

    def changes_since(self, seq: int) -> Optional[List[dict]]:
        """Journal entries after ``seq``; None = expired (trimmed past).

        A cursor at ``floor - 1`` is still complete — it needs entries
        from ``floor`` onward, all of which are retained; only cursors
        strictly older than that have lost entries to the trim."""
        if seq < self.journal_floor - 1:
            return None
        return [e for e in self.journal if e["seq"] > seq]

    _KIND_PLURAL = {
        "pod": "pods", "service": "services", "deployment": "deployments",
        "statefulset": "statefulsets", "daemonset": "daemonsets",
        "cronjob": "cronjobs", "event": "events", "endpoints": "endpoints",
        "ingress": "ingresses", "networkpolicy": "network_policies",
        "configmap": "configmaps", "secret": "secrets", "pvc": "pvcs",
        "resourcequota": "resource_quotas", "hpa": "hpas",
    }

    _KIND_SINGULAR = {
        "pods": "pod", "services": "service", "deployments": "deployment",
        "statefulsets": "statefulset", "daemonsets": "daemonset",
        "cronjobs": "cronjob", "events": "event", "endpoints": "endpoints",
        "ingresses": "ingress", "network_policies": "networkpolicy",
        "configmaps": "configmap", "secrets": "secret", "pvcs": "pvc",
        "resource_quotas": "resourcequota", "hpas": "hpa",
    }

    # -- O(1) name lookup (verified position index) -----------------------
    def _index_for(self, store_name: str, namespace: str, lst: list) -> dict:
        key = (store_name, namespace)
        idx = self._pos_index.get(key)
        if idx is None or idx["id"] != id(lst) or idx["len"] != len(lst):
            pos: Dict[str, int] = {}
            dup = False
            for i, obj in enumerate(lst):
                n = (obj.get("metadata") or {}).get("name", "")
                if n in pos:
                    dup = True
                pos[n] = i
            idx = {"id": id(lst), "len": len(lst), "pos": pos, "dup": dup}
            self._pos_index[key] = idx
        return idx

    def find(self, store_name: str, namespace: str, name: str
             ) -> Optional[dict]:
        """The object named ``name`` in store ``store_name`` (the PLURAL
        spelling, e.g. "pods"), or None.  O(1) via the position index;
        a stale position (out-of-band list surgery) rebuilds and retries,
        so the answer always reflects the live list."""
        store = getattr(self, store_name, None)
        if not isinstance(store, dict):
            return None
        lst = store.get(namespace, [])
        idx = self._index_for(store_name, namespace, lst)
        pos = idx["pos"].get(name)
        if pos is None:
            return None
        obj = lst[pos] if pos < len(lst) else None
        if obj is None or (obj.get("metadata") or {}).get("name") != name:
            # positions shifted under a same-length rewrite: rebuild once
            del self._pos_index[(store_name, namespace)]
            idx = self._index_for(store_name, namespace, lst)
            pos = idx["pos"].get(name)
            obj = lst[pos] if pos is not None else None
        return obj

    def store_degenerate(self, store_name: str, namespace: str) -> bool:
        """True when the store holds duplicate object names — name-keyed
        incremental maintenance (columnar tables) must fall back to the
        dict scans there."""
        store = getattr(self, store_name, None)
        if not isinstance(store, dict):
            return False
        lst = store.get(namespace, [])
        return self._index_for(store_name, namespace, lst)["dup"]

    def add(self, kind: str, namespace: str, obj: dict) -> dict:
        lst = getattr(self, kind).setdefault(namespace, [])
        lst.append(obj)
        # keep the position index warm across appends (a rebuild per add
        # would make bulk world construction quadratic again)
        idx = self._pos_index.get((kind, namespace))
        if idx is not None and idx["id"] == id(lst) \
                and idx["len"] == len(lst) - 1:
            n = (obj.get("metadata") or {}).get("name", "")
            if n in idx["pos"]:
                idx["dup"] = True
            idx["pos"][n] = len(lst) - 1
            idx["len"] = len(lst)
        self.touch(
            self._KIND_SINGULAR.get(kind, kind), namespace,
            obj.get("metadata", {}).get("name", "")
            or obj.get("involvedObject", {}).get("name", ""),
        )
        return obj


# ---------------------------------------------------------------------------
# Builder helpers
# ---------------------------------------------------------------------------


def meta(name: str, namespace: Optional[str] = None, labels: Optional[dict] = None,
         **extra: Any) -> Dict[str, Any]:
    m: Dict[str, Any] = {"name": name, "creationTimestamp": MOCK_TIME}
    if namespace is not None:
        m["namespace"] = namespace
    if labels:
        m["labels"] = dict(labels)
    m.update(extra)
    return m


def container_spec(
    name: str,
    image: str = "busybox:1.36",
    requests: Optional[dict] = None,
    limits: Optional[dict] = None,
    env: Optional[List[dict]] = None,
    env_from: Optional[List[dict]] = None,
    volume_mounts: Optional[List[dict]] = None,
) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"name": name, "image": image}
    resources: Dict[str, Any] = {}
    if requests:
        resources["requests"] = requests
    if limits:
        resources["limits"] = limits
    if resources:
        spec["resources"] = resources
    if env:
        spec["env"] = env
    if env_from:
        spec["envFrom"] = env_from
    if volume_mounts:
        spec["volumeMounts"] = volume_mounts
    return spec


def running_status(name: str, restarts: int = 0, ready: bool = True) -> Dict[str, Any]:
    return {
        "name": name,
        "ready": ready,
        "restartCount": restarts,
        "state": {"running": {"startedAt": MOCK_TIME}},
    }


def waiting_status(
    name: str,
    reason: str,
    message: str = "",
    restarts: int = 0,
    last_exit_code: Optional[int] = None,
    last_reason: str = "Error",
) -> Dict[str, Any]:
    status: Dict[str, Any] = {
        "name": name,
        "ready": False,
        "restartCount": restarts,
        "state": {"waiting": {"reason": reason, "message": message}},
    }
    if last_exit_code is not None:
        status["lastState"] = {
            "terminated": {
                "exitCode": last_exit_code,
                "reason": last_reason,
                "message": message,
            }
        }
    return status


def terminated_status(
    name: str,
    exit_code: int,
    reason: str = "Error",
    message: str = "",
    restarts: int = 0,
) -> Dict[str, Any]:
    term = {"exitCode": exit_code, "reason": reason, "message": message}
    return {
        "name": name,
        "ready": False,
        "restartCount": restarts,
        "state": {"terminated": dict(term)},
        "lastState": {"terminated": dict(term)},
    }


def make_pod(
    name: str,
    namespace: str,
    app: str,
    phase: str = "Running",
    containers: Optional[List[dict]] = None,
    container_statuses: Optional[List[dict]] = None,
    init_container_statuses: Optional[List[dict]] = None,
    conditions: Optional[List[dict]] = None,
    node_name: str = "node-0",
    volumes: Optional[List[dict]] = None,
    labels: Optional[dict] = None,
) -> Dict[str, Any]:
    if containers is None:
        containers = [container_spec(app,
                                     requests={"cpu": "100m", "memory": "64Mi"},
                                     limits={"cpu": "200m", "memory": "128Mi"})]
    if container_statuses is None:
        container_statuses = [running_status(c["name"]) for c in containers]
    ready = all(cs.get("ready") for cs in container_statuses) and phase == "Running"
    if conditions is None:
        conditions = [{"type": "Ready", "status": "True" if ready else "False"}]
    pod_labels = {"app": app}
    if labels:
        pod_labels.update(labels)
    spec: Dict[str, Any] = {"containers": containers, "nodeName": node_name}
    if volumes:
        spec["volumes"] = volumes
    status: Dict[str, Any] = {
        "phase": phase,
        "conditions": conditions,
        "containerStatuses": container_statuses,
        "startTime": MOCK_TIME,
    }
    if init_container_statuses:
        status["initContainerStatuses"] = init_container_statuses
    return {
        "metadata": meta(name, namespace, pod_labels),
        "spec": spec,
        "status": status,
    }


def make_deployment(
    name: str,
    namespace: str,
    app: str,
    replicas: int = 1,
    ready_replicas: Optional[int] = None,
    available_replicas: Optional[int] = None,
    selector: Optional[dict] = None,
    template_labels: Optional[dict] = None,
    containers: Optional[List[dict]] = None,
) -> Dict[str, Any]:
    if ready_replicas is None:
        ready_replicas = replicas
    if available_replicas is None:
        available_replicas = ready_replicas
    selector = selector or {"matchLabels": {"app": app}}
    template_labels = template_labels or {"app": app}
    return {
        "metadata": meta(name, namespace, {"app": app}),
        "spec": {
            "replicas": replicas,
            "selector": selector,
            "template": {
                "metadata": {"labels": template_labels},
                "spec": {
                    "containers": containers
                    or [container_spec(app,
                                       requests={"cpu": "100m", "memory": "64Mi"},
                                       limits={"cpu": "200m", "memory": "128Mi"})]
                },
            },
        },
        "status": {
            "replicas": replicas,
            "readyReplicas": ready_replicas,
            "availableReplicas": available_replicas,
            "updatedReplicas": replicas,
        },
    }


def make_service(
    name: str,
    namespace: str,
    selector: Optional[dict] = None,
    port: int = 80,
    target_port: int = 8080,
    service_type: str = "ClusterIP",
) -> Dict[str, Any]:
    return {
        "metadata": meta(name, namespace, {"app": name}),
        "spec": {
            "selector": selector if selector is not None else {"app": name},
            "ports": [{"port": port, "targetPort": target_port, "protocol": "TCP"}],
            "type": service_type,
        },
        "status": {},
    }


def make_endpoints(
    name: str, namespace: str, pod_names: List[str], port: int = 8080
) -> Dict[str, Any]:
    subsets: List[dict] = []
    if pod_names:
        subsets = [
            {
                "addresses": [
                    {
                        "ip": f"10.244.0.{i + 2}",
                        "targetRef": {"kind": "Pod", "name": p},
                    }
                    for i, p in enumerate(pod_names)
                ],
                "ports": [{"port": port, "protocol": "TCP"}],
            }
        ]
    return {"metadata": meta(name, namespace), "subsets": subsets}


def make_event(
    namespace: str,
    kind: str,
    obj_name: str,
    reason: str,
    message: str,
    etype: str = "Warning",
    count: int = 1,
    source_component: str = "kubelet",
) -> Dict[str, Any]:
    digest = hashlib.sha1(
        f"{obj_name}/{reason}/{message}".encode()
    ).hexdigest()[:12]
    return {
        "metadata": meta(f"{obj_name}.{digest}", namespace),
        "involvedObject": {"kind": kind, "name": obj_name, "namespace": namespace},
        "type": etype,
        "reason": reason,
        "message": message,
        "count": count,
        "source": {"component": source_component},
        "firstTimestamp": MOCK_TIME,
        "lastTimestamp": MOCK_TIME,
    }


def make_hpa(
    name: str,
    namespace: str,
    target: str,
    min_replicas: int,
    max_replicas: int,
    current_replicas: int,
    desired_replicas: int,
    current_cpu_pct: Optional[int] = None,
    target_cpu_pct: int = 80,
) -> Dict[str, Any]:
    return {
        "metadata": meta(name, namespace),
        "spec": {
            "scaleTargetRef": {"kind": "Deployment", "name": target},
            "minReplicas": min_replicas,
            "maxReplicas": max_replicas,
            "targetCPUUtilizationPercentage": target_cpu_pct,
        },
        "status": {
            "currentReplicas": current_replicas,
            "desiredReplicas": desired_replicas,
            "currentCPUUtilizationPercentage": current_cpu_pct,
        },
    }


def make_network_policy(
    name: str,
    namespace: str,
    pod_selector: dict,
    ingress_from_app: Optional[str] = None,
    policy_types: Optional[List[str]] = None,
) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "podSelector": {"matchLabels": pod_selector},
        "policyTypes": policy_types or ["Ingress"],
    }
    if ingress_from_app is not None:
        spec["ingress"] = [
            {"from": [{"podSelector": {"matchLabels": {"app": ingress_from_app}}}]}
        ]
    return {"metadata": meta(name, namespace), "spec": spec}


def make_ingress(
    name: str, namespace: str, host: str, service: str, port: int = 80,
    tls: bool = False
) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "rules": [
            {
                "host": host,
                "http": {
                    "paths": [
                        {
                            "path": "/",
                            "pathType": "Prefix",
                            "backend": {
                                "service": {
                                    "name": service,
                                    "port": {"number": port},
                                }
                            },
                        }
                    ]
                },
            }
        ]
    }
    if tls:
        spec["tls"] = [{"hosts": [host], "secretName": f"{name}-tls"}]
    return {"metadata": meta(name, namespace), "spec": spec}


def make_configmap(name: str, namespace: str, data: Optional[dict] = None) -> dict:
    return {"metadata": meta(name, namespace), "data": data or {}}


def make_secret(name: str, namespace: str, keys: Optional[List[str]] = None) -> dict:
    return {
        "metadata": meta(name, namespace),
        "type": "Opaque",
        "data": {k: "**REDACTED**" for k in (keys or [])},
    }


def make_node(
    name: str,
    ready: bool = True,
    conditions: Optional[List[dict]] = None,
    cpu_capacity: str = "4",
    memory_capacity: str = "16Gi",
) -> Dict[str, Any]:
    if conditions is None:
        conditions = [
            {"type": "Ready", "status": "True" if ready else "False"},
            {"type": "MemoryPressure", "status": "False"},
            {"type": "DiskPressure", "status": "False"},
            {"type": "NetworkUnavailable", "status": "False"},
        ]
    return {
        "metadata": meta(name, labels={"kubernetes.io/hostname": name}),
        "status": {
            "conditions": conditions,
            "capacity": {"cpu": cpu_capacity, "memory": memory_capacity},
            "allocatable": {"cpu": cpu_capacity, "memory": memory_capacity},
            "nodeInfo": {"kubeletVersion": "v1.30.0"},
        },
    }


def pod_metric(
    cpu_millicores: float,
    memory_mib: float,
    cpu_limit_millicores: Optional[float] = None,
    memory_limit_mib: Optional[float] = None,
    container: str = "main",
) -> Dict[str, Any]:
    """Per-pod usage record in the shape the metrics agent consumes.

    Mirrors the reference's ``kubectl top``-derived structure with
    ``usage_percentage`` computed against container limits
    (reference: utils/k8s_client.py:520-546).
    """
    rec: Dict[str, Any] = {
        "cpu": {"usage": f"{int(cpu_millicores)}m"},
        "memory": {"usage": f"{int(memory_mib)}Mi"},
        "containers": {},
    }
    if cpu_limit_millicores:
        rec["cpu"]["usage_percentage"] = round(
            100.0 * cpu_millicores / cpu_limit_millicores, 2
        )
    if memory_limit_mib:
        rec["memory"]["usage_percentage"] = round(
            100.0 * memory_mib / memory_limit_mib, 2
        )
    rec["containers"][container] = {
        "cpu": dict(rec["cpu"]),
        "memory": dict(rec["memory"]),
    }
    return rec
