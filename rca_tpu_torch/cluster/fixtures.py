"""Canonical faulted test worlds.

``five_service_world`` reproduces the *behavioral* content of the reference's
hermetic fixture (reference: utils/mock_k8s_client.py — database pod in
CrashLoopBackOff :154-163, api-gateway Failed on a missing env var :188,
backend CPU-hot with throttling events, resource-service near its memory
limit, a network policy whose ``from`` selector matches a nonexistent app
:617, services with empty endpoints for the broken pods :677-689, two HPAs
one of which has desired>current replicas :779-792, and canned trace
latency/error data :1146-1303) — built programmatically from the
:mod:`rca_tpu_torch.cluster.world` builders rather than literal dicts.
"""

from __future__ import annotations

from rca_tpu_torch.cluster.world import (
    World,
    container_spec,
    make_configmap,
    make_deployment,
    make_endpoints,
    make_event,
    make_hpa,
    make_ingress,
    make_network_policy,
    make_node,
    make_pod,
    make_secret,
    make_service,
    pod_metric,
    terminated_status,
    waiting_status,
)

NS = "test-microservices"

SERVICES = ["frontend", "backend", "database", "api-gateway", "resource-service"]

# service -> list of services it depends on (frontend -> api-gateway -> backend
# -> database; resource-service standalone consumer of backend)
DEPENDENCIES = {
    "frontend": ["api-gateway"],
    "api-gateway": ["backend"],
    "backend": ["database"],
    "resource-service": ["backend"],
}


def five_service_world() -> World:
    w = World(cluster_name="rca-test-cluster")
    w.nodes = [make_node("node-0"), make_node("node-1")]
    w.node_metrics = {
        "node-0": {"cpu": {"usage_percentage": 62}, "memory": {"usage_percentage": 70}},
        "node-1": {"cpu": {"usage_percentage": 45}, "memory": {"usage_percentage": 58}},
    }

    pods = {}

    def add_pod(pod):
        pods[pod["metadata"]["name"]] = pod
        w.add("pods", NS, pod)
        return pod

    # frontend: two healthy replicas
    for i, suffix in enumerate(["jk2x5", "p9x2q"]):
        add_pod(make_pod(f"frontend-7d8f675c7b-{suffix}", NS, "frontend"))

    # backend: healthy but CPU-hot (spin loop)
    be_env = [{"name": "DATABASE_URL", "value": f"http://database.{NS}.svc.cluster.local:5432"}]
    add_pod(
        make_pod(
            "backend-5b6d8f9c7d-2zf8g",
            NS,
            "backend",
            containers=[
                container_spec(
                    "backend",
                    requests={"cpu": "100m", "memory": "64Mi"},
                    limits={"cpu": "200m", "memory": "128Mi"},
                    env=be_env,
                )
            ],
        )
    )

    # database: CrashLoopBackOff with restart loop
    add_pod(
        make_pod(
            "database-7c9f8b6d5e-3x5qp",
            NS,
            "database",
            phase="Running",
            container_statuses=[
                waiting_status(
                    "database",
                    "CrashLoopBackOff",
                    "Back-off restarting failed container",
                    restarts=5,
                    last_exit_code=1,
                )
            ],
        )
    )

    # api-gateway: Failed, missing required env var
    gw_env = [{"name": "BACKEND_URL", "value": f"http://backend.{NS}.svc.cluster.local:8080"}]
    add_pod(
        make_pod(
            "api-gateway-6b7c8d9e5f-4q3zx",
            NS,
            "api-gateway",
            phase="Failed",
            containers=[
                container_spec(
                    "api-gateway",
                    requests={"cpu": "50m", "memory": "64Mi"},
                    limits={"cpu": "100m", "memory": "128Mi"},
                    env=gw_env,
                    env_from=[{"secretRef": {"name": "api-gateway-secrets"}}],
                )
            ],
            container_statuses=[
                terminated_status(
                    "api-gateway",
                    exit_code=1,
                    message="Missing required environment variable",
                    restarts=3,
                )
            ],
        )
    )

    # resource-service: running but memory near limit
    add_pod(
        make_pod(
            "resource-service-9d8e7f6c5b-1r5wq",
            NS,
            "resource-service",
            containers=[
                container_spec(
                    "resource-service",
                    requests={"cpu": "50m", "memory": "64Mi"},
                    limits={"cpu": "100m", "memory": "128Mi"},
                    volume_mounts=[{"name": "scratch", "mountPath": "/scratch"}],
                )
            ],
            volumes=[{"name": "scratch", "emptyDir": {"medium": "Memory"}}],
        )
    )

    # Deployments (api-gateway and database show ready shortfalls)
    for svc in SERVICES:
        replicas = 2 if svc == "frontend" else 1
        ready = replicas
        if svc in ("database", "api-gateway"):
            ready = 0
        w.add("deployments", NS, make_deployment(svc, NS, svc, replicas, ready))

    # Services + endpoints (broken services have no ready endpoints)
    for svc in SERVICES:
        w.add("services", NS, make_service(svc, NS))
        healthy_pods = [
            name
            for name, pod in pods.items()
            if pod["metadata"]["labels"]["app"] == svc
            and pod["status"]["phase"] == "Running"
            and all(
                cs.get("ready")
                for cs in pod["status"].get("containerStatuses", [])
            )
        ]
        w.add("endpoints", NS, make_endpoints(svc, NS, healthy_pods))

    # Config objects referenced (and one missing reference for the topology
    # agent to flag): api-gateway envFrom a secret that does not exist.
    w.add("configmaps", NS, make_configmap("frontend-config", NS, {"nginx.conf": "server {}"}))
    w.add("secrets", NS, make_secret("database-credentials", NS, ["password"]))
    w.add("ingresses", NS, make_ingress("frontend-ingress", NS, "app.example.com", "frontend"))

    # Network policy with a 'from' selector matching a nonexistent app
    w.add(
        "network_policies",
        NS,
        make_network_policy(
            "backend-network-policy", NS, {"app": "backend"},
            ingress_from_app="non-existent-service",
        ),
    )

    # HPAs: backend healthy-ish; api-gateway desired > current under low CPU
    w.add("hpas", NS, make_hpa("backend-hpa", NS, "backend", 1, 5, 1, 1, current_cpu_pct=85))
    w.add("hpas", NS, make_hpa("api-gateway-hpa", NS, "api-gateway", 1, 3, 1, 2, current_cpu_pct=40))

    # Events
    w.events[NS] = [
        make_event(NS, "Pod", "database-7c9f8b6d5e-3x5qp", "BackOff",
                   "Back-off restarting failed container database in pod "
                   "database-7c9f8b6d5e-3x5qp", count=5),
        make_event(NS, "Pod", "api-gateway-6b7c8d9e5f-4q3zx", "Failed",
                   "Error: Missing required environment variable", count=3),
        make_event(NS, "Pod", "backend-5b6d8f9c7d-2zf8g", "CPUThrottling",
                   "Container backend CPU throttled", count=10),
        make_event(NS, "Pod", "resource-service-9d8e7f6c5b-1r5wq", "MemoryHigh",
                   "Container resource-service memory usage high (89.8%)", count=2),
    ]

    # Logs (patterns chosen to trip the log agent's regex classes)
    w.logs[NS] = {
        "frontend-7d8f675c7b-jk2x5": {"frontend": _info_log("nginx serving requests")},
        "frontend-7d8f675c7b-p9x2q": {"frontend": _info_log("nginx serving requests")},
        "backend-5b6d8f9c7d-2zf8g": {"backend": _info_log("computing batch")},
        "database-7c9f8b6d5e-3x5qp": {
            "database": (
                "INFO: Starting database...\n"
                "ERROR: Database initialization failed\n"
                "FATAL: could not open relation mapping file\n"
                "INFO: Starting database...\n"
                "ERROR: Database initialization failed\n"
            )
        },
        "api-gateway-6b7c8d9e5f-4q3zx": {
            "api-gateway": (
                "INFO: API Gateway starting...\n"
                "ERROR: Missing required environment variable\n"
            )
        },
        "resource-service-9d8e7f6c5b-1r5wq": {
            "resource-service": (
                "INFO: Allocating memory resources\n"
                "WARN: Memory usage high\n"
                "WARN: Memory usage approaching limit\n"
            )
        },
    }
    w.previous_logs[NS] = {
        "database-7c9f8b6d5e-3x5qp": {
            "database": "ERROR: Database initialization failed\nexit status 1\n"
        }
    }

    # Metrics: backend at 95% CPU, resource-service at 90% memory
    w.pod_metrics[NS] = {
        "pods": {
            "frontend-7d8f675c7b-jk2x5": pod_metric(40, 48, 200, 128, "frontend"),
            "frontend-7d8f675c7b-p9x2q": pod_metric(38, 50, 200, 128, "frontend"),
            "backend-5b6d8f9c7d-2zf8g": pod_metric(190, 70, 200, 128, "backend"),
            "database-7c9f8b6d5e-3x5qp": pod_metric(5, 20, 100, 128, "database"),
            "resource-service-9d8e7f6c5b-1r5wq": pod_metric(45, 115, 100, 128, "resource-service"),
        }
    }

    # Traces: canned latency/error-rate/dependency data
    w.traces = {
        "trace_ids": {NS: [f"trace-{i:04d}" for i in range(10)]},
        "traces": {
            "trace-0000": {
                "trace_id": "trace-0000",
                "spans": [
                    {"service": "frontend", "operation": "GET /", "duration_ms": 120},
                    {"service": "api-gateway", "operation": "route", "duration_ms": 95},
                    {"service": "backend", "operation": "compute", "duration_ms": 1450},
                    {"service": "database", "operation": "query", "duration_ms": 0,
                     "error": "connection refused"},
                ],
            }
        },
        "latency": {
            NS: {
                "frontend": {"p50": 120, "p95": 300, "p99": 500},
                "api-gateway": {"p50": 95, "p95": 400, "p99": 900},
                "backend": {"p50": 500, "p95": 1450, "p99": 2000},
                "database": {"p50": 100, "p95": 200, "p99": 400},
                "resource-service": {"p50": 150, "p95": 350, "p99": 600},
            }
        },
        "error_rates": {
            NS: {
                "frontend": 0.01,
                "api-gateway": 0.25,
                "backend": 0.05,
                "database": 0.15,
                "resource-service": 0.02,
            }
        },
        "dependencies": {NS: {k: list(v) for k, v in DEPENDENCIES.items()}},
        "slow_ops": {
            NS: [
                {"service": "backend", "operation": "compute", "duration_ms": 1450},
                {"service": "api-gateway", "operation": "route", "duration_ms": 900},
            ]
        },
    }

    w.ground_truth = {
        "namespace": NS,
        "fault_roots": ["database", "api-gateway"],
        "faults": {
            "database": "CrashLoopBackOff restart loop (exit 1)",
            "api-gateway": "Failed: missing required environment variable",
            "backend": "CPU saturation (spin loop)",
            "resource-service": "memory near limit",
        },
    }
    return w


def _info_log(line: str) -> str:
    return "\n".join(f"INFO: {line} #{i}" for i in range(5)) + "\n"
