"""The 200-pod OOMKill-chain configuration (BASELINE.md row 3), for the
port (the twin of ``rca_tpu.cluster.oomchain``).

One root service whose memory fault — a memory-backed emptyDir filled
past the 128Mi limit, so the kernel OOM-kills it — cascades through ~200
pods arranged in a dependency tree.  This module is the single source of
truth for that configuration in the port:

- :func:`oom_chain_topology` — the service tree + replica plan, the same
  tree the JAX package's kind manifest generator builds;
- :func:`oom_chain_world` — the hermetic :class:`World`: root pods
  OOMKilled + CrashLoopBackOff, victim pods Running but logging
  connection-refused probes at their parent, ground truth naming the root;
- :func:`measure_analyze` — the row-3 measurement hook: end-to-end
  analyze latency + hit@1 against any cluster client (live or mock), on
  the card unless the caller names the CPU (``device="cpu"``).  It
  returns the record; writing it anywhere is its caller's business.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

OOM_NS = "oom-chain"
OOM_ROOT = "cache"
ROOT_REPLICAS = 2


def oom_chain_topology(
    n_pods: int = 200, replicas_per_service: int = 3
) -> Tuple[List[str], Dict[str, str], Dict[str, int]]:
    """(services, parent-of, replicas-of) totalling ~``n_pods`` pods.

    The victims form a binary tree rooted at :data:`OOM_ROOT` (depth
    ~log2(n_victims) ≈ 6 at 200 pods — within the engine's 8 propagation
    steps), each depending on its parent via an env-var service URL the
    topology builder turns into a dependency edge."""
    n_victims = max(1, (n_pods - ROOT_REPLICAS) // replicas_per_service)
    services = [OOM_ROOT] + [f"svc-{i:03d}" for i in range(n_victims)]
    parent: Dict[str, str] = {}
    for i in range(n_victims):
        parent[f"svc-{i:03d}"] = (
            OOM_ROOT if i == 0 else f"svc-{(i - 1) // 2:03d}"
        )
    replicas = {OOM_ROOT: ROOT_REPLICAS}
    for i in range(n_victims):
        replicas[f"svc-{i:03d}"] = replicas_per_service
    return services, parent, replicas


def oom_chain_world(n_pods: int = 200):
    """Hermetic twin of the ``oom-chain-200`` kind profile.

    Root pods: container OOMKilled (exit 137) and waiting in
    CrashLoopBackOff, memory metric pinned at its limit, kubelet OOMKilling
    events.  Victim pods: Running and ready, but their logs carry
    connection-refused probe failures against the parent service — soft
    symptoms the engine must explain away up the tree to the one true
    root."""
    from rca_tpu_torch.cluster.world import (
        World,
        container_spec,
        make_deployment,
        make_endpoints,
        make_event,
        make_node,
        make_pod,
        make_service,
        pod_metric,
        waiting_status,
    )

    services, parent, replicas = oom_chain_topology(n_pods)
    w = World(cluster_name="rca-oom-chain")
    w.nodes = [make_node(f"node-{i}") for i in range(4)]
    w.node_metrics = {
        n["metadata"]["name"]: {
            "cpu": {"usage_percentage": 55},
            "memory": {"usage_percentage": 60},
        }
        for n in w.nodes
    }
    w.pod_metrics[OOM_NS] = {"pods": {}}
    w.logs[OOM_NS] = {}
    w.events[OOM_NS] = []

    def pod_name(svc: str, i: int) -> str:
        return f"{svc}-{i}"

    for svc in services:
        for i in range(replicas[svc]):
            name = pod_name(svc, i)
            if svc == OOM_ROOT:
                pod = make_pod(
                    name, OOM_NS, svc,
                    containers=[
                        container_spec(
                            svc,
                            requests={"cpu": "50m", "memory": "64Mi"},
                            limits={"cpu": "100m", "memory": "128Mi"},
                            volume_mounts=[{"name": "scratch",
                                            "mountPath": "/scratch"}],
                        )
                    ],
                    container_statuses=[
                        waiting_status(
                            svc, "CrashLoopBackOff",
                            "Back-off restarting failed container",
                            restarts=7, last_exit_code=137,
                            last_reason="OOMKilled",
                        )
                    ],
                    volumes=[{"name": "scratch",
                              "emptyDir": {"medium": "Memory"}}],
                )
                w.pod_metrics[OOM_NS]["pods"][name] = pod_metric(
                    20, 127, 100, 128, svc
                )
                w.logs[OOM_NS][name] = {svc: (
                    "INFO: cache warming...\n"
                    "INFO: loading 150MiB working set\n"
                )}
                w.events[OOM_NS].append(make_event(
                    OOM_NS, "Pod", name, "OOMKilling",
                    f"Memory cgroup out of memory: Killed process "
                    f"({svc})", count=7,
                ))
                w.events[OOM_NS].append(make_event(
                    OOM_NS, "Pod", name, "BackOff",
                    "Back-off restarting failed container", count=7,
                ))
            else:
                up = parent[svc]
                pod = make_pod(
                    name, OOM_NS, svc,
                    containers=[
                        container_spec(
                            svc,
                            requests={"cpu": "25m", "memory": "32Mi"},
                            limits={"cpu": "100m", "memory": "64Mi"},
                            env=[{
                                "name": "PARENT_URL",
                                "value": f"http://{up}.{OOM_NS}"
                                         ".svc.cluster.local:80",
                            }],
                        )
                    ],
                )
                w.pod_metrics[OOM_NS]["pods"][name] = pod_metric(
                    10, 20, 100, 64, svc
                )
                w.logs[OOM_NS][name] = {svc: (
                    f"INFO: probing {up}\n"
                    f"ERROR: connection refused to {up}:80 "
                    "(ECONNREFUSED)\n"
                    "ERROR: upstream request failed\n"
                ) * 2}
            w.add("pods", OOM_NS, pod)

    for svc in services:
        broken = svc == OOM_ROOT
        w.add("deployments", OOM_NS, make_deployment(
            svc, OOM_NS, svc, replicas[svc],
            0 if broken else replicas[svc],
        ))
        w.add("services", OOM_NS, make_service(svc, OOM_NS))
        healthy = (
            [] if broken
            else [pod_name(svc, i) for i in range(replicas[svc])]
        )
        w.add("endpoints", OOM_NS, make_endpoints(svc, OOM_NS, healthy))

    w.traces = {
        "dependencies": {OOM_NS: {
            svc: [parent[svc]] for svc in services if svc in parent
        }},
    }
    w.ground_truth = {
        "namespace": OOM_NS,
        "fault_roots": [OOM_ROOT],
        "faults": {OOM_ROOT: "OOMKilled restart loop (exit 137; "
                             "memory-backed volume exceeds 128Mi limit)"},
        "n_pods": sum(replicas.values()),
    }
    return w


def measure_analyze(
    client, namespace: str, expected_root: str, backend: str = "torch",
    device=None,
) -> Dict[str, object]:
    """BASELINE.md row-3 measurement: TWO end-to-end comprehensive
    analyses (snapshot capture → agents → engine correlation) through the
    public coordinator API, wall-clock timed — the first run as this
    process finds things (the kernel library's load, the shape's registry
    row where it is not resolved yet), the second warm — plus hit@1/hit@3
    against the expected root.  Both numbers are recorded so the record
    says what was measured instead of claiming a single ambiguous
    latency.  ``device``: the coordinator's (the card unless ``"cpu"``; no
    card raises).  ``backend`` and ``fallback_reason`` stay in the record,
    so a fallback is visible.  Works against a live cluster and the
    hermetic mock twin alike; the caller keeps the dict."""
    from rca_tpu_torch.coordinator import RCACoordinator

    coord = RCACoordinator(client, backend=backend, device=device)
    t0 = time.perf_counter()
    coord.run_analysis("comprehensive", namespace)
    first_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    record = coord.run_analysis("comprehensive", namespace)
    warm_ms = (time.perf_counter() - t1) * 1e3
    corr = record.get("results", {}).get("correlated", {})
    ranked = [r["component"] for r in corr.get("root_causes", [])]
    from rca_tpu_torch.cluster.mock_client import MockClusterClient

    return {
        "metric": "oom_chain_200_analyze",
        # honest provenance: a mock-twin measurement (any subclass or the
        # class itself) must never read as a live-cluster number
        "environment": (
            "hermetic-mock" if isinstance(client, MockClusterClient)
            else "live-kind"
        ),
        "namespace": namespace,
        "status": record.get("status"),
        "backend": corr.get("backend"),
        "engine": corr.get("engine", "single"),
        "fallback_reason": corr.get("fallback_reason"),
        "latency_first_run_ms": round(first_ms, 1),
        "latency_warm_ms": round(warm_ms, 1),
        "engine_latency_ms": corr.get("engine_latency_ms"),
        "expected_root": expected_root,
        "top5": ranked[:5],
        "hit1": bool(ranked and ranked[0] == expected_root),
        "hit3": expected_root in ranked[:3],
    }
