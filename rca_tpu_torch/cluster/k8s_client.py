"""Live-cluster client: kubernetes python lib when available, kubectl fallback
(the port's copy of ``rca_tpu.cluster.k8s_client``).

Implements the same :class:`ClusterClient` protocol as the mock — including
the trace methods (which return empty structures unless a trace backend is
configured), so agents never hit AttributeError against a live cluster the
way the reference's mock-only methods did (reference: utils/mock_k8s_client.py
:1044-1303 vs utils/k8s_client.py — seven methods existed only on the mock).

Metrics come from ``kubectl top`` subprocess parsing with usage percentages
computed against container limits, matching the reference's approach
(reference: utils/k8s_client.py:441-554), and resource-quantity parsing
covers millicores and the full binary/decimal memory suffix ladder
(reference: utils/k8s_client.py:886-947).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional

from rca_tpu_torch.config import env_int, env_raw
from rca_tpu_torch.findings import utcnow_iso
from rca_tpu_torch.resilience.policy import Retry, suppressed

try:  # gated: the kubernetes lib is an optional dependency
    from kubernetes import client as k8s_api
    from kubernetes import config as k8s_config

    HAVE_K8S_LIB = True
except Exception:  # pragma: no cover - exercised only without the lib
    k8s_api = None
    k8s_config = None
    HAVE_K8S_LIB = False


# ---------------------------------------------------------------------------
# Resource-quantity parsing
# ---------------------------------------------------------------------------

_MEM_SUFFIXES = {
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
    "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
    "k": 10**3, "m": 1e-3,
}


def parse_cpu(value: Any) -> float:
    """CPU quantity -> millicores. '100m' -> 100, '2' -> 2000, '1500000n' -> 1.5."""
    if value is None:
        return 0.0
    s = str(value).strip()
    if not s:
        return 0.0
    try:
        if s.endswith("n"):
            return float(s[:-1]) / 1e6
        if s.endswith("u"):
            return float(s[:-1]) / 1e3
        if s.endswith("m"):
            return float(s[:-1])
        return float(s) * 1000.0
    except ValueError:
        return 0.0


def parse_memory(value: Any) -> float:
    """Memory quantity -> bytes. Handles Ki..Ei binary and K..E decimal."""
    if value is None:
        return 0.0
    s = str(value).strip()
    if not s:
        return 0.0
    for suffix in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei"):
        if s.endswith(suffix):
            try:
                return float(s[: -len(suffix)]) * _MEM_SUFFIXES[suffix]
            except ValueError:
                return 0.0
    for suffix in ("K", "M", "G", "T", "P", "E", "k", "m"):
        if s.endswith(suffix):
            try:
                return float(s[: -len(suffix)]) * _MEM_SUFFIXES[suffix]
            except ValueError:
                return 0.0
    try:
        return float(s)
    except ValueError:
        return 0.0


class K8sApiClient:
    """Live :class:`ClusterClient` backend."""

    def __init__(
        self,
        kubeconfig: Optional[str] = None,
        context: Optional[str] = None,
        verify_ssl: bool = True,
    ):
        self._connected = False
        self._core = self._apps = self._net = self._batch = self._autoscaling = None
        # degraded-mode channel: every swallowed API/kubectl failure is
        # recorded here so "empty" is distinguishable from "denied/broken"
        # (an RBAC error must not read as a clean bill of health; the
        # reference at least surfaced connection errors, reference:
        # app.py:39-42)
        self._errors: List[Dict[str, str]] = []
        self._kubectl = shutil.which("kubectl")
        self._kubeconfig = kubeconfig or env_raw("KUBECONFIG")
        self._context = context
        self._verify_ssl = verify_ssl
        # transient API flakes retry with backoff before landing in the
        # degraded-mode error channel (RCA_API_RETRIES=0 disables)
        self._retry = Retry(
            attempts=env_int("RCA_API_RETRIES", 2, 0, 100),
            base_delay=0.1, max_delay=2.0, seed=0,
        )
        self._connect()

    def _connect(self) -> None:
        """(Re)build API clients and probe the connection."""
        self._connected = False
        # tear down watch pumps bound to the PREVIOUS connection: their
        # threads captured the old CoreV1Api at construction, so leaving
        # them running would keep serving the old cluster's change feed
        # (with still-valid tokens) while list/get calls hit the new one —
        # a streaming session would then patch new-cluster snapshots from
        # old-cluster churn.  Clearing the
        # registry makes every existing cursor read as expired, which
        # forces the one correct recovery: a full resync against the new
        # connection.
        with self._pumps_registry() as pumps_by_ns:
            for pumps in pumps_by_ns.values():
                with suppressed("k8s.reconnect_pump_stop"):
                    pumps.stop()
            pumps_by_ns.clear()
            # columnar feeds ride the pumps: their shadow worlds mirror
            # the previous cluster, so a reconnect discards them too —
            # feed generations make every old cursor read out-of-range
            # and the next get_columnar serves a fresh full dump
            self.__dict__.setdefault("_colfeeds", {}).clear()
        if not HAVE_K8S_LIB:
            return
        try:
            if self._kubeconfig:
                k8s_config.load_kube_config(
                    config_file=self._kubeconfig, context=self._context
                )
            else:
                try:
                    k8s_config.load_kube_config(context=self._context)
                except Exception:
                    k8s_config.load_incluster_config()
            if not self._verify_ssl:
                cfg = k8s_api.Configuration.get_default_copy()
                cfg.verify_ssl = False
                k8s_api.Configuration.set_default(cfg)
            self._core = k8s_api.CoreV1Api()
            self._apps = k8s_api.AppsV1Api()
            self._net = k8s_api.NetworkingV1Api()
            self._batch = k8s_api.BatchV1Api()
            self._autoscaling = k8s_api.AutoscalingV1Api()
            self._api_client = k8s_api.ApiClient()
            # connection probe (reference: utils/k8s_client.py:139)
            self._core.list_namespace(limit=1)
            self._connected = True
        except Exception as exc:
            self._record_error("connect", f"{type(exc).__name__}: {exc}")
            self._connected = False

    def reload_config(self) -> bool:
        """Re-read the kubeconfig and reconnect (reference:
        utils/k8s_client.py:181 reload_config)."""
        self._connect()
        return self._connected

    def _load_kubeconfigs(self, op: str):
        """(path, parsed) per readable kubeconfig file in the multi-file
        KUBECONFIG order, plus the resolved active context name — the ONE
        merge implementation the repair flow and the context picker share.
        Unreadable files are skipped with the failure recorded under
        ``op`` so a partial view is never silent."""
        import yaml

        raw = self._kubeconfig or os.path.expanduser("~/.kube/config")
        configs = []
        for path in [p for p in raw.split(os.pathsep) if p]:
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    configs.append((path, yaml.safe_load(f) or {}))
            except Exception as exc:
                self._record_error(
                    op, f"{path}: {type(exc).__name__}: {exc}"
                )
        current = self._context or next(
            (c.get("current-context") for _, c in configs
             if c.get("current-context")), None,
        )
        return configs, current

    def update_server_url(self, new_server_url: str) -> bool:
        """Rewrite the CURRENT context's cluster ``server`` and reconnect —
        the endpoint-repair flow for tunneled clusters whose public URL
        rotates (reference: components/sidebar.py:7-47 rewrote every
        cluster; scoping to the active context keeps a multi-cluster
        kubeconfig's other entries intact).  Honors the colon-separated
        multi-file ``KUBECONFIG`` form by repairing the file that defines
        the target cluster, and leaves a ``<file>.bak`` of the original."""
        try:
            import yaml

            # pass 1 — merged view, the way the kubernetes lib reads the
            # multi-file form: resolve the active context, then the cluster
            # it points at, across ALL files
            configs, ctx_name = self._load_kubeconfigs("update_server_url")
            target = next(
                ((ctx.get("context") or {}).get("cluster")
                 for _, c in configs
                 for ctx in c.get("contexts", []) or []
                 if ctx.get("name") == ctx_name),
                None,
            )
            if target is None:
                all_clusters = [
                    cl for _, c in configs
                    for cl in c.get("clusters", []) or []
                ]
                if len(all_clusters) == 1:
                    target = all_clusters[0].get("name")

            # pass 2 — rewrite the one file that defines the target cluster
            for path, cfg in configs:
                updated = False
                for cluster in cfg.get("clusters", []) or []:
                    if cluster.get("name") != target:
                        continue
                    inner = cluster.get("cluster")
                    if isinstance(inner, dict) and "server" in inner:
                        inner["server"] = new_server_url
                        updated = True
                if not updated:
                    continue
                # keep only the FIRST backup: a retry after a typo'd URL
                # must not clobber the pristine original with the mangled
                # intermediate
                if not os.path.exists(path + ".bak"):
                    original = open(path).read()
                    with open(path + ".bak", "w") as f:
                        f.write(original)
                with open(path, "w") as f:
                    yaml.safe_dump(cfg, f, sort_keys=False)
                return self.reload_config()
            self._record_error(
                "update_server_url",
                "no kubeconfig file defines the active context's cluster "
                "(or has a server entry to rewrite): "
                + ", ".join(p for p, _ in configs),
            )
            return False
        except Exception as exc:
            self._record_error(
                "update_server_url", f"{type(exc).__name__}: {exc}"
            )
            return False

    def list_contexts(self) -> Dict[str, Any]:
        """Contexts defined across the kubeconfig file(s) plus the active
        one — the sidebar's context picker reads this (reference:
        components/sidebar.py namespace/context pickers).  Honors the
        colon-separated multi-file ``KUBECONFIG`` form; unreadable files
        are skipped with the failure recorded, so the listing is as
        complete as the readable files allow."""
        configs, current = self._load_kubeconfigs("list_contexts")
        names: List[str] = []
        for _, cfg in configs:
            for ctx in cfg.get("contexts", []) or []:
                name = ctx.get("name")
                if name and name not in names:
                    names.append(name)
        return {"contexts": names, "current": current}

    def switch_context(self, context: str) -> bool:
        """Reconnect against another kubeconfig context (reference:
        components/sidebar.py context picker).  Leaves the kubeconfig file
        untouched — the choice is per-client.  In kubectl-only mode (no
        kubernetes lib) the switch validates the target context with a
        bounded kubectl probe instead of the lib reconnect."""
        previous = self._context
        self._context = context
        self._connect()
        if self._connected:
            return True
        if not HAVE_K8S_LIB and self._kubectl:
            # kubectl-only clients can still serve data for the new
            # context (run_kubectl passes --context); validate it works
            cmd = [self._kubectl]
            if self._kubeconfig:
                cmd += ["--kubeconfig", self._kubeconfig]
            cmd += ["--context", context, "get", "namespaces",
                    "-o", "name", "--request-timeout=5s"]
            with suppressed("k8s.switch_context_probe"):
                proc = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=10,
                    check=False,
                )
                if proc.returncode == 0:
                    return True
        # restore rather than strand the client on a broken context
        self._context = previous
        self._connect()
        return False

    # ---- helpers ---------------------------------------------------------
    def _pumps_registry(self):
        """Locked access to the namespace→WatchPumpSet registry.  The lock
        and dict are created lazily (and atomically, via ``setdefault`` on
        ``__dict__``) because concurrent sessions call ``watch_changes``
        from their own threads — an unlocked check-then-create would let
        two openers race and orphan a started pump set whose watch threads
        nothing ever stops."""
        import contextlib

        from rca_tpu_torch.util.threads import make_lock

        lock = self.__dict__.setdefault(
            "_pumps_lock", make_lock("K8sApiClient._pumps_lock")
        )
        pumps = self.__dict__.setdefault("_pumps", {})

        @contextlib.contextmanager
        def held():
            with lock:
                yield pumps

        return held()

    def _sanitize(self, obj: Any) -> Any:
        return self._api_client.sanitize_for_serialization(obj)

    def _record_error(self, op: str, detail: str) -> None:
        if len(self._errors) < 100:
            self._errors.append({"op": op, "error": detail[:300]})

    def collect_errors(self, clear: bool = True) -> List[Dict[str, str]]:
        """Swallowed failures since the last drain.  Callers (snapshot
        capture, UI status) surface these as "analysis ran against partial
        cluster state"."""
        out = list(self._errors)
        if clear:
            self._errors.clear()
        return out

    def _list(self, api, method: str, *args, **kwargs) -> List[dict]:
        # api object is looked up lazily so disconnected clients (no
        # kubernetes lib / no cluster) degrade to [] instead of raising —
        # but NEVER silently: the failure lands in the error channel.
        # Transient failures retry with backoff first (self._retry).
        if not self._connected or api is None:
            return []
        try:
            resp = self._retry.call(getattr(api, method), *args, **kwargs)
            return [self._sanitize(item) for item in resp.items]
        except Exception as exc:
            self._record_error(method, f"{type(exc).__name__}: {exc}")
            return []

    def _kubectl_json(self, args: List[str]) -> Any:
        out = self.run_kubectl(args + ["-o", "json"])
        try:
            return json.loads(out)
        except Exception:
            return None

    # ---- connection / identity -------------------------------------------
    def is_connected(self) -> bool:
        return self._connected or self._kubectl is not None

    def get_current_time(self) -> str:
        return utcnow_iso()

    def get_cluster_info(self) -> Dict[str, Any]:
        return {
            "connected": self._connected,
            "kubeconfig": self._kubeconfig,
            "nodes": len(self.get_nodes()),
            "errors": self.collect_errors(clear=False)[-10:],
            "mock": False,
        }

    def get_namespaces(self) -> List[str]:
        items = self._list(self._core, "list_namespace") if self._connected else []
        return [i.get("metadata", {}).get("name", "") for i in items]

    # ---- pods ------------------------------------------------------------
    def get_pods(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._core, "list_namespaced_pod", namespace)

    def get_pod(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        if not self._connected:
            return None
        try:
            return self._sanitize(self._retry.call(
                self._core.read_namespaced_pod, name, namespace
            ))
        except Exception as exc:
            self._record_error(
                "read_namespaced_pod", f"{type(exc).__name__}: {exc}"
            )
            return None

    def get_pod_logs(
        self,
        namespace: str,
        pod_name: str,
        container: Optional[str] = None,
        previous: bool = False,
        tail_lines: Optional[int] = None,
    ) -> str:
        if not self._connected:
            return ""
        try:
            return self._retry.call(
                self._core.read_namespaced_pod_log,
                pod_name,
                namespace,
                container=container,
                previous=previous,
                tail_lines=tail_lines,
            )
        except Exception as exc:
            self._record_error(
                "read_namespaced_pod_log", f"{type(exc).__name__}: {exc}"
            )
            return f"Error retrieving logs: {exc}"

    def get_recently_terminated_pods(self, namespace: str) -> List[Dict[str, Any]]:
        out = []
        for pod in self.get_pods(namespace):
            for cs in pod.get("status", {}).get("containerStatuses", []) or []:
                state = cs.get("state") or {}
                last = cs.get("lastState") or {}
                if "terminated" in state or "terminated" in last:
                    out.append(pod)
                    break
        return out

    # ---- workloads -------------------------------------------------------
    def get_deployments(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._apps, "list_namespaced_deployment", namespace)

    def get_deployment(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        if not self._connected:
            return None
        try:
            return self._sanitize(
                self._apps.read_namespaced_deployment(name, namespace)
            )
        except Exception:
            return None

    def get_statefulsets(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._apps, "list_namespaced_stateful_set", namespace)

    def get_daemonsets(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._apps, "list_namespaced_daemon_set", namespace)

    def get_cronjobs(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._batch, "list_namespaced_cron_job", namespace)

    # ---- services / networking -------------------------------------------
    def get_services(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._core, "list_namespaced_service", namespace)

    def get_service(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        if not self._connected:
            return None
        try:
            return self._sanitize(self._core.read_namespaced_service(name, namespace))
        except Exception:
            return None

    def get_endpoints(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._core, "list_namespaced_endpoints", namespace)

    def get_ingresses(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._net, "list_namespaced_ingress", namespace)

    def get_network_policies(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._net, "list_namespaced_network_policy", namespace)

    # ---- config / storage ------------------------------------------------
    def get_configmaps(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._core, "list_namespaced_config_map", namespace)

    def get_secrets(self, namespace: str) -> List[Dict[str, Any]]:
        secrets = self._list(self._core, "list_namespaced_secret", namespace)
        # redact values (reference: utils/k8s_client.py:693-698)
        for s in secrets:
            if isinstance(s.get("data"), dict):
                s["data"] = {k: "**REDACTED**" for k in s["data"]}
        return secrets

    def get_pvcs(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(
            self._core, "list_namespaced_persistent_volume_claim", namespace
        )

    def get_pvc(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        for p in self.get_pvcs(namespace):
            if p.get("metadata", {}).get("name") == name:
                return p
        return None

    def get_resource_quotas(self, namespace: str) -> List[Dict[str, Any]]:
        return self._list(self._core, "list_namespaced_resource_quota", namespace)

    # ---- nodes / metrics / autoscaling -----------------------------------
    def get_nodes(self) -> List[Dict[str, Any]]:
        if not self._connected:
            return []
        return self._list(self._core, "list_node")

    def get_node_metrics(self) -> Dict[str, Any]:
        """Parse ``kubectl top nodes`` into per-node usage percentages."""
        out = self.run_kubectl(["top", "nodes", "--no-headers"])
        metrics: Dict[str, Any] = {}
        for line in out.splitlines():
            parts = line.split()
            # NAME CPU(cores) CPU% MEMORY(bytes) MEMORY%
            if len(parts) >= 5 and parts[2].endswith("%") and parts[4].endswith("%"):
                try:
                    metrics[parts[0]] = {
                        "cpu": {
                            "usage": parts[1],
                            "usage_percentage": float(parts[2].rstrip("%")),
                        },
                        "memory": {
                            "usage": parts[3],
                            "usage_percentage": float(parts[4].rstrip("%")),
                        },
                    }
                except ValueError:
                    continue
        return metrics

    def get_pod_metrics(self, namespace: str) -> Dict[str, Any]:
        """``kubectl top pods --containers`` joined against container limits."""
        limits: Dict[str, Dict[str, Dict[str, float]]] = {}
        for pod in self.get_pods(namespace):
            pod_name = pod.get("metadata", {}).get("name", "")
            for c in pod.get("spec", {}).get("containers", []) or []:
                lim = (c.get("resources") or {}).get("limits") or {}
                limits.setdefault(pod_name, {})[c["name"]] = {
                    "cpu_m": parse_cpu(lim.get("cpu")),
                    "mem_b": parse_memory(lim.get("memory")),
                }
        out = self.run_kubectl(
            ["top", "pods", "-n", namespace, "--containers", "--no-headers"]
        )
        pods: Dict[str, Any] = {}
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 4:
                continue
            pod_name, container, cpu_s, mem_s = parts[0], parts[1], parts[2], parts[3]
            cpu_m = parse_cpu(cpu_s)
            mem_b = parse_memory(mem_s)
            rec = pods.setdefault(
                pod_name,
                {"cpu": {"usage_m": 0.0}, "memory": {"usage_b": 0.0}, "containers": {}},
            )
            rec["cpu"]["usage_m"] += cpu_m
            rec["memory"]["usage_b"] += mem_b
            entry: Dict[str, Any] = {
                "cpu": {"usage": cpu_s},
                "memory": {"usage": mem_s},
            }
            lim = limits.get(pod_name, {}).get(container)
            if lim:
                if lim["cpu_m"]:
                    entry["cpu"]["usage_percentage"] = round(
                        100.0 * cpu_m / lim["cpu_m"], 2
                    )
                if lim["mem_b"]:
                    entry["memory"]["usage_percentage"] = round(
                        100.0 * mem_b / lim["mem_b"], 2
                    )
            rec["containers"][container] = entry
        # pod-level percentages: max over containers (worst container governs)
        for rec in pods.values():
            cpu_pcts = [
                c["cpu"].get("usage_percentage")
                for c in rec["containers"].values()
                if c["cpu"].get("usage_percentage") is not None
            ]
            mem_pcts = [
                c["memory"].get("usage_percentage")
                for c in rec["containers"].values()
                if c["memory"].get("usage_percentage") is not None
            ]
            if cpu_pcts:
                rec["cpu"]["usage_percentage"] = max(cpu_pcts)
            if mem_pcts:
                rec["memory"]["usage_percentage"] = max(mem_pcts)
        return {"pods": pods}

    def get_hpas(self, namespace: str) -> List[Dict[str, Any]]:
        if self._connected:
            return self._list(
                self._autoscaling,
                "list_namespaced_horizontal_pod_autoscaler",
                namespace,
            )
        data = self._kubectl_json(["get", "hpa", "-n", namespace])
        return (data or {}).get("items", [])

    # ---- events ----------------------------------------------------------
    def get_events(
        self, namespace: str, field_selector: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        if not self._connected:
            return []
        try:
            resp = self._retry.call(
                self._core.list_namespaced_event,
                namespace, field_selector=field_selector,
            )
            return [self._sanitize(i) for i in resp.items]
        except Exception as exc:
            self._record_error(
                "list_namespaced_event", f"{type(exc).__name__}: {exc}"
            )
            return []

    # ---- traces -----------------------------------------------------------
    # A REAL live signal when RCA_TRACE_ENDPOINT points at a Jaeger query
    # service (rca_tpu_torch/cluster/trace_backend.py); empty
    # structures otherwise — which matches the reference, whose live
    # client had no trace surface at all (trace data existed only on its
    # mock, reference: utils/mock_k8s_client.py:1146-1303).
    def _traces(self):
        backend = self.__dict__.get("_trace_backend", False)
        if backend is False:
            from rca_tpu_torch.cluster.trace_backend import make_trace_backend

            backend = self._trace_backend = make_trace_backend()
        return backend

    def _trace_call(self, method: str, default, *args):
        backend = self._traces()
        if backend is None:
            return default
        out = getattr(backend, method)(*args)
        for err in backend.errors:
            self._record_error(f"trace.{method}", err)
        backend.errors.clear()
        return out

    def get_trace_ids(self, namespace: str, limit: int = 20) -> List[str]:
        return self._trace_call("trace_ids", [], namespace, limit)

    def get_trace_details(self, trace_id: str) -> Dict[str, Any]:
        return self._trace_call("trace_details", {}, trace_id)

    def get_service_latency_stats(self, namespace: str) -> Dict[str, Any]:
        return self._trace_call("service_latency_stats", {}, namespace)

    def get_error_rate_by_service(self, namespace: str) -> Dict[str, Any]:
        return self._trace_call("error_rate_by_service", {}, namespace)

    def get_service_dependencies(self, namespace: str) -> Dict[str, Any]:
        return self._trace_call("service_dependencies", {}, namespace)

    def find_slow_operations(
        self, namespace: str, threshold_ms: float = 500.0
    ) -> List[Dict[str, Any]]:
        return self._trace_call(
            "find_slow_operations", [], namespace, threshold_ms
        )

    # ---- generic ---------------------------------------------------------
    _KIND_ALIASES = {
        "pod": "pod", "deployment": "deployment", "statefulset": "statefulset",
        "daemonset": "daemonset", "cronjob": "cronjob", "service": "service",
        "endpoints": "endpoints", "ingress": "ingress",
        "networkpolicy": "networkpolicy", "configmap": "configmap",
        "secret": "secret", "persistentvolumeclaim": "pvc", "pvc": "pvc",
        "resourcequota": "resourcequota", "horizontalpodautoscaler": "hpa",
        "hpa": "hpa", "node": "node",
    }

    def get_resource_details(
        self, namespace: str, kind: str, name: str
    ) -> Dict[str, Any]:
        k = self._KIND_ALIASES.get(kind.lower())
        if k is None:
            return {"error": f"unsupported resource kind: {kind}"}
        data = self._kubectl_json(["get", k, name, "-n", namespace])
        if data is None:
            return {"error": f"{kind}/{name} not found in namespace {namespace}"}
        if isinstance(data, dict):
            from rca_tpu_torch.findings import annotate_created_ago

            annotate_created_ago(data, self.get_current_time())
        return data

    # ---- incremental changes (watch surface) ------------------------------
    def watch_changes(
        self, namespace: str, cursor: Optional[str]
    ) -> Dict[str, Any]:
        """Kubernetes-watch-backed incremental change feed.  Background
        pump threads hold long watch streams on pods
        and events (the kinds whose churn drives streaming features) and
        queue ``(kind, name)`` notifications; each call drains the queue
        without blocking — the poll loop never waits on the API server.

        ``cursor=None`` registers a NEW consumer on the namespace's shared
        pump set (creating the set on first use) and returns its token —
        any number of sessions share the same two watch streams, each with
        its own read position, so concurrent sessions on one namespace no
        longer thrash each other's feed.  A pump
        death (410 Gone, network error), a consumer lagging past the
        journal window, or an unknown/stale token reports ``expired`` —
        the caller resyncs from a full list exactly as a real watch
        consumer re-lists, then reopens with ``cursor=None``.  Without the
        kubernetes lib (kubectl-only clients) this surface is
        ``supported: False`` and callers keep the full-sweep path."""
        if not HAVE_K8S_LIB or not self._connected:
            return {"supported": False, "cursor": None,
                    "expired": False, "changes": []}
        from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

        # one pump set PER NAMESPACE, shared by all consumers of it
        with self._pumps_registry() as pumps_by_ns:
            pumps = pumps_by_ns.get(namespace)
            if cursor is None:
                if pumps is None or pumps.expired:
                    # a dead set is replaced; live consumers of the old set
                    # observe expiry on their next drain and reopen here too
                    if pumps is not None:
                        pumps.stop()
                    pumps = pumps_by_ns[namespace] = WatchPumpSet(
                        self._core, namespace
                    )
                    # register BEFORE starting so nothing the pumps deliver
                    # can land ahead of the first consumer's read position
                    token = pumps.register()
                    pumps.start()
                else:
                    token = pumps.register()
                return {"supported": True, "cursor": token,
                        "expired": False, "changes": []}
        changes = pumps.drain(cursor) if pumps is not None else None
        if changes is None:
            return {"supported": True, "cursor": cursor,
                    "expired": True, "changes": []}
        return {"supported": True, "cursor": cursor,
                "expired": False, "changes": changes}

    # ---- columnar feed (live adapter) -------------------------------------
    def get_columnar(self, namespace: str,
                     cursor: Optional[str] = None) -> Dict[str, Any]:
        """Live columnar capture feed: the same payload protocol the mock
        serves (full column dump once, ordered column-diff ops after, a
        full rebuild on watch expiry), built on the watch pumps' per-event
        resourceVersions by one :class:`~rca_tpu_torch.cluster.live_columnar.
        LiveColumnarFeed` per namespace.  ``supported: False`` (no
        kubernetes lib / not connected / pumps unsupported) keeps callers
        on the dict-sweep path — ``ClusterSnapshot.capture`` falls back
        exactly as it does for degenerate worlds."""
        if not HAVE_K8S_LIB or not self._connected:
            return {"supported": False, "reason": "no live connection"}
        from rca_tpu_torch.cluster.live_columnar import LiveColumnarFeed

        with self._pumps_registry():
            feeds = self.__dict__.setdefault("_colfeeds", {})
            feed = feeds.get(namespace)
            if feed is None:
                feed = feeds[namespace] = LiveColumnarFeed(self, namespace)
        return feed.payload(cursor)

    def watch_close(self, namespace: str, cursor: Optional[str]) -> None:
        """Release a consumer token acquired from :meth:`watch_changes`.
        Sessions call this when they abandon a cursor (resync acquires a
        fresh one) — an orphaned token would otherwise pin the shared
        journal's trim floor at its frozen read position forever."""
        if cursor is None:
            return
        with self._pumps_registry() as pumps_by_ns:
            pumps = pumps_by_ns.get(namespace)
        if pumps is not None:
            pumps.deregister(cursor)

    def run_kubectl(self, args: List[str]) -> str:
        if not self._kubectl:
            return "kubectl not available"
        cmd = [self._kubectl]
        if self._kubeconfig:
            cmd += ["--kubeconfig", self._kubeconfig]
        if self._context:
            # every kubectl-backed surface (top metrics, HPA fallback,
            # escape hatch) must follow a context switch, not silently
            # keep serving the previous cluster's data
            cmd += ["--context", self._context]
        cmd += args
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=30, check=False
            )
            if proc.returncode != 0:
                self._record_error(
                    "kubectl " + " ".join(args[:3]),
                    (proc.stderr or "").strip(),
                )
            return proc.stdout if proc.returncode == 0 else proc.stderr
        except Exception as exc:
            self._record_error(
                "kubectl " + " ".join(args[:3]), f"{type(exc).__name__}: {exc}"
            )
            return f"kubectl error: {exc}"
