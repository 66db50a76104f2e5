"""Jaeger-HTTP trace backend: a LIVE signal behind the protocol's trace
methods (the port's copy of ``rca_tpu.cluster.trace_backend``).

Traces were the reference's weakest signal: its trace data existed only on
the mock client (reference: utils/mock_k8s_client.py:1146-1303 — canned
trace ids, latency stats, error rates, dependencies), and its live client
had no trace methods at all; its traces agent's latency/error analyses
were simulated stubs (reference: agents/traces_agent.py:209-381).  This
module makes the live path real: point ``RCA_TRACE_ENDPOINT`` at a Jaeger
query service (``http://jaeger-query:16686``) and
:class:`rca_tpu_torch.cluster.k8s_client.K8sApiClient` serves the SAME
structures the mock does — the traces agent, the feature extractor's
error-rate/latency channels, and the trace-derived dependency edges all
light up unchanged.

Only stdlib HTTP (urllib) — no new dependencies; the opener is injectable
so the conformance suite drives the adapter from recorded Jaeger JSON
without a network (tests/test_torch_k8s_client.py).

Jaeger query API used (stable since 1.x):

- ``GET /api/services``                      → {"data": [service names]}
- ``GET /api/traces?service=S&limit=N...``   → {"data": [trace objects]}
- ``GET /api/traces/{trace_id}``             → {"data": [one trace]}
- ``GET /api/dependencies?endTs=ms&lookback=ms`` → {"data": [{parent,
  child, callCount}]}

Derivations (all shapes mirror MockClusterClient):

- latency stats: per-service span-duration percentiles (p50/p95/p99, ms);
- error rate: fraction of a service's spans tagged ``error=true`` or with
  a 5xx ``http.status_code``;
- dependencies: {parent: [children]} from the dependency endpoint;
- slow operations: spans over the threshold, most recent traces first.

Namespaces: Jaeger service names carry no namespace.  The conventional
deployment runs one Jaeger per cluster with services named after their
Kubernetes services, so the adapter serves every service it sees for any
namespace; operators running ``service.namespace`` naming can filter with
``RCA_TRACE_SERVICE_SUFFIX=.<ns>`` (matched and stripped).
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from rca_tpu_torch.config import env_raw, env_str

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_LOOKBACK_S = 3600
_MS = 1000.0  # Jaeger span times are microseconds


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class JaegerTraceBackend:
    """Read-only adapter over one Jaeger query endpoint."""

    def __init__(
        self,
        endpoint: str,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        lookback_s: int = DEFAULT_LOOKBACK_S,
        opener: Optional[Callable[[str], bytes]] = None,
        service_suffix: str = "",
        trace_limit: int = 40,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s
        self.lookback_s = lookback_s
        self.service_suffix = service_suffix
        self.trace_limit = trace_limit
        self._opener = opener or self._http_get
        # errors surface through the client's degraded-mode channel; the
        # adapter itself never raises into the analysis path
        self.errors: List[str] = []

    # -- transport ----------------------------------------------------------
    def _http_get(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.read()

    def _get(self, path: str, **params: Any) -> Any:
        url = self.endpoint + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None}
            )
        try:
            return json.loads(self._opener(url).decode("utf-8"))
        except Exception as exc:
            if len(self.errors) < 20:
                self.errors.append(f"{path}: {type(exc).__name__}: {exc}")
            return None

    # -- raw fetches --------------------------------------------------------
    def _services(self) -> List[str]:
        data = (self._get("/api/services") or {}).get("data") or []
        if self.service_suffix:
            data = [s for s in data if s.endswith(self.service_suffix)]
        return [self._strip(s) for s in data if s]

    def _strip(self, service: str) -> str:
        if self.service_suffix and service.endswith(self.service_suffix):
            return service[: -len(self.service_suffix)]
        return service

    def _traces_for(self, service: str, limit: int) -> List[dict]:
        data = self._get(
            "/api/traces",
            service=service + self.service_suffix,
            limit=limit,
            lookback=f"{self.lookback_s}s",
        )
        return (data or {}).get("data") or []

    @staticmethod
    def _spans_by_service(trace: dict):
        """(service, span) pairs via the trace's process table."""
        procs = {
            pid: (p or {}).get("serviceName", "")
            for pid, p in (trace.get("processes") or {}).items()
        }
        for span in trace.get("spans") or []:
            yield procs.get(span.get("processID", ""), ""), span

    @staticmethod
    def _span_errored(span: dict) -> bool:
        for tag in span.get("tags") or []:
            key, val = tag.get("key"), tag.get("value")
            if key == "error" and val in (True, "true", "True"):
                return True
            if key == "http.status_code":
                try:
                    if int(val) >= 500:
                        return True
                except (TypeError, ValueError):
                    pass
        return False

    def _sample(self) -> Dict[str, List[dict]]:
        """service -> its spans, across a bounded trace sample per service.

        Traces are deduplicated by traceID across the per-service sweep: a
        trace touching services A, B and C comes back from all three
        queries, and counting its spans three times would skew error rates
        and latency percentiles toward widely-shared traces (and emit
        duplicate slow-operation rows)."""
        per_service: Dict[str, List[dict]] = {}
        seen: set = set()
        for svc in self._services():
            for trace in self._traces_for(svc, self.trace_limit):
                tid = trace.get("traceID")
                if tid in seen:
                    continue
                seen.add(tid)
                for sname, span in self._spans_by_service(trace):
                    sname = self._strip(sname)
                    if sname:
                        per_service.setdefault(sname, []).append(span)
        return per_service

    # -- protocol surface (mock-twin shapes) --------------------------------
    def trace_ids(self, namespace: str, limit: int = 20) -> List[str]:
        ids: List[str] = []
        for svc in self._services():
            for trace in self._traces_for(svc, limit):
                tid = trace.get("traceID")
                if tid and tid not in ids:
                    ids.append(tid)
                if len(ids) >= limit:
                    return ids
        return ids

    def trace_details(self, trace_id: str) -> Dict[str, Any]:
        data = self._get(f"/api/traces/{urllib.parse.quote(trace_id)}")
        traces = (data or {}).get("data") or []
        if not traces:
            return {}
        trace = traces[0]
        spans = []
        services = set()
        t0 = None
        t_end = 0.0
        for sname, span in self._spans_by_service(trace):
            sname = self._strip(sname)
            services.add(sname)
            start = float(span.get("startTime", 0) or 0)
            dur = float(span.get("duration", 0) or 0)
            t0 = start if t0 is None else min(t0, start)
            t_end = max(t_end, start + dur)
            spans.append({
                "service": sname,
                "operation": span.get("operationName", ""),
                "duration_ms": round(dur / _MS, 3),
                "error": self._span_errored(span),
            })
        return {
            "trace_id": trace.get("traceID", trace_id),
            "duration_ms": round(max(t_end - (t0 or 0.0), 0.0) / _MS, 3),
            "services": sorted(services),
            "span_count": len(spans),
            "spans": spans,
        }

    def service_latency_stats(self, namespace: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for svc, spans in self._sample().items():
            durs = sorted(
                float(s.get("duration", 0) or 0) / _MS for s in spans
            )
            if durs:
                out[svc] = {
                    "p50": round(_percentile(durs, 0.50), 3),
                    "p95": round(_percentile(durs, 0.95), 3),
                    "p99": round(_percentile(durs, 0.99), 3),
                }
        return out

    def error_rate_by_service(self, namespace: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for svc, spans in self._sample().items():
            if spans:
                errored = sum(1 for s in spans if self._span_errored(s))
                out[svc] = round(errored / len(spans), 4)
        return out

    def service_dependencies(self, namespace: str) -> Dict[str, Any]:
        data = self._get(
            "/api/dependencies",
            endTs=int(time.time() * 1000),
            lookback=self.lookback_s * 1000,
        )
        deps: Dict[str, List[str]] = {}
        for link in (data or {}).get("data") or []:
            parent = self._strip(str(link.get("parent", "")))
            child = self._strip(str(link.get("child", "")))
            if parent and child and parent != child:
                deps.setdefault(parent, [])
                if child not in deps[parent]:
                    deps[parent].append(child)
        return {k: sorted(v) for k, v in deps.items()}

    def find_slow_operations(
        self, namespace: str, threshold_ms: float = 500.0
    ) -> List[Dict[str, Any]]:
        out = []
        for svc, spans in self._sample().items():
            for span in spans:
                dur_ms = float(span.get("duration", 0) or 0) / _MS
                if dur_ms >= threshold_ms:
                    out.append({
                        "service": svc,
                        "operation": span.get("operationName", ""),
                        "duration_ms": round(dur_ms, 3),
                        "trace_id": span.get("traceID", ""),
                    })
        out.sort(key=lambda op: -op["duration_ms"])
        return out


def make_trace_backend() -> Optional[JaegerTraceBackend]:
    """Backend from ``RCA_TRACE_ENDPOINT`` (unset → None, the empty-trace
    behavior the live client always had)."""
    endpoint = env_str("RCA_TRACE_ENDPOINT", "")
    if not endpoint:
        return None
    # accept an explicit scheme prefix ("jaeger:http://...") for future
    # backends; plain URLs mean jaeger
    if endpoint.lower().startswith("jaeger:"):
        endpoint = endpoint[len("jaeger:"):]
    return JaegerTraceBackend(
        endpoint,
        service_suffix=env_raw("RCA_TRACE_SERVICE_SUFFIX", "") or "",
    )
