"""Traces agent: platform detection, latency/error analysis, slow operations.

Parity with the reference's traces agent (reference: agents/traces_agent.py —
platform detection via service labels jaeger/zipkin/opentelemetry :43-45,
:118-146, instrumentation detection via env-var names :148-207, latency /
error-rate / dependency analyses :209-381).  Where the reference simulated
those analyses, this one computes them from the snapshot's trace data
(latency percentiles, per-service error rates, dependency fan-in) using the
same degradation scores the feature extractor packs for the engine.
"""

from __future__ import annotations

import numpy as np

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.features.schema import SvcF

TRACING_PLATFORMS = ("jaeger", "zipkin", "opentelemetry", "tempo")
INSTRUMENTATION_ENV_HINTS = (
    "OTEL_", "JAEGER_", "ZIPKIN_", "TRACING_", "TRACE_AGENT",
)
ERROR_HIGH, ERROR_MEDIUM = 0.10, 0.05
SLOW_MS = 500.0


class TracesAgent(Agent):
    agent_type = "traces"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        snap = ctx.snapshot
        fs = ctx.features
        traces = snap.traces or {}

        # -- platform / instrumentation detection ----------------------------
        platforms = set()
        for obj in list(snap.services) + list(snap.deployments):
            labels = obj.get("metadata", {}).get("labels", {}) or {}
            text = " ".join([*labels.keys(), *labels.values()]).lower()
            name = obj.get("metadata", {}).get("name", "").lower()
            for p in TRACING_PLATFORMS:
                if p in text or p in name:
                    platforms.add(p)
        instrumented = []
        for pod in snap.pods:
            for c in pod.get("spec", {}).get("containers", []) or []:
                env_names = {e.get("name", "") for e in c.get("env", []) or []}
                if any(
                    n.startswith(INSTRUMENTATION_ENV_HINTS) for n in env_names
                ):
                    instrumented.append(pod.get("metadata", {}).get("name", ""))
                    break
        r.add_step(
            f"Tracing platforms detected: {sorted(platforms) or 'none'}; "
            f"{len(instrumented)} pod(s) carry instrumentation env vars.",
            "Trace-derived signals follow." if traces else
            "No trace data in snapshot; structural checks only.",
        )
        if not platforms and not traces:
            r.add_finding(
                f"Namespace/{snap.namespace}",
                "no tracing platform detected in the namespace",
                "info",
                {"checked_labels": list(TRACING_PLATFORMS)},
                "Deploy a tracing backend (e.g. an OpenTelemetry collector) "
                "to make latency root-causing possible",
            )

        # -- per-service error rates ------------------------------------------
        err = traces.get("error_rates") or {}
        for name, rate in sorted(err.items()):
            rate = float(rate)
            if rate >= ERROR_MEDIUM:
                r.add_finding(
                    f"Service/{name}",
                    f"trace error rate at {rate * 100:.0f}%",
                    "high" if rate >= ERROR_HIGH else "medium",
                    {"error_rate": rate},
                    "Inspect failing spans for this service; correlate with "
                    "its logs and upstream dependencies",
                )

        # -- latency degradation (packed channel: p99 vs namespace median) ---
        lat = traces.get("latency") or {}
        degraded = np.nonzero(fs.service_features[:, SvcF.LATENCY] > 0.25)[0]
        for i in degraded.tolist():
            name = fs.service_names[i]
            stats = lat.get(name) or {}
            r.add_finding(
                f"Service/{name}",
                f"p99 latency degraded ({stats.get('p99', '?')} ms vs "
                "namespace median)",
                "medium",
                {"latency_stats": stats,
                 "degradation_score": round(
                     float(fs.service_features[i, SvcF.LATENCY]), 3)},
                "Profile this service's slow spans; check its downstream "
                "dependencies for queuing",
            )

        # -- slow operations ---------------------------------------------------
        slow = traces.get("slow_ops") or []
        if slow:
            r.add_finding(
                f"Namespace/{snap.namespace}",
                f"{len(slow)} operation(s) exceed {SLOW_MS:.0f} ms",
                "medium",
                {"slow_operations": slow[:10]},
                "Optimize or parallelize the listed operations",
            )

        # -- dependency fan-in: services many others depend on ----------------
        deps = traces.get("dependencies") or {}
        fan_in: dict = {}
        for src_name, dst_names in deps.items():
            for d in dst_names or []:
                fan_in[d] = fan_in.get(d, 0) + 1
        for name, count in sorted(fan_in.items()):
            if count >= 3:
                r.add_finding(
                    f"Service/{name}",
                    f"{count} services depend on this one (high fan-in)",
                    "info",
                    {"dependents": count},
                    "Treat this service as critical-path: prioritize its "
                    "alerts and capacity",
                )

        # viz payload: per-service latency percentiles + the dependency map
        # (reference: components/visualization.py latency charts per service
        # and the :516-646 service-dependency digraph)
        if lat:
            r.data["latency"] = {
                name: stats for name, stats in sorted(lat.items())
                if isinstance(stats, dict)
            }
        deps_map = traces.get("dependencies") or {}
        if deps_map:
            r.data["dependencies"] = {
                src: sorted(dsts) for src, dsts in sorted(deps_map.items())
                if dsts
            }

        summarize(r, "trace")
        return r
