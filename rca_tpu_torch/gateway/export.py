"""``/metrics`` text exposition: ServeMetrics and the gateway's counters
(the port's copy of ``rca_tpu.gateway.export``; metric names and labels
are the reference's, so its dashboards read the port unchanged).

Prometheus text format (``# TYPE`` lines and ``name{labels} value``),
built from two consistent snapshots —
:meth:`rca_tpu_torch.serve.metrics.ServeMetrics.summary` (one lock-guarded
copy of the serving plane: per-tenant counters, per-replica rows, cache
events) and the gateway's own HTTP counters — so a scrape never
interleaves with the replicas mutating the live accumulators.  Gauges
carry a millisecond timestamp; per-tenant request durations export as a
``histogram`` family (``rca_request_duration_seconds``, cumulative ``le``
buckets and ``_sum`` / ``_count``) beside the SLO burn counters.

The help strings say what the port counts: a "compile" is a build of the
kernel library or a registry plan election (kernelscope), device memory
is the CUDA caching allocator's bytes in use (which has no live-buffer
count, so ``rca_device_live_buffers`` carries no sample), and a row's
cost is the registry's capture (``KernelRegistry.ensure_cost``): the
cost model's operations and bytes of the canonical call, sampled for
every captured row, and the CUDA allocator's peak during one run of the
winner, sampled for every row captured on the card.  A scrape exports
what is captured and never captures.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_TENANT_COUNTERS = (
    "submitted", "answered", "shed", "rejected", "degraded", "errors",
)


def _esc(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _line(out: List[str], name: str, value, ts: Optional[int] = None,
          **labels) -> None:
    if value is None:
        return
    suffix = f" {ts}" if ts is not None else ""
    if labels:
        lab = ",".join(
            f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())
        )
        out.append(f"{name}{{{lab}}} {value}{suffix}")
    else:
        out.append(f"{name} {value}{suffix}")


def _head(out: List[str], name: str, kind: str, help_: str) -> None:
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {kind}")


def render_metrics_text(
    serve_summary: Dict[str, Any],
    gateway: Optional[Dict[str, Any]] = None,
    healthy: Optional[bool] = None,
    now_ms: Optional[int] = None,
    kernelscope: Optional[Dict[str, Any]] = None,
) -> str:
    """The full exposition body (text/plain; version=0.0.4).
    ``now_ms`` (ms since epoch, from the gateway's wall seam) stamps
    every GAUGE sample; counters stay timestamp-free per convention.
    ``kernelscope`` is the plane's ``kernelscope_summary()``: recompile
    counters, the device-memory sample and the kernel registry's rows."""
    out: List[str] = []

    if kernelscope is not None:
        _head(out, "rca_recompiles_total", "counter",
              "repeated kernel-library builds or registry plan "
              "elections of one signature on the serve path "
              "(kernelscope watchdog)")
        _line(out, "rca_recompiles_total",
              kernelscope.get("recompiles", 0))
        _head(out, "rca_compiles_total", "counter",
              "kernel-library builds and registry plan elections "
              "observed since the plane started")
        _line(out, "rca_compiles_total", kernelscope.get("compiles", 0))
        mem = kernelscope.get("device_memory") or {}
        if mem:
            _head(out, "rca_device_bytes_in_use", "gauge",
                  "CUDA memory in use (the caching allocator's "
                  "allocated bytes, per device and summed)")
            _line(out, "rca_device_bytes_in_use",
                  mem.get("bytes_in_use"), ts=now_ms)
            for dev, rec in sorted((mem.get("devices") or {}).items()):
                _line(out, "rca_device_bytes_in_use",
                      rec.get("bytes_in_use"), ts=now_ms, device=dev)
            _head(out, "rca_device_live_buffers", "gauge",
                  "live device buffers (not counted by the CUDA "
                  "caching allocator: no sample)")
            _line(out, "rca_device_live_buffers",
                  mem.get("live_buffers"), ts=now_ms)
        rows = kernelscope.get("kernel_registry") or []
        if rows:
            _head(out, "rca_kernel_winner_info", "gauge",
                  "1 for the engaged registry row per padded shape "
                  "(engine/registry.py, the dispatch seam)")
            for row in rows:
                _line(out, "rca_kernel_winner_info", 1, ts=now_ms,
                      n_pad=str(row["n_pad"]), variant=row["variant"],
                      kernel=row["winner"], source=row["source"])
            _head(out, "rca_kernel_cost_flops", "gauge",
                  "operations of the canonical call per shape, from the "
                  "cost model (absent until captured)")
            for row in rows:
                cost = row.get("cost") or {}
                _line(out, "rca_kernel_cost_flops", cost.get("flops"),
                      ts=now_ms, n_pad=str(row["n_pad"]),
                      variant=row["variant"])
            _head(out, "rca_kernel_cost_bytes_accessed", "gauge",
                  "bytes the canonical call moves per shape, from the "
                  "cost model (absent until captured)")
            for row in rows:
                cost = row.get("cost") or {}
                _line(out, "rca_kernel_cost_bytes_accessed",
                      cost.get("bytes_accessed"), ts=now_ms,
                      n_pad=str(row["n_pad"]), variant=row["variant"])
            _head(out, "rca_kernel_peak_temp_bytes", "gauge",
                  "CUDA allocator peak over one run of the winner per "
                  "shape, less what was allocated before it (absent until "
                  "captured on a card)")
            for row in rows:
                cost = row.get("cost") or {}
                _line(out, "rca_kernel_peak_temp_bytes",
                      cost.get("peak_temp_bytes"), ts=now_ms,
                      n_pad=str(row["n_pad"]), variant=row["variant"])

    _head(out, "rca_serve_requests_total", "counter",
          "serve outcomes per tenant")
    tenants = serve_summary.get("tenants", {})
    for tenant, rec in sorted(tenants.items()):
        for key in _TENANT_COUNTERS:
            _line(out, "rca_serve_requests_total", rec.get(key, 0),
                  tenant=tenant, outcome=key)

    _head(out, "rca_serve_queue_ms", "gauge",
          "per-tenant time-in-queue quantiles (ms)")
    for tenant, rec in sorted(tenants.items()):
        _line(out, "rca_serve_queue_ms", rec.get("queue_ms_p50"),
              ts=now_ms, tenant=tenant, quantile="0.5")
        _line(out, "rca_serve_queue_ms", rec.get("queue_ms_p99"),
              ts=now_ms, tenant=tenant, quantile="0.99")

    # per-tenant duration histogram and SLO burn: cumulative le buckets
    # so burn rate and latency SLIs are PromQL
    duration = serve_summary.get("duration") or {}
    if duration:
        _head(out, "rca_request_duration_seconds", "histogram",
              "submit-to-completion request duration per tenant")
        for tenant, hist in sorted(duration.items()):
            for le, n in hist.get("buckets", {}).items():
                _line(out, "rca_request_duration_seconds_bucket", n,
                      tenant=tenant, le=le)
            _line(out, "rca_request_duration_seconds_bucket",
                  hist.get("count", 0), tenant=tenant, le="+Inf")
            _line(out, "rca_request_duration_seconds_sum",
                  hist.get("sum_s", 0.0), tenant=tenant)
            _line(out, "rca_request_duration_seconds_count",
                  hist.get("count", 0), tenant=tenant)
    breaches = serve_summary.get("slo_breaches")
    if breaches is not None:
        _head(out, "rca_slo_breaches_total", "counter",
              "completions over RCA_SLO_MS (or failed) per tenant")
        for tenant, n in sorted(breaches.items()):
            _line(out, "rca_slo_breaches_total", n, tenant=tenant)
    if serve_summary.get("slo_ms") is not None:
        _head(out, "rca_slo_target_ms", "gauge",
              "the configured per-request latency SLO (RCA_SLO_MS)")
        _line(out, "rca_slo_target_ms", serve_summary["slo_ms"],
              ts=now_ms)

    _head(out, "rca_serve_resident_delta_requests_total", "counter",
          "requests served via the resident delta path, per tenant")
    for tenant, rec in sorted(tenants.items()):
        _line(out, "rca_serve_resident_delta_requests_total",
              rec.get("resident_delta_requests", 0), tenant=tenant)

    _head(out, "rca_explain_requests_total", "counter",
          "requests served with a causelens attribution "
          "(ServeRequest.explain / ?explain=1)")
    for tenant, rec in sorted(tenants.items()):
        _line(out, "rca_explain_requests_total",
              rec.get("explain_requests", 0), tenant=tenant)

    _head(out, "rca_serve_batches_total", "counter",
          "device batches dispatched")
    _line(out, "rca_serve_batches_total", serve_summary.get("batches", 0))
    _head(out, "rca_serve_dispatched_requests_total", "counter",
          "requests that rode a device batch")
    _line(out, "rca_serve_dispatched_requests_total",
          serve_summary.get("dispatched_requests", 0))
    _head(out, "rca_serve_queue_depth_peak", "gauge",
          "peak queue depth observed at admission")
    _line(out, "rca_serve_queue_depth_peak",
          serve_summary.get("queue_depth_peak", 0), ts=now_ms)

    _head(out, "rca_serve_graph_cache_events_total", "counter",
          "prepared-graph cache events")
    for event, n in sorted(
        (serve_summary.get("graph_cache") or {}).items()
    ):
        _line(out, "rca_serve_graph_cache_events_total", n, event=event)

    replicas = serve_summary.get("replicas") or {}
    if replicas:
        _head(out, "rca_serve_replica_batches_total", "counter",
              "device batches fetched OK per replica")
        for rid, rec in sorted(replicas.items()):
            _line(out, "rca_serve_replica_batches_total",
                  rec.get("batches", 0), replica=rid)
        _head(out, "rca_serve_replica_requests_total", "counter",
              "requests served per replica")
        for rid, rec in sorted(replicas.items()):
            _line(out, "rca_serve_replica_requests_total",
                  rec.get("requests", 0), replica=rid)
        _head(out, "rca_serve_replica_stolen_total", "counter",
              "work-steal moves per replica and direction")
        for rid, rec in sorted(replicas.items()):
            _line(out, "rca_serve_replica_stolen_total",
                  rec.get("stolen_from", 0), replica=rid,
                  direction="from")
            _line(out, "rca_serve_replica_stolen_total",
                  rec.get("stolen_to", 0), replica=rid, direction="to")
        _head(out, "rca_serve_replica_state", "gauge",
              "1 for the replica's current breaker/liveness state")
        for rid, rec in sorted(replicas.items()):
            _line(out, "rca_serve_replica_state", 1, ts=now_ms, replica=rid,
                  state=str(rec.get("state", "closed")))
        _head(out, "rca_serve_replica_occupancy", "gauge",
              "per-replica occupancy quantiles (staged + in flight)")
        for rid, rec in sorted(replicas.items()):
            _line(out, "rca_serve_replica_occupancy",
                  rec.get("occupancy_p50"), ts=now_ms, replica=rid,
                  quantile="0.5")
            _line(out, "rca_serve_replica_occupancy",
                  rec.get("occupancy_max"), ts=now_ms, replica=rid,
                  quantile="1.0")

    if gateway is not None:
        _head(out, "rca_gateway_requests_total", "counter",
              "gateway HTTP responses by route and code")
        for (route, code), n in sorted(gateway.get("requests", {}).items()):
            _line(out, "rca_gateway_requests_total", n, route=route,
                  code=str(code))
        _head(out, "rca_gateway_request_ms", "gauge",
              "gateway request latency quantiles (ms) by route")
        for route, rec in sorted(gateway.get("latency", {}).items()):
            _line(out, "rca_gateway_request_ms", rec.get("p50"),
                  ts=now_ms, route=route, quantile="0.5")
            _line(out, "rca_gateway_request_ms", rec.get("p99"),
                  ts=now_ms, route=route, quantile="0.99")
        _head(out, "rca_gateway_streams_opened_total", "counter",
              "tick subscriptions opened")
        _line(out, "rca_gateway_streams_opened_total",
              gateway.get("streams_opened", 0))
        _head(out, "rca_gateway_stream_events_total", "counter",
              "tick events delivered to subscribers")
        _line(out, "rca_gateway_stream_events_total",
              gateway.get("stream_events", 0))
        _head(out, "rca_gateway_body_rejections_total", "counter",
              "requests refused for exceeding RCA_GATEWAY_MAX_BODY")
        _line(out, "rca_gateway_body_rejections_total",
              gateway.get("body_rejections", 0))
        _head(out, "rca_gateway_rate_limited_total", "counter",
              "requests refused by the per-tenant token bucket "
              "(RCA_GATEWAY_TENANT_RPS)")
        _line(out, "rca_gateway_rate_limited_total",
              gateway.get("rate_limited", 0))

    if healthy is not None:
        _head(out, "rca_gateway_up", "gauge",
              "1 while the serving plane is routable")
        _line(out, "rca_gateway_up", 1 if healthy else 0, ts=now_ms)

    return "\n".join(out) + "\n"
