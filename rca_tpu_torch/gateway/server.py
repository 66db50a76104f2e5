"""The wire front door: stdlib HTTP over the serving plane (the port's copy
of ``rca_tpu.gateway.server``).

:class:`GatewayServer` puts an HTTP/1.1 surface (the standard library
only) in front of a started :class:`rca_tpu_torch.serve.loop.ServeLoop`,
:class:`rca_tpu_torch.serve.pool.ServePool` or
:class:`rca_tpu_torch.serve.federation.FederationPlane`, mapped onto the
``ServeRequest`` / ``ServeResponse`` contract through
:mod:`rca_tpu_torch.gateway.wire`:

- ``POST /v1/analyze``   one analyze request; tenant tagging from the
  ``X-RCA-Tenant`` header; backpressure mapped honestly
  (queue_full→429+Retry-After, shed→503, degraded→200 with a
  ``degraded`` flag, error→500, the gateway's wait bound→504);
  ``?explain=1`` asks for the causelens provenance block;
- ``GET /v1/subscribe``  a chunked stream: one JSON line per response this
  gateway serves (optionally one tenant's);
- ``GET /v1/traces``     the tracer's span buffer (NDJSON or Chrome
  trace);
- ``GET /v1/explain/<id>`` a recently explained request's provenance;
- ``GET /metrics``       the Prometheus exposition of the serving plane's
  per-tenant / per-replica counters and the gateway's own;
- ``GET /healthz``       breaker-fed liveness: 200 while the plane is
  routable (any live replica whose breaker is not open; for a
  federation, any worker holding a live lease, with the worker table
  under ``fleet``), 503 otherwise.

With ``RCA_GATEWAY_TOKENS`` every route but ``/healthz`` needs a bearer
token, checked before the body is read; with a TLS pair the listener
speaks TLS, and with a client CA it demands client certificates.

Concurrency: every connection thread is spawned NAMED through
:func:`rca_tpu_torch.util.threads.spawn` (the server overrides
``socketserver``'s anonymous-thread spawn), the listening socket is built
through :mod:`rca_tpu_torch.util.net`, the gateway's state
(:class:`GatewayMetrics`, :class:`TickHub`) is lock-guarded, and the
gateway never touches the device: a request parks on ``req.result()``
like any in-process submitter, so the replica's fetch stays the serve
path's only sync.  Timing goes through the injectable ``clock`` and
``wall`` seams.
"""

from __future__ import annotations

import collections
import hmac
import itertools
import json
import queue
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from rca_tpu_torch.config import (
    gateway_max_body,
    gateway_port,
    gateway_tenant_rps,
    gateway_tls_client_ca,
    gateway_tls_files,
    gateway_tokens,
)
from rca_tpu_torch.gateway.export import render_metrics_text
from rca_tpu_torch.gateway.wire import (
    RETRY_AFTER_MS_HEADER,
    TENANT_HEADER,
    WireError,
    decode_analyze,
    response_body,
    status_code_for,
)
from rca_tpu_torch.observability.export import chrome_trace, ndjson_spans
from rca_tpu_torch.observability.spans import (
    TRACE_HEADER,
    SpanContext,
    default_tracer,
)
from rca_tpu_torch.obslog.profiling import PhaseStats
from rca_tpu_torch.serve.client import ServeClient
from rca_tpu_torch.util.net import bound_address, make_server_socket
from rca_tpu_torch.util.threads import make_lock, spawn

#: default gateway-side wait bound on one analyze request (504 past it);
#: generous — the scheduler's own deadline/shed machinery is the real
#: latency policy, this only bounds a wedged plane
DEFAULT_TIMEOUT_S = 60.0

#: idle poll while a subscriber waits for its next event (also the
#: shutdown-notice latency for parked streams)
_STREAM_POLL_S = 0.25


class GatewayMetrics:
    """The gateway's own HTTP counters (the serve plane's live in
    :class:`rca_tpu_torch.serve.metrics.ServeMetrics`).  ``snapshot()``
    returns one consistent copy for the exporter — same discipline as the
    serve metrics' summary."""

    def __init__(self) -> None:
        self._lock = make_lock("GatewayMetrics._lock")
        self._requests: Dict[Tuple[str, int], int] = {}
        self._latency = PhaseStats()   # one phase per route
        self._streams_opened = 0
        self._stream_events = 0
        self._body_rejections = 0
        self._rate_limited = 0
        self._auth_rejections = 0

    def response(self, route: str, code: int, ms: float) -> None:
        with self._lock:
            key = (route, int(code))
            self._requests[key] = self._requests.get(key, 0) + 1
            self._latency.record(route, float(ms))

    def stream_opened(self) -> None:
        with self._lock:
            self._streams_opened += 1

    def stream_event(self) -> None:
        with self._lock:
            self._stream_events += 1

    def body_rejected(self) -> None:
        with self._lock:
            self._body_rejections += 1

    def rate_limited(self) -> None:
        with self._lock:
            self._rate_limited += 1

    def auth_rejected(self) -> None:
        """One request refused at the authn door (401/403) — BEFORE the
        body was read or the serve queue was touched."""
        with self._lock:
            self._auth_rejections += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            requests = dict(self._requests)
            latency = self._latency.snapshot()
            streams_opened = self._streams_opened
            stream_events = self._stream_events
            body_rejections = self._body_rejections
            rate_limited = self._rate_limited
            auth_rejections = self._auth_rejections
        return {
            "requests": requests,
            "latency": {
                route: {
                    "p50": latency.quantile(route, 0.50),
                    "p99": latency.quantile(route, 0.99),
                }
                for route in latency.phases()
            },
            "streams_opened": streams_opened,
            "stream_events": stream_events,
            "body_rejections": body_rejections,
            "rate_limited": rate_limited,
            "auth_rejections": auth_rejections,
        }


class TenantRateLimiter:
    """Per-tenant token buckets at the wire (``RCA_GATEWAY_TENANT_RPS``).
    Without them the only admission control is the GLOBAL serve-queue cap,
    which one hot tenant can fill before the scheduler's weighted-fair
    queuing sees anyone else.  Each tenant gets an independent bucket
    refilled at ``rps`` with one second's burst; an empty bucket answers
    with the seconds until the next token (the 429's Retry-After), and the
    request never touches the queue.

    Time comes from the injectable ``clock`` (monotonic seconds).  The
    tenant map is bounded: past ``max_tenants`` the fullest bucket (an
    idle tenant's) is evicted."""

    MAX_TENANTS = 4096

    def __init__(self, rps: float, clock: Callable[[], float],
                 burst: Optional[float] = None,
                 max_tenants: int = MAX_TENANTS):
        self.rps = float(rps)
        self.burst = float(burst) if burst is not None else max(
            1.0, self.rps
        )
        self.clock = clock
        self.max_tenants = int(max_tenants)
        self._lock = make_lock("TenantRateLimiter._lock")
        # tenant -> [tokens, last_refill_ts]
        self._buckets: Dict[str, list] = {}
        self.rejected = 0

    def admit(self, tenant: str) -> float:
        """0.0 = admitted (one token consumed); positive = rejected, the
        value is the seconds until a token exists (Retry-After)."""
        now = self.clock()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                if len(self._buckets) >= self.max_tenants:
                    # evict the fullest (stalest) bucket; a returning
                    # evictee simply starts with a fresh full burst
                    victim = max(
                        self._buckets,
                        key=lambda t: self._buckets[t][0],
                    )
                    del self._buckets[victim]
                b = [self.burst, now]
                self._buckets[tenant] = b
            tokens, last = b
            tokens = min(self.burst, tokens + (now - last) * self.rps)
            if tokens >= 1.0:
                b[0] = tokens - 1.0
                b[1] = now
                return 0.0
            b[0] = tokens
            b[1] = now
            self.rejected += 1
            return (1.0 - tokens) / self.rps


class TickHub:
    """Pub/sub of served responses for streaming subscriptions.

    The analyze path publishes every terminal response it delivers; each
    subscriber owns a bounded queue.  A slow subscriber DROPS events
    (``queue.Full`` is swallowed) rather than ever back-pressuring the
    serving plane — the stream is observability, not the system of
    record."""

    #: events a parked subscriber may lag before drops start
    QUEUE_CAP = 1024

    def __init__(self) -> None:
        self._lock = make_lock("TickHub._lock")
        self._subs: Dict[int, Tuple[Optional[str], "queue.Queue"]] = {}
        self._counter = itertools.count()
        self.dropped = 0

    def subscribe(
        self, tenant: Optional[str] = None
    ) -> Tuple[int, "queue.Queue"]:
        q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_CAP)
        with self._lock:
            sid = next(self._counter)
            self._subs[sid] = (tenant, q)
        return sid, q

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def publish(self, event: Dict[str, Any]) -> None:
        with self._lock:
            subs = list(self._subs.values())
        for tenant, q in subs:
            if tenant is not None and tenant != event.get("tenant"):
                continue
            try:
                q.put_nowait(event)
            except queue.Full:
                with self._lock:
                    self.dropped += 1


class _GatewayHTTPServer(HTTPServer):
    """HTTPServer over a seam-built socket, spawning NAMED connection
    threads (socketserver's ThreadingMixIn spawns anonymous raw threads,
    which the thread-discipline rule exists to prevent)."""

    daemon_threads = True

    def __init__(self, sock, handler_cls, gateway: "GatewayServer"):
        addr = bound_address(sock)
        super().__init__(addr, handler_cls, bind_and_activate=False)
        # TCPServer pre-built an unbound socket; replace it with the
        # seam's listening one
        self.socket.close()
        self.socket = sock
        self.server_name, self.server_port = addr
        self.gateway = gateway
        self._conn_counter = itertools.count()

    def process_request(self, request, client_address) -> None:
        spawn(
            self._process_request_thread,
            name=f"rca-gateway-conn{next(self._conn_counter)}",
            daemon=True,
            args=(request, client_address),
        )

    def _process_request_thread(self, request, client_address) -> None:
        from rca_tpu_torch.resilience.policy import suppressed

        # a client hanging up mid-response (BrokenPipe, reset) is normal
        # wire weather, not a server fault; record it in the bounded
        # fault log, never crash the acceptor or spam stderr
        with suppressed("gateway.connection"):
            if self.gateway.tls_context is not None:
                # TLS handshake happens HERE, on the connection thread —
                # never on the acceptor (a slow or plaintext client must
                # not block accept).  A failed handshake (plaintext to a
                # TLS gateway, bad protocol, missing/untrusted client
                # cert under mTLS) raises, is recorded in the fault log,
                # and the connection dies having touched nothing:
                # rejected before the serve queue by construction.
                try:
                    request = self.gateway.tls_context.wrap_socket(
                        request, server_side=True
                    )
                except (OSError, ValueError):
                    # under mTLS a handshake failure IS an authn
                    # rejection (no/untrusted client cert) — count it
                    # with the other refused credentials, then let
                    # suppressed() log the fault
                    if self.gateway.tls_client_ca is not None:
                        self.gateway.metrics.auth_rejected()
                    raise
            self.finish_request(request, client_address)
        self.shutdown_request(request)

    def handle_error(self, request, client_address) -> None:  # pragma: no cover
        pass


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rca-gateway/1"

    # BaseHTTPRequestHandler logs every request to stderr by default;
    # the gateway's observability surface is /metrics, not chatter
    def log_message(self, fmt, *args) -> None:  # noqa: D401
        pass

    @property
    def gateway(self) -> "GatewayServer":
        return self.server.gateway

    # -- response plumbing ---------------------------------------------------
    def _send_json(
        self, code: int, body: Dict[str, Any],
        retry_after: Optional[int] = None,
        trace: Optional[str] = None,
        www_authenticate: bool = False,
    ) -> None:
        payload = json.dumps(body).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        if retry_after is not None:
            # seeded jitter: a constant Retry-After resynchronizes every
            # shed client onto the same retry instant, so the next shed
            # storm arrives as one wave.  The standard header stays
            # integer seconds; the ms header carries the jittered value
            # GatewayClient honours.
            seconds, ms = self.gateway.jittered_retry_after(retry_after)
            self.send_header("Retry-After", str(seconds))
            self.send_header(RETRY_AFTER_MS_HEADER, str(ms))
        if www_authenticate:
            self.send_header("WWW-Authenticate", "Bearer")
        if trace is not None:
            # the header contract: context in, context out — the caller
            # can stitch its own spans onto the gateway's
            self.send_header(TRACE_HEADER, trace)
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; charset=utf-8") -> None:
        payload = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _authorize(self) -> Tuple[Optional[int], Optional[str]]:
        """The authn door: with ``RCA_GATEWAY_TOKENS`` set,
        every route except ``/healthz`` needs ``Authorization: Bearer``.

        Returns ``(already_sent_code | None, bound_tenant | None)``.
        Runs BEFORE any body read — a rejected request costs the
        gateway headers only, and the connection is closed (the unread
        body would desynchronize keep-alive).  Token comparison is
        constant-time against EVERY configured token, no early exit.
        The matched token's tenant BINDS the request: an
        ``X-RCA-Tenant`` header naming anyone else is a spoof (403)."""
        gw = self.gateway
        if not gw.tokens:
            return None, None
        header = self.headers.get("Authorization") or ""
        token = header[7:] if header.startswith("Bearer ") else ""
        bound: Optional[Tuple[str, Optional[float]]] = None
        matched = False
        for tok, binding in gw.tokens.items():
            if hmac.compare_digest(
                token.encode("utf-8"), tok.encode("utf-8")
            ):
                matched = True
                bound = binding
        if not matched:
            gw.metrics.auth_rejected()
            self.close_connection = True
            self._send_json(401, {
                "status": "error",
                "detail": "missing or invalid bearer token "
                          "(RCA_GATEWAY_TOKENS)",
            }, www_authenticate=True)
            return 401, None
        tenant, expires = bound  # type: ignore[misc]
        if expires is not None and gw.wall() >= expires:
            gw.metrics.auth_rejected()
            self.close_connection = True
            self._send_json(401, {
                "status": "error", "detail": "token expired",
            }, www_authenticate=True)
            return 401, None
        hdr = self.headers.get(TENANT_HEADER)
        if hdr and hdr != tenant:
            gw.metrics.auth_rejected()
            self.close_connection = True
            self._send_json(403, {
                "status": "error",
                "detail": f"token is bound to tenant {tenant!r}; "
                          f"X-RCA-Tenant {hdr!r} is not yours to claim",
            })
            return 403, None
        return None, tenant

    def _route(self, handler: Callable[[], int], route: str) -> None:
        gw = self.gateway
        t0 = gw.clock()
        try:
            code = handler()
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-write; nothing left to answer
            self.close_connection = True
            return
        except Exception as exc:  # noqa: BLE001 - the wire must answer
            code = 500
            try:
                self._send_json(500, {
                    "status": "error",
                    "detail": f"gateway:{type(exc).__name__}",
                })
            except OSError:
                self.close_connection = True
        gw.metrics.response(route, code, (gw.clock() - t0) * 1e3)

    # -- routes --------------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        parts = urlsplit(self.path)
        path = parts.path
        if path == "/v1/analyze":
            self._route(
                lambda: self._post_analyze(parse_qs(parts.query)),
                "analyze",
            )
        else:
            self._route(
                lambda: (self._send_json(
                    404, {"status": "error", "detail": f"no route {path}"}
                ) or 404),
                "unknown",
            )

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        parts = urlsplit(self.path)
        if parts.path == "/healthz":
            self._route(self._get_healthz, "healthz")
        elif parts.path == "/metrics":
            self._route(self._get_metrics, "metrics")
        elif parts.path == "/v1/traces":
            self._route(
                lambda: self._get_traces(parse_qs(parts.query)),
                "traces",
            )
        elif parts.path.startswith("/v1/explain/"):
            self._route(
                lambda: self._get_explain(
                    parts.path[len("/v1/explain/"):]
                ),
                "explain",
            )
        elif parts.path == "/v1/subscribe":
            self._route(
                lambda: self._get_subscribe(parse_qs(parts.query)),
                "subscribe",
            )
        else:
            self._route(
                lambda: (self._send_json(
                    404,
                    {"status": "error", "detail": f"no route {parts.path}"},
                ) or 404),
                "unknown",
            )

    def _post_analyze(self, query: Optional[Dict[str, list]] = None) -> int:
        gw = self.gateway
        # authn FIRST: a 401/403 costs headers only — the body stays
        # unread, the serve queue untouched
        auth_code, bound_tenant = self._authorize()
        if auth_code is not None:
            return auth_code
        t0 = gw.clock()
        # trace context enters here: parse the caller's
        # X-RCA-Trace (malformed = absent), mint THIS request's gateway
        # span as its child (or a fresh trace), echo the context back —
        # even when the body is later rejected, the caller can correlate
        wire_ctx = SpanContext.from_wire(self.headers.get(TRACE_HEADER))
        gctx = gw.tracer.new_context(parent=wire_ctx)
        echo = (gctx or wire_ctx).to_wire() if (gctx or wire_ctx) else None

        def _finish(code: int, body: Dict[str, Any],
                    retry_after: Optional[int] = None,
                    status: str = "error") -> int:
            if gctx is not None:
                gw.tracer.record(
                    "gateway.analyze", t0, gw.clock(),
                    parent=wire_ctx, context=gctx,
                    attrs={"code": code, "status": status,
                           "tenant": body.get("tenant", "")},
                )
                body.setdefault("trace_id", gctx.trace_id)
            self._send_json(code, body, retry_after=retry_after,
                            trace=echo)
            return code

        length = int(self.headers.get("Content-Length") or 0)
        if length > gw.max_body:
            # refuse BEFORE reading the flood: backpressure that only
            # engages after parsing the payload is not backpressure
            gw.metrics.body_rejected()
            self.close_connection = True
            return _finish(413, {
                "status": "error",
                "detail": f"body {length} B over the "
                f"{gw.max_body} B cap (RCA_GATEWAY_MAX_BODY)",
            })
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw.decode("utf-8"))
            kwargs = decode_analyze(
                # the token's tenant binds the request when authn is on
                # (the spoof case already 403'd in _authorize); auth-less
                # gateways keep the header tagging
                body, header_tenant=(
                    bound_tenant or self.headers.get(TENANT_HEADER)
                ),
            )
        except (WireError, UnicodeDecodeError,
                json.JSONDecodeError) as exc:
            return _finish(400, {"status": "error", "detail": str(exc)})
        if query and (query.get("explain") or [""])[0] in ("1", "true",
                                                           "on"):
            # ?explain=1: the query-parameter twin of the body's
            # "explain": true — curl ergonomics for the common case
            kwargs["explain"] = True
        if gw.limiter is not None:
            wait = gw.limiter.admit(kwargs.get("tenant", ""))
            if wait > 0.0:
                # refused at the door: the request never touches the
                # serve queue, so one hot tenant cannot fill the global
                # cap ahead of everyone else's fair share
                gw.metrics.rate_limited()
                return _finish(429, {
                    "status": "rate_limited",
                    "tenant": kwargs.get("tenant", ""),
                    "detail": (
                        "per-tenant rate limit "
                        f"({gw.limiter.rps:g} req/s, "
                        "RCA_GATEWAY_TENANT_RPS) exceeded"
                    ),
                }, retry_after=max(1, int(wait + 0.999)),
                    status="rate_limited")
        req = gw.client.submit(trace_parent=gctx, **kwargs)
        try:
            resp = req.result(gw.timeout_s)
        except TimeoutError:
            return _finish(504, {
                "status": "error", "request_id": req.request_id,
                "tenant": req.tenant,
                "detail": f"not completed within {gw.timeout_s}s",
            }, status="timeout")
        out = response_body(resp)
        if req.trace is not None:
            out["trace_id"] = req.trace.trace_id
        if resp.provenance is not None:
            # retained for GET /v1/explain/<trace_id> (falls back to the
            # request id when tracing is off — the body names both)
            gw.remember_explain(
                out.get("trace_id"), resp.request_id, {
                    "request_id": resp.request_id,
                    "tenant": resp.tenant,
                    "trace_id": out.get("trace_id"),
                    "provenance": resp.provenance,
                },
            )
        gw.hub.publish(out)
        code, retry_after = status_code_for(resp.status)
        return _finish(code, out, retry_after=retry_after,
                       status=resp.status)

    def _get_healthz(self) -> int:
        health = self.gateway.health()
        code = 200 if health["ok"] else 503
        self._send_json(code, health)
        return code

    def _get_metrics(self) -> int:
        auth_code, _ = self._authorize()
        if auth_code is not None:
            return auth_code
        gw = self.gateway
        scope_fn = getattr(gw.loop, "kernelscope_summary", None)
        text = render_metrics_text(
            gw.loop.metrics.summary(),
            gateway=gw.metrics.snapshot(),
            # kernelscope rows: recompiles, device memory, the kernel
            # registry's rows — planes without the surface (stub loops in
            # tests) omit the families
            kernelscope=scope_fn() if callable(scope_fn) else None,
            healthy=gw.health()["ok"],
            # gauges carry a millisecond timestamp so a scraper knows
            # WHEN the point was true; the wall read goes through the seam
            now_ms=int(gw.wall() * 1e3),
        )
        self._send_text(200, text,
                        content_type="text/plain; version=0.0.4")
        return 200

    def _get_traces(self, query: Dict[str, list]) -> int:
        """``GET /v1/traces``: the tracer's span buffer on
        the wire.  ``trace_id`` filters to one trace; ``max`` keeps the
        newest N (default 1000); ``format=chrome`` returns one
        Perfetto-loadable Chrome trace JSON object instead of NDJSON.
        With ``RCA_TRACE=0`` the buffer is empty — 200 with zero lines,
        plus an X-RCA-Trace-Enabled header saying why."""
        auth_code, _ = self._authorize()
        if auth_code is not None:
            return auth_code
        gw = self.gateway
        trace_id = (query.get("trace_id") or [None])[0]
        fmt = (query.get("format") or ["ndjson"])[0]
        try:
            limit = int((query.get("max") or ["1000"])[0])
        except ValueError:
            self._send_json(400, {
                "status": "error", "detail": "max must be an integer",
            })
            return 400
        spans = gw.tracer.spans(trace_id=trace_id, limit=limit)
        if fmt == "chrome":
            payload = json.dumps(chrome_trace(spans)).encode("utf-8")
            content_type = "application/json"
        else:
            payload = ndjson_spans(spans).encode("utf-8")
            content_type = "application/x-ndjson"
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("X-RCA-Trace-Enabled",
                         "1" if gw.tracer.enabled else "0")
        self.end_headers()
        self.wfile.write(payload)
        return 200

    def _get_explain(self, key: str) -> int:
        """``GET /v1/explain/<trace_id>``: the retained
        causelens provenance for a recently explained analyze request —
        keyed by trace id (or request id when tracing was off).  The
        cache is bounded (oldest drop), so a 404 means expired OR never
        explained; the analyze response body carried the block either
        way."""
        auth_code, bound_tenant = self._authorize()
        if auth_code is not None:
            return auth_code
        record = self.gateway.lookup_explain(key)
        if (record is not None and bound_tenant is not None
                and record.get("tenant") != bound_tenant):
            # a token sees only its OWN tenant's provenance
            record = None
        if record is None:
            self._send_json(404, {
                "status": "error",
                "detail": f"no retained explanation for {key!r} "
                "(expired, or the request was not sent with explain)",
            })
            return 404
        self._send_json(200, record)
        return 200

    def _get_subscribe(self, query: Dict[str, list]) -> int:
        """Chunked stream: one JSON line per served response.  ``tenant``
        filters; ``max`` (default 0 = unbounded) ends the stream after N
        events; ``idle_s`` (default 30) ends it after that long with no
        event.  The stream also ends when the gateway shuts down."""
        auth_code, bound_tenant = self._authorize()
        if auth_code is not None:
            return auth_code
        gw = self.gateway
        tenant = (query.get("tenant") or [None])[0]
        if bound_tenant is not None:
            # an authenticated subscriber sees its OWN tenant's events
            # only — the token binds the filter, not the query string
            tenant = bound_tenant
        try:
            max_events = int((query.get("max") or ["0"])[0])
            idle_s = float((query.get("idle_s") or ["30"])[0])
        except ValueError:
            self._send_json(400, {
                "status": "error",
                "detail": "max/idle_s must be numeric",
            })
            return 400
        sid, q = gw.hub.subscribe(tenant)
        gw.metrics.stream_opened()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        sent = 0
        idle = 0.0
        try:
            while not gw.closing.is_set():
                try:
                    event = q.get(timeout=_STREAM_POLL_S)
                except queue.Empty:
                    idle += _STREAM_POLL_S
                    if idle >= idle_s:
                        break
                    continue
                idle = 0.0
                self._write_chunk(
                    json.dumps(event).encode("utf-8") + b"\n"
                )
                gw.metrics.stream_event()
                sent += 1
                if max_events and sent >= max_events:
                    break
            self._write_chunk(b"")   # terminal zero-length chunk
        finally:
            gw.hub.unsubscribe(sid)
            self.close_connection = True
        return 200

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        if data:
            self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()


class GatewayServer:
    """The front door over one started serving plane.

    ``loop`` is a started :class:`ServeLoop` or :class:`ServePool` (the
    gateway does not own its lifecycle: N gateways can front one plane).
    ``port`` 0 binds an ephemeral port; read ``self.port``."""

    def __init__(
        self,
        loop,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        max_body: Optional[int] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        clock: Callable[[], float] = time.monotonic,
        tenant_rps: Optional[float] = None,
        tracer=None,
        wall: Callable[[], float] = time.time,
        tls: Optional[Tuple[str, str]] = None,
        tls_client_ca: Optional[str] = None,
        tokens: Optional[Dict[str, Tuple[str, Optional[float]]]] = None,
        retry_jitter_s: float = 2.0,
        retry_jitter_seed: Optional[int] = None,
    ):
        self.loop = loop
        self.client = ServeClient(loop)
        self.clock = clock
        # the TLS and authn front door.  ``tls`` is a (cert, key)
        # PEM pair — default from RCA_GATEWAY_TLS_CERT/KEY; the context
        # is built once through the util/net seam and each connection
        # handshakes on its own thread.  ``tokens`` maps bearer token →
        # (tenant, expires) — default from RCA_GATEWAY_TOKENS; empty =
        # authn off (the auth-less behaviour, loopback territory).
        tls_pair = tls if tls is not None else gateway_tls_files()
        # mTLS: a client-CA file upgrades the listener to
        # REQUIRE and verify client certificates at handshake —
        # rejection happens before a byte of HTTP, counted in
        # auth_rejections like every other refused credential
        client_ca = (
            tls_client_ca if tls_client_ca is not None
            else (gateway_tls_client_ca() if tls is None else None)
        )
        if client_ca and tls_pair is None:
            raise ValueError(
                "gateway: tls_client_ca requires a TLS cert/key pair "
                "(mTLS without server TLS is not a thing)"
            )
        self.tls_client_ca = client_ca or None
        if tls_pair is not None:
            from rca_tpu_torch.util.net import make_tls_server_context

            self.tls_context = make_tls_server_context(
                "gateway", tls_pair[0], tls_pair[1],
                client_ca=self.tls_client_ca,
            )
        else:
            self.tls_context = None
        self.tokens = dict(tokens) if tokens is not None else (
            gateway_tokens()
        )
        # seeded Retry-After jitter: deterministic
        # per gateway, different ACROSS gateways (the default seed is
        # the bound port), so a shed storm's retries de-synchronize
        # instead of arriving back as one wave
        self._retry_jitter_s = float(retry_jitter_s)
        self._retry_lock = make_lock("GatewayServer._retry_lock")
        self._retry_seed = retry_jitter_seed
        # wall-clock seam for /metrics gauge timestamps (the exposition
        # format wants ms since the epoch) and token expiry: no handler
        # reads the wall clock directly
        self.wall = wall
        # the serving plane's tracer and the gateway's must be ONE
        # tracer for a wire request to read as one connected trace;
        # default both to the process tracer, prefer the plane's own
        self.tracer = (
            tracer if tracer is not None
            else getattr(loop, "tracer", None) or default_tracer()
        )
        self.max_body = int(max_body) if max_body is not None \
            else gateway_max_body()
        self.timeout_s = float(timeout_s)
        rps = gateway_tenant_rps() if tenant_rps is None else float(
            tenant_rps
        )
        # per-tenant token buckets (RCA_GATEWAY_TENANT_RPS; 0 = off)
        self.limiter = (
            TenantRateLimiter(rps, clock) if rps > 0.0 else None
        )
        self.metrics = GatewayMetrics()
        self.hub = TickHub()
        # causelens: recently served provenance blocks, keyed
        # by trace_id AND request_id, bounded LRU — GET /v1/explain/<id>
        # reads them back after the analyze response was consumed
        self._explains_lock = make_lock("GatewayServer._explains_lock")
        self._explains: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self.closing = threading.Event()
        sock = make_server_socket(
            "gateway", host, port if port is not None else gateway_port()
        )
        self.host, self.port = bound_address(sock)
        self._retry_rng = random.Random(
            self._retry_seed if self._retry_seed is not None else self.port
        )
        self._httpd = _GatewayHTTPServer(sock, _Handler, self)
        self._thread = None

    def jittered_retry_after(self, base_s: int) -> Tuple[int, int]:
        """``(retry_after_seconds, retry_after_ms)`` for one 429/503:
        base + a seeded uniform draw in [0, retry_jitter_s).  The ms
        value is the honest hint; the seconds value is its ceiling so
        standard clients never retry EARLIER than our own."""
        with self._retry_lock:
            jitter = self._retry_rng.uniform(0.0, self._retry_jitter_s)
        total = float(base_s) + jitter
        return max(1, int(total + 0.999)), max(1, int(total * 1000.0))

    #: explained responses retained for GET /v1/explain/<id> (per key)
    EXPLAIN_CACHE_CAP = 256

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- causelens retention -------------------------------------------------
    def remember_explain(self, trace_id: Optional[str], request_id: str,
                         record: Dict[str, Any]) -> None:
        with self._explains_lock:
            for key in (trace_id, request_id):
                if key:
                    self._explains[str(key)] = record
                    self._explains.move_to_end(str(key))
            while len(self._explains) > self.EXPLAIN_CACHE_CAP:
                self._explains.popitem(last=False)

    def lookup_explain(self, key: str) -> Optional[Dict[str, Any]]:
        with self._explains_lock:
            return self._explains.get(str(key))

    # -- health (breaker-fed) -------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Liveness from breaker state: a federation is healthy while ANY
        worker process holds a live lease (its ``health()``: the worker
        table under ``fleet``, the ingest ring's clusters under
        ``ingest``); a pool while ANY replica is routable (alive, breaker
        not open); a single loop while its breaker is not open and it has
        not been stopped (a stopped loop serves nothing more, so it
        reports ``"stopped": true`` and 503)."""
        loop = self.loop
        if hasattr(loop, "workers") and hasattr(loop, "health"):
            # a federation plane: lease-fed liveness
            return loop.health()
        if hasattr(loop, "replicas"):
            states = {
                str(r.replica_id): (
                    r.breaker.state if r.alive() else "dead"
                )
                for r in loop.replicas
            }
            ok = any(r.routable() for r in loop.replicas)
            return {
                "ok": bool(ok), "replicas": states,
                "queue_depth": len(loop.queue),
                "occupancy": round(loop.occupancy(), 4),
            }
        state = loop.breaker.state
        out = {
            "ok": state != "open", "breaker": state,
            "queue_depth": len(loop.queue),
        }
        if getattr(loop, "stopped", False):
            out.update(ok=False, stopped=True)
        return out

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "GatewayServer":
        if self._thread is None or not self._thread.is_alive():
            self.closing.clear()
            self._thread = spawn(
                self._httpd.serve_forever, name="rca-gateway-accept",
                daemon=True,
            )
        return self

    def close(self) -> None:
        self.closing.set()           # parked subscribers end their streams
        if self._thread is not None:
            # shutdown() parks on serve_forever's exit event — only
            # meaningful while the acceptor is actually running
            self._httpd.shutdown()
            self._thread.join(10.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
