"""Wire client: the stdlib-HTTP twin of the in-process ``ServeClient``
(the port's copy of ``rca_tpu.gateway.client``).

Used by the tests (loopback bit parity against in-process submission),
``chip_smoke.py``'s gateway phase (wire against in-process latency), the
canary's ``--listen-url`` sampling, ``fleet`` and any out-of-process
caller.  One :class:`GatewayClient` holds no connection state between
calls: each request opens, speaks and closes.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple
from urllib.parse import urlsplit

from rca_tpu_torch.gateway.wire import (
    RETRY_AFTER_MS_HEADER,
    TENANT_HEADER,
    encode_analyze,
)
from rca_tpu_torch.observability.spans import TRACE_HEADER


class GatewayClient:
    """``tls=True`` speaks HTTPS; ``ca_file`` pins/verifies the server
    cert (self-signed deployments pass their own cert), without it the
    connection is encrypted but UNverified — loopback test territory.
    ``cert_file``/``key_file`` present this client's certificate to an
    mTLS gateway (``RCA_GATEWAY_TLS_CLIENT_CA``); without them such a
    gateway rejects the handshake.  ``token`` rides every request as
    ``Authorization: Bearer`` for gateways with ``RCA_GATEWAY_TOKENS``
    set.  ``sleeper`` is the injectable delay seam the retry path uses
    (tests pass a recorder)."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 tls: bool = False, ca_file: Optional[str] = None,
                 cert_file: Optional[str] = None,
                 key_file: Optional[str] = None,
                 token: Optional[str] = None,
                 sleeper: Callable[[float], None] = time.sleep):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.tls = bool(tls)
        self.ca_file = ca_file
        self.cert_file = cert_file
        self.key_file = key_file
        self.token = token
        self.sleeper = sleeper

    @classmethod
    def from_url(cls, url: str, **kwargs: Any) -> "GatewayClient":
        """``http(s)://host:port`` → a client (the ``canary --listen-url``
        and ``fleet`` entry point)."""
        parts = urlsplit(url if "//" in url else f"//{url}")
        scheme = parts.scheme or "http"
        if scheme not in ("http", "https"):
            raise ValueError(f"gateway url {url!r}: scheme must be "
                             "http or https")
        if parts.hostname is None or parts.port is None:
            raise ValueError(f"gateway url {url!r}: want host:port")
        kwargs.setdefault("tls", scheme == "https")
        return cls(parts.hostname, parts.port, **kwargs)

    def _conn(self, timeout_s: Optional[float] = None
              ) -> http.client.HTTPConnection:
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        if self.tls:
            from rca_tpu_torch.util.net import make_tls_client_context

            return http.client.HTTPSConnection(
                self.host, self.port, timeout=timeout,
                context=make_tls_client_context(
                    "gateway-client", self.ca_file,
                    cert_file=self.cert_file, key_file=self.key_file,
                ),
            )
        return http.client.HTTPConnection(
            self.host, self.port, timeout=timeout,
        )

    def _auth(self, headers: Dict[str, str]) -> Dict[str, str]:
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    # -- analyze -------------------------------------------------------------
    @staticmethod
    def retry_delay_s(headers: Dict[str, str]) -> float:
        """The server's backoff hint: the jittered millisecond header
        when present (clients honouring the INTEGER Retry-After would all
        retry at the same instant), else Retry-After seconds, else 1 s."""
        ms = headers.get(RETRY_AFTER_MS_HEADER)
        if ms is not None:
            try:
                return max(0.0, float(ms) / 1000.0)
            except ValueError:
                pass
        try:
            return max(0.0, float(headers.get("Retry-After") or 1.0))
        except ValueError:
            return 1.0

    def analyze(
        self,
        features, dep_src, dep_dst,
        names=None, tenant: Optional[str] = None, k: int = 5,
        priority: str = "normal", deadline_ms: Optional[float] = None,
        investigation_id: Optional[str] = None,
        trace: Optional[str] = None,
        retries: int = 0,
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """One analyze request over the wire.  Returns ``(http_code,
        body, headers)`` — the caller maps 429/503 to its own backoff
        using the ``Retry-After`` header, exactly as an external load
        balancer would.  ``retries`` > 0 does that here: on 429/503 the
        client sleeps the server's JITTERED hint (see
        :meth:`retry_delay_s`) and resubmits, up to ``retries`` times —
        a shed storm's survivors come back spread out, not as one wave.
        ``trace`` (an ``X-RCA-Trace`` wire value, ``trace_id-span_id``)
        parents the gateway's spans onto the caller's; absent, the
        gateway starts a fresh trace and echoes its id in the response
        headers either way."""
        body = json.dumps(encode_analyze(
            features, dep_src, dep_dst, names=names, k=k,
            priority=priority, deadline_ms=deadline_ms,
            investigation_id=investigation_id,
        )).encode("utf-8")
        headers = self._auth({"Content-Type": "application/json"})
        if tenant is not None:
            headers[TENANT_HEADER] = tenant
        if trace is not None:
            headers[TRACE_HEADER] = trace
        attempts = max(0, int(retries)) + 1
        for attempt in range(attempts):
            conn = self._conn()
            try:
                conn.request("POST", "/v1/analyze", body=body,
                             headers=headers)
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode("utf-8"))
                out = resp.status, payload, dict(resp.getheaders())
            finally:
                conn.close()
            if out[0] not in (429, 503) or attempt + 1 >= attempts:
                return out
            self.sleeper(self.retry_delay_s(out[2]))
        return out  # pragma: no cover - loop always returns

    # -- streaming subscription ----------------------------------------------
    def subscribe(
        self,
        tenant: Optional[str] = None,
        max_events: int = 0,
        idle_s: float = 30.0,
        timeout_s: Optional[float] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield served-response events as they stream (chunked NDJSON).
        Ends after ``max_events`` (0 = server default/unbounded), after
        ``idle_s`` with no event, or when the gateway shuts down."""
        query = f"/v1/subscribe?idle_s={idle_s}"
        if tenant is not None:
            query += f"&tenant={tenant}"
        if max_events:
            query += f"&max={int(max_events)}"
        conn = self._conn(timeout_s)
        try:
            conn.request("GET", query, headers=self._auth({}))
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(
                    f"subscribe: HTTP {resp.status}: "
                    f"{resp.read(256)!r}"
                )
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line.decode("utf-8"))
        finally:
            conn.close()

    # -- observability endpoints ---------------------------------------------
    def metrics_text(self) -> str:
        conn = self._conn()
        try:
            conn.request("GET", "/metrics", headers=self._auth({}))
            resp = conn.getresponse()
            return resp.read().decode("utf-8")
        finally:
            conn.close()

    def traces(
        self,
        trace_id: Optional[str] = None,
        max_spans: int = 1000,
        fmt: str = "ndjson",
    ):
        """``GET /v1/traces``: the span buffer — a list of span dicts
        (NDJSON decoded), or the Chrome trace object with
        ``fmt="chrome"``."""
        query = f"/v1/traces?max={int(max_spans)}&format={fmt}"
        if trace_id is not None:
            query += f"&trace_id={trace_id}"
        conn = self._conn()
        try:
            conn.request("GET", query, headers=self._auth({}))
            resp = conn.getresponse()
            raw = resp.read().decode("utf-8")
            if resp.status != 200:
                raise RuntimeError(f"traces: HTTP {resp.status}: {raw!r}")
            if fmt == "chrome":
                return json.loads(raw)
            return [
                json.loads(line) for line in raw.splitlines() if line
            ]
        finally:
            conn.close()

    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        conn = self._conn()
        try:
            conn.request("GET", "/healthz", headers=self._auth({}))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode("utf-8"))
        finally:
            conn.close()
