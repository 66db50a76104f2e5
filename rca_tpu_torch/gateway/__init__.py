"""The gateway and the canary: the wire front door over the serving plane
and the replay-driven regression canary (the port's copy of
``rca_tpu.gateway``).

- :mod:`.wire`    JSON ⇄ the serve contract, and the honest HTTP status
  map (queue_full→429, shed→503, degraded→200 with a flag);
- :mod:`.server`  :class:`GatewayServer`, stdlib HTTP in front of a
  started ``ServeLoop`` / ``ServePool`` (``serve --listen``): tenant
  tagging from a header, per-tenant rate limits, bearer tokens, TLS and
  mTLS, chunked subscriptions, ``/metrics``, breaker-fed ``/healthz``;
- :mod:`.export`  the Prometheus text exposition;
- :mod:`.client`  :class:`GatewayClient`, the wire twin of the in-process
  ``ServeClient``;
- :mod:`.canary`  ``canary``: sample live investigations into minted
  recordings, replay them against a candidate build or config, fail on
  ranking divergence with the exact bisected tick.
"""

from rca_tpu_torch.gateway.canary import build_candidate_engine, run_canary
from rca_tpu_torch.gateway.client import GatewayClient
from rca_tpu_torch.gateway.export import render_metrics_text
from rca_tpu_torch.gateway.server import (
    GatewayMetrics,
    GatewayServer,
    TenantRateLimiter,
    TickHub,
)
from rca_tpu_torch.gateway.wire import (
    DEFAULT_TENANT,
    TENANT_HEADER,
    WireError,
    decode_analyze,
    encode_analyze,
    response_body,
    status_code_for,
)

__all__ = [
    "DEFAULT_TENANT",
    "TENANT_HEADER",
    "GatewayClient",
    "GatewayMetrics",
    "GatewayServer",
    "TenantRateLimiter",
    "TickHub",
    "WireError",
    "build_candidate_engine",
    "decode_analyze",
    "encode_analyze",
    "render_metrics_text",
    "response_body",
    "run_canary",
    "status_code_for",
]
