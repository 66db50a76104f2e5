"""Wire vocabulary: JSON ⇄ the serve contract, and the HTTP status map
(the port's copy of ``rca_tpu.gateway.wire``).

One module owns both directions of the translation so the server and the
client cannot drift: a request body decodes into exactly the kwargs
:meth:`rca_tpu_torch.serve.client.ServeClient.submit` takes, and a
:class:`rca_tpu_torch.serve.request.ServeResponse` encodes into the body
the client hands back.

**Bit parity across the wire.**  Feature matrices travel as nested JSON
lists.  Every float32 converts EXACTLY to a Python float (float64), JSON
writes float64 round-trippably (``repr``'s shortest form), and the server
narrows back to float32 — so ``float32 → JSON → float32`` is the identity
and a request sent over loopback ranks to the same bits as the same arrays
submitted in process.  The scores of a response are Python floats of the
float32 values, so they come back exactly too.

**Honest backpressure**: the serve contract's outcomes surface as HTTP
codes the edge can act on —

=============  ====  =============================================
serve status   HTTP  semantics on the wire
=============  ====  =============================================
``ok``          200  ranking served (``degraded: false``)
``degraded``    200  LAST-KNOWN ranking, ``degraded: true`` — the
                     caller decides what staleness means
``queue_full``  429  admission rejected; ``Retry-After`` carries the
                     suggested backoff
``shed``        503  deadline expired before a device slot;
                     ``Retry-After`` set
``error``       500  device path failed with no last-known ranking
(timeout)       504  the gateway's own wait bound expired
=============  ====  =============================================
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from rca_tpu_torch.serve.request import (
    PRIORITY_BATCH,
    PRIORITY_HIGH,
    PRIORITY_NORMAL,
    ServeResponse,
)

#: tenant tagging header.  Auth-less by default; with
#: ``RCA_GATEWAY_TOKENS`` set the bearer token BINDS the tenant and a
#: mismatching header is a spoof attempt (403)
TENANT_HEADER = "X-RCA-Tenant"
DEFAULT_TENANT = "default"

#: Retry-After seconds suggested on 429/503 — queue pressure on this
#: scheduler drains in well under a second; 1s is the floor HTTP allows
RETRY_AFTER_S = 1

#: millisecond-precision jittered retry hint: the integer Retry-After
#: header resynchronizes every shed client onto the same retry instant;
#: this companion header carries the seeded-jitter delay GatewayClient
#: honours, while the standard header stays spec-shaped for everyone else
RETRY_AFTER_MS_HEADER = "X-RCA-Retry-After-Ms"

_PRIORITIES = {
    "high": PRIORITY_HIGH, "normal": PRIORITY_NORMAL,
    "batch": PRIORITY_BATCH,
}


class WireError(ValueError):
    """A malformed request body — the server answers 400 with the text."""


def _require(body: Dict[str, Any], key: str) -> Any:
    if key not in body:
        raise WireError(f"missing required field {key!r}")
    return body[key]


def _array(body: Dict[str, Any], key: str, dtype, ndim: int) -> np.ndarray:
    try:
        arr = np.asarray(_require(body, key), dtype=dtype)
    except (TypeError, ValueError) as exc:
        raise WireError(f"field {key!r}: not a numeric array ({exc})")
    if arr.ndim != ndim:
        raise WireError(
            f"field {key!r}: expected {ndim}-d array, got shape "
            f"{list(arr.shape)}"
        )
    return arr


def decode_analyze(body: Dict[str, Any],
                   header_tenant: Optional[str] = None) -> Dict[str, Any]:
    """A ``POST /v1/analyze`` JSON body → ``ServeClient.submit`` kwargs.

    The tenant header wins over any body field (the header is the wire's
    tagging surface; a body tenant is accepted for curl convenience).
    Raises :class:`WireError` on anything malformed — the server maps
    that to 400 without touching the scheduler."""
    if not isinstance(body, dict):
        raise WireError("request body must be a JSON object")
    features = _array(body, "features", np.float32, 2)
    dep_src = _array(body, "dep_src", np.int32, 1)
    dep_dst = _array(body, "dep_dst", np.int32, 1)
    if len(dep_src) != len(dep_dst):
        raise WireError("dep_src and dep_dst must have equal length")
    names = body.get("names")
    if names is not None:
        if not isinstance(names, list) or not all(
            isinstance(n, str) for n in names
        ):
            raise WireError("field 'names': expected a list of strings")
    priority = body.get("priority", "normal")
    if priority not in _PRIORITIES:
        raise WireError(
            f"field 'priority': expected one of {sorted(_PRIORITIES)}, "
            f"got {priority!r}"
        )
    deadline_ms = body.get("deadline_ms")
    if deadline_ms is not None and not isinstance(
        deadline_ms, (int, float)
    ):
        raise WireError("field 'deadline_ms': expected a number")
    k = body.get("k", 5)
    if not isinstance(k, int) or k < 1:
        raise WireError("field 'k': expected a positive integer")
    tenant = header_tenant or body.get("tenant") or DEFAULT_TENANT
    if not isinstance(tenant, str) or not tenant:
        raise WireError("tenant must be a non-empty string")
    inv = body.get("investigation_id")
    if inv is not None and not isinstance(inv, str):
        raise WireError("field 'investigation_id': expected a string")
    explain = body.get("explain", False)
    if not isinstance(explain, bool):
        raise WireError("field 'explain': expected a boolean")
    return {
        "features": features, "dep_src": dep_src, "dep_dst": dep_dst,
        "names": names, "tenant": tenant, "k": k,
        "priority": _PRIORITIES[priority],
        "deadline_ms": float(deadline_ms) if deadline_ms is not None
        else None,
        "investigation_id": inv,
        "explain": explain,
    }


def encode_analyze(
    features, dep_src, dep_dst,
    names=None, tenant: Optional[str] = None, k: int = 5,
    priority: str = "normal", deadline_ms: Optional[float] = None,
    investigation_id: Optional[str] = None,
    explain: bool = False,
) -> Dict[str, Any]:
    """Client-side twin of :func:`decode_analyze`: arrays → the JSON
    body.  ``tolist()`` converts float32 → exact float64, which JSON
    round-trips — see the module docstring's parity argument."""
    body: Dict[str, Any] = {
        "features": np.asarray(features, np.float32).tolist(),
        "dep_src": np.asarray(dep_src, np.int32).tolist(),
        "dep_dst": np.asarray(dep_dst, np.int32).tolist(),
        "k": int(k),
        "priority": priority,
    }
    if names is not None:
        body["names"] = list(names)
    if tenant is not None:
        body["tenant"] = tenant
    if deadline_ms is not None:
        body["deadline_ms"] = float(deadline_ms)
    if investigation_id is not None:
        body["investigation_id"] = investigation_id
    if explain:
        body["explain"] = True
    return body


def response_body(resp: ServeResponse) -> Dict[str, Any]:
    """A :class:`ServeResponse` → the JSON body both the analyze reply
    and the subscription stream carry."""
    out = {
        "status": resp.status,
        "request_id": resp.request_id,
        "tenant": resp.tenant,
        "ranked": resp.ranked,
        "degraded": resp.status == "degraded",
        "detail": resp.detail,
        "queue_ms": resp.queue_ms,
        "batch_size": resp.batch_size,
        "deadline_missed": bool(resp.deadline_missed),
        "engine": getattr(resp.result, "engine", None),
    }
    if getattr(resp, "provenance", None) is not None:
        # causelens: the attribution rides the body only for requests
        # that asked (?explain=1 / "explain": true)
        out["provenance"] = resp.provenance
    return out


def status_code_for(status: str) -> Tuple[int, Optional[int]]:
    """serve status → ``(http_code, retry_after_s | None)`` — the honest
    backpressure map in the module docstring."""
    if status in ("ok", "degraded"):
        return 200, None
    if status == "queue_full":
        return 429, RETRY_AFTER_S
    if status == "shed":
        return 503, RETRY_AFTER_S
    if status == "error":
        return 500, None
    return 500, None
