"""Request/response vocabulary for the serving scheduler (the port's copy
of ``rca_tpu.serve.request``).

A :class:`ServeRequest` is one tenant's analyze call — a feature matrix
over a dependency graph — carried through admission, the weighted-fair
queue, the shape-bucket batcher and one coalesced device dispatch.  The
submitting thread parks on :meth:`ServeRequest.result`; the serve worker
completes the request exactly once with a :class:`ServeResponse` whose
``status`` is the serving contract:

- ``ok``          served from a (possibly width-1) coalesced batch; the
                  ranking is bit-identical to a solo analysis;
- ``shed``        the deadline expired while the request was QUEUED — it
                  never consumed a device slot;
- ``queue_full``  rejected at admission (the queue is at capacity);
- ``degraded``    the device path failed (or the circuit breaker is open)
                  and the response carries the LAST KNOWN ranking for
                  this graph — stale by contract, never fabricated;
- ``error``       the device path failed and no last-known ranking exists
                  for this graph.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rca_tpu_torch.util.threads import make_lock

#: the serving contract's response states (documented above)
STATUSES = ("ok", "shed", "queue_full", "degraded", "error")

#: per-request top-k cap: the batch's candidate count depends only on the
#: shape bucket, so k is clamped here and every dispatch ranks
#: ``K_CAP + 8`` candidates
K_CAP = 16

#: priority classes: lower value = served first (strict priority across
#: tenants; weighted-fair order breaks ties within a class)
PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_BATCH = 0, 1, 2

GraphKey = Tuple[int, int, int, str]


def graph_key(
    features: np.ndarray, dep_src: np.ndarray, dep_dst: np.ndarray
) -> GraphKey:
    """Identity of the computation graph a request runs over:
    ``(n_services, n_channels, n_edges, edge-digest)``.  Requests sharing
    a key run the same padded plan over the same edge arrays, so they can
    coalesce into one batched dispatch with bit-identical per-lane results
    (names are render-only and deliberately excluded)."""
    digest = hashlib.sha1(
        dep_src.tobytes() + b"|" + dep_dst.tobytes()
    ).hexdigest()[:16]
    return (
        int(features.shape[0]), int(features.shape[1]),
        int(len(dep_src)), digest,
    )


@dataclasses.dataclass
class ServeResponse:
    status: str                  # one of STATUSES
    request_id: str
    tenant: str
    ranked: List[dict] = dataclasses.field(default_factory=list)
    detail: str = ""             # why (shed/queue_full/degraded/error)
    queue_ms: float = 0.0        # admission -> batch dispatch
    batch_size: int = 0          # occupancy of the batch this request rode
    deadline_missed: bool = False  # served, but past its deadline
    # scheduler clock when the scheduler completed the request (the
    # request's ``enqueued_at`` to this is its submit → completion time)
    completed_at: float = 0.0
    result: Optional[object] = None  # EngineResult for ok responses
    # causelens provenance: present only when the request set ``explain``
    # and was served ok (an ``{"error": ...}`` stub when the attribution
    # itself failed; an explain failure never fails the ranking)
    provenance: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class ServeRequest:
    """One queued analyze request.  Arrays are copied at construction —
    callers may reuse scratch buffers, and a queued request must not
    mutate under the scheduler."""

    tenant: str
    features: np.ndarray         # float32 [S, C]
    dep_src: np.ndarray          # int32 [E]
    dep_dst: np.ndarray          # int32 [E]
    names: Optional[Sequence[str]] = None
    k: int = 5
    priority: int = PRIORITY_NORMAL
    deadline_s: Optional[float] = None  # absolute, scheduler clock domain
    cost: float = 1.0            # weighted-fair-queue charge
    # serve this request WITH its causelens attribution: the sink computes
    # the provenance block after the fetch (one extra pass, charged to the
    # explaining request only)
    explain: bool = False
    # optional investigation-store target: an ``ok`` response appends a
    # serve note there, and an explained one lands its provenance block
    investigation_id: Optional[str] = None
    # tracing: ``trace_parent`` is the caller's span context; ``trace`` is
    # THIS request's root-span identity, minted at admission when tracing
    # is on — every span the scheduler records for this request parents
    # onto it, so a stolen request keeps its trace
    trace_parent: Optional[object] = None   # observability SpanContext
    trace: Optional[object] = None          # observability SpanContext
    request_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12]
    )
    # filled by the scheduler
    enqueued_at: float = 0.0
    staged_at: float = 0.0       # batcher offer time (batch-wait spans)
    vtag: float = 0.0            # WFQ virtual finish tag
    seq: int = 0                 # admission order (total tie-break)

    def __post_init__(self) -> None:
        self.features = np.array(self.features, np.float32)
        self.dep_src = np.asarray(self.dep_src, np.int32).copy()
        self.dep_dst = np.asarray(self.dep_dst, np.int32).copy()
        if self.features.ndim != 2:
            raise ValueError(
                f"features must be [S, C], got shape {self.features.shape}"
            )
        if len(self.dep_src) != len(self.dep_dst):
            raise ValueError("dep_src and dep_dst must have equal length")
        # clamp instead of reject: the candidate count is per shape bucket
        self.k = max(1, min(int(self.k), K_CAP))
        self.names = list(self.names) if self.names is not None else None
        self._graph_key: GraphKey = graph_key(
            self.features, self.dep_src, self.dep_dst
        )
        self._done = threading.Event()
        self._complete_lock = make_lock("ServeRequest._complete_lock")
        self.response: Optional[ServeResponse] = None

    @property
    def graph_key(self) -> GraphKey:
        return self._graph_key

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now >= self.deadline_s

    # -- completion plumbing -------------------------------------------------
    def complete(self, response: ServeResponse) -> bool:
        """Deliver the response (first writer wins; idempotent): the check
        and the write are one step under the request's lock, so two racing
        completions never both win."""
        with self._complete_lock:
            if self._done.is_set():
                return False
            self.response = response
            self._done.set()
            return True

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        """Block until the scheduler completes this request."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"serve request {self.request_id} ({self.tenant}) not "
                f"completed within {timeout}s"
            )
        if self.response is None:
            raise RuntimeError(f"serve request {self.request_id} completed "
                               "without a response")
        return self.response
