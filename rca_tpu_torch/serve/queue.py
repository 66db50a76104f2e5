"""Bounded multi-tenant request queue: weighted-fair + priority + deadlines
(the port's copy of ``rca_tpu.serve.queue``).

Scheduling model:

- **admission**: the queue is hard-capped (``RCA_SERVE_QUEUE_CAP``); a
  submit against a full queue is rejected immediately (``queue_full``)
  instead of growing an unbounded backlog — the caller gets backpressure
  it can act on, and queue time stays bounded for everyone already in;
- **weighted fair queuing**: each tenant holds a FIFO lane; every request
  is stamped a virtual finish tag ``max(vclock, tenant_vtime) + cost/weight``
  at admission (start-time fair queuing).  Pops take the head-of-line
  request with the smallest tag, so a tenant flooding the queue cannot
  starve the others — its requests just stack up LATER virtual time while
  light tenants' heads stay early;
- **priority classes**: strict across tenants (``PRIORITY_HIGH`` pops
  before any normal request); the fair tags order requests WITHIN a
  class.  Lanes stay FIFO per tenant — a tenant's own requests never
  reorder;
- **deadline shedding**: :meth:`shed_expired` removes requests whose
  deadline passed while queued, so an expired request never reaches the
  batcher, let alone a device slot.

All methods are thread-safe; the scheduler's clock is injectable so the
policy tests drive it with fake time.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional

from rca_tpu_torch.serve.request import ServeRequest
from rca_tpu_torch.util.threads import make_condition


class RequestQueue:
    def __init__(
        self,
        cap: int = 256,
        clock: Callable[[], float] = time.monotonic,
    ):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.clock = clock
        self._cond = make_condition("RequestQueue._cond")
        self._lanes: Dict[str, Deque[ServeRequest]] = {}
        self._vtime: Dict[str, float] = {}    # per-tenant last finish tag
        self._weights: Dict[str, float] = {}
        self._vclock = 0.0                    # virtual time of last pop
        self._size = 0
        self._seq = 0                         # admission counter (tie-break)

    # -- tenant weights ------------------------------------------------------
    def set_weight(self, tenant: str, weight: float) -> None:
        """A tenant's fair share (default 1.0): weight 2 drains twice as
        fast as weight 1 under contention."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._cond:
            self._weights[tenant] = float(weight)

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._cond:
            return self._size

    def depth_by_tenant(self) -> Dict[str, int]:
        """Queued requests per tenant (tenants with an empty lane left
        out)."""
        with self._cond:
            return {t: len(dq) for t, dq in self._lanes.items() if dq}

    # -- admission -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> bool:
        """Admit a request; False when the queue is at capacity (the
        caller responds ``queue_full`` — the request is NOT queued)."""
        with self._cond:
            if self._size >= self.cap:
                return False
            now = self.clock()
            req.enqueued_at = now
            self._seq += 1
            req.seq = self._seq
            start = max(self._vclock, self._vtime.get(req.tenant, 0.0))
            req.vtag = start + max(req.cost, 1e-9) / self.weight(req.tenant)
            self._vtime[req.tenant] = req.vtag
            self._lanes.setdefault(
                req.tenant, collections.deque()
            ).append(req)
            self._size += 1
            self._cond.notify_all()
            return True

    # -- service order -------------------------------------------------------
    def pop(self) -> Optional[ServeRequest]:
        """The next request in service order: strict priority class first,
        then smallest virtual finish tag, then admission order."""
        with self._cond:
            best_tenant = None
            best_key = None
            for tenant, lane in self._lanes.items():
                if not lane:
                    continue
                head = lane[0]
                key = (head.priority, head.vtag, head.seq)
                if best_key is None or key < best_key:
                    best_key = key
                    best_tenant = tenant
            if best_tenant is None:
                return None
            req = self._lanes[best_tenant].popleft()
            self._size -= 1
            self._vclock = max(self._vclock, req.vtag)
            return req

    # -- deadline shedding ---------------------------------------------------
    def shed_expired(self, now: Optional[float] = None) -> List[ServeRequest]:
        """Remove (and return) every queued request whose deadline has
        passed — the caller responds ``shed``; none of them will ever
        reach a device slot."""
        with self._cond:
            if now is None:
                now = self.clock()
            shed: List[ServeRequest] = []
            for tenant, lane in self._lanes.items():
                if not lane:
                    continue
                keep = collections.deque()
                for req in lane:
                    (shed if req.expired(now) else keep).append(req)
                self._lanes[tenant] = keep
            self._size -= len(shed)
            return shed

    # -- worker parking ------------------------------------------------------
    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Park until something is queued (or the timeout lapses);
        returns whether the queue is non-empty."""
        with self._cond:
            if self._size:
                return True
            self._cond.wait(timeout)
            return self._size > 0

    def kick(self) -> None:
        """Wake a parked worker (shutdown path)."""
        with self._cond:
            self._cond.notify_all()
