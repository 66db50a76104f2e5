"""Shape-bucket batcher: group compatible requests, flush by size or age
(the port's copy of ``rca_tpu.serve.batcher``).

The staging area between the fair queue and the device: requests popped
in service order land here grouped by :func:`rca_tpu_torch.serve.request.
graph_key` — the identity that guarantees one coalesced dispatch returns
bit-identical per-lane results (same padded node/edge bucket, same edge
arrays, same kernel plan).

Flush policy (the continuous-batching core):

- a group that reaches ``max_batch`` flushes immediately (a full device
  batch is never held back);
- a group whose OLDEST member has been in the system longer than
  ``max_wait_us`` flushes at whatever width it reached — the wait bound
  is how long a request may be held hoping for batchmates;
- when the device is idle and the queue is drained (``drain=True``), the
  oldest group flushes immediately — an idle engine never sits out the
  wait window, so a lone request's latency is one dispatch, not
  ``max_wait_us`` plus one dispatch.  ``max_wait_us`` therefore only
  shapes behavior under load, which is exactly when batching pays.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from rca_tpu_torch.serve.request import GraphKey, ServeRequest


class ShapeBucketBatcher:
    def __init__(
        self,
        max_batch: int = 16,
        max_wait_us: int = 2000,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) / 1e6
        self.clock = clock
        # insertion-ordered groups; each group FIFO by service order
        self._groups: Dict[GraphKey, List[ServeRequest]] = {}
        self._staged = 0

    # -- staging -------------------------------------------------------------
    def offer(self, req: ServeRequest) -> None:
        # batch-wait accounting: the serve.batch span runs from here to
        # batch formation; a re-offer (work steal) restamps, so the span
        # measures time on the replica that actually served it
        req.staged_at = self.clock()
        self._groups.setdefault(req.graph_key, []).append(req)
        self._staged += 1

    def staged(self) -> int:
        return self._staged

    def group_count(self) -> int:
        return sum(1 for g in self._groups.values() if g)

    # -- flush policy --------------------------------------------------------
    def _age(self, group: List[ServeRequest], now: float) -> float:
        # group is FIFO: [0] is the oldest member; age counts from
        # ADMISSION, not staging — the wait bound covers the whole queue
        return now - group[0].enqueued_at

    def _take(self, key: GraphKey, width: int) -> List[ServeRequest]:
        group = self._groups[key]
        batch, rest = group[:width], group[width:]
        if rest:
            self._groups[key] = rest
        else:
            del self._groups[key]
        self._staged -= len(batch)
        return batch

    def take_ready(
        self, now: Optional[float] = None, drain: bool = False
    ) -> Optional[List[ServeRequest]]:
        """The next batch to dispatch, or None while every group is still
        worth holding for batchmates (see module docstring for policy)."""
        if now is None:
            now = self.clock()
        oldest_key = None
        oldest_age = -1.0
        for key, group in self._groups.items():
            if not group:
                continue
            if len(group) >= self.max_batch:
                return self._take(key, self.max_batch)
            age = self._age(group, now)
            if age > oldest_age:
                oldest_age = age
                oldest_key = key
        if oldest_key is None:
            return None
        if oldest_age >= self.max_wait_s or drain:
            return self._take(oldest_key, self.max_batch)
        return None

    def next_ready_in(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the oldest staged group matures past the wait
        bound (a parked worker's wake-up timeout); None when empty."""
        if now is None:
            now = self.clock()
        ages = [
            self._age(g, now) for g in self._groups.values() if g
        ]
        if not ages:
            return None
        return max(0.0, self.max_wait_s - max(ages))

    # -- deadline shedding ---------------------------------------------------
    def shed_expired(self, now: Optional[float] = None) -> List[ServeRequest]:
        """Remove (and return) staged requests whose deadline has passed
        — same contract as the queue's shed: no device slot, ever."""
        if now is None:
            now = self.clock()
        shed: List[ServeRequest] = []
        for key in list(self._groups):
            group = self._groups[key]
            keep = [r for r in group if not r.expired(now)]
            if len(keep) != len(group):
                shed.extend(r for r in group if r.expired(now))
                if keep:
                    self._groups[key] = keep
                else:
                    del self._groups[key]
        self._staged -= len(shed)
        return shed
