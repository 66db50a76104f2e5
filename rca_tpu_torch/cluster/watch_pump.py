"""Background kubernetes watch pumps feeding the incremental-change feed
(the port's copy of ``rca_tpu.cluster.watch_pump``).

The live :meth:`K8sApiClient.watch_changes` surface must never block the
1 Hz streaming poll loop on the API server, so watches run in daemon
threads: each pump holds one long ``kubernetes.watch.Watch`` stream (pods,
events) and appends ``{"kind", "name"}`` notifications to a bounded
thread-safe journal; consumers drain it without blocking.

One :class:`WatchPumpSet` is shared by every consumer of a namespace: the
journal is an append-only window with absolute sequence numbers, and each
consumer holds a **token** mapping to its own read position
(:meth:`register` / :meth:`drain`).  Two streaming sessions over the same
namespace therefore share two watch streams total instead of thrashing a
single token back and forth — replacing the whole set on every reopen
would hand the other session a cursor mismatch on its next poll and
degrade every poll into a full sweep+resync loop.

Each pump pins its stream to a **resourceVersion**: an initial ``limit=1``
list yields the collection RV, every delivered event (and every bookmark —
``allow_watch_bookmarks``) advances it, and stream renewals resume FROM
that RV — without this, every 30 s renewal would replay the whole
collection as synthetic ADDED events and a 10k-pod namespace would
overflow the journal into a permanent expire/resync loop.

Failure semantics mirror a real watch consumer's contract:

- **410 Gone** (the server compacted past our resourceVersion) or any
  stream error expires the whole pump set — every consumer re-lists (full
  resync) and reopens with ``cursor=None``;
- a consumer that falls further behind than the journal window retains
  expires **individually**; other consumers keep draining;
- a normal end of stream (server-side timeout) is NOT an expiry: the
  stream reopens at the tracked RV with no replay and no gap.

``stop()`` calls ``watch.Watch.stop()`` on each pump's stream handle in
addition to setting the stop event, so a stream terminates at its next
delivered event instead of looping into another 30 s renewal.  This is
best-effort, not instant: the real kubernetes
client only checks the stop flag between yielded events, so a pump blocked
in a quiet HTTP read still lingers until the server-side
``timeout_seconds=30`` close — bounded, and harmless: a stopped pump's
late pushes land in an orphaned journal no consumer reads.

Tested hermetically with a stub ``kubernetes`` module
(tests/test_torch_k8s_client.py).

The module holds no wall-clock reads by design: pump retry backoff sleeps
through the injectable seeded :class:`rca_tpu_torch.resilience.policy.Retry`,
and every notification a consumer drains leaves as a ``watch_changes``
call result, so what a consumer sees never depends on pump thread
timing.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Any, Dict, List, Optional

from rca_tpu_torch.resilience.policy import Retry, record_fault, suppressed
from rca_tpu_torch.util.threads import make_lock

QUEUE_CAP = 10_000
# registry bound: dropping a consumer record is always safe (an unknown
# token reads as expired, which forces the one correct recovery — resync)
MAX_CONSUMERS = 256

# resource kinds pumped: churn in these drives streaming features; other
# kinds (services, deployments, config) change topology and are handled by
# the session's periodic full check
_PUMPED = (
    ("pod", "list_namespaced_pod"),
    ("event", "list_namespaced_event"),
)


def _looks_like_gone(exc: BaseException) -> bool:
    """Is this a 410 Gone (resourceVersion compacted away)?  A 410 is NOT
    retryable at the stream level: the tracked RV is dead, consumers must
    re-list.  Matched on the ApiException status when present, else on the
    server's message shape."""
    status = getattr(exc, "status", None)
    if status == 410:
        return True
    msg = str(exc).lower()
    return "410" in msg or "too old resource version" in msg or (
        "expired" in msg
    )


def _meta_attr(obj: Any, attr: str) -> str:
    meta = getattr(obj, "metadata", None)
    if meta is not None:
        return getattr(meta, attr, "") or ""
    if isinstance(obj, dict):
        key = "resourceVersion" if attr == "resource_version" else attr
        return obj.get("metadata", {}).get(key, "") or ""
    return ""


class _Pump(threading.Thread):
    def __init__(self, owner: "WatchPumpSet", kind: str, list_method: str):
        super().__init__(daemon=True, name=f"rca-watch-{kind}")
        self.owner = owner
        self.kind = kind
        self.list_method = list_method
        self.watch_handle: Optional[Any] = None

    def run(self) -> None:
        from kubernetes import watch

        w = watch.Watch()
        # published so WatchPumpSet.stop() can break the blocking stream
        # iteration promptly instead of waiting out the server timeout
        self.watch_handle = w
        list_fn = getattr(self.owner.core, self.list_method)
        retry = self.owner.retry
        attempt = 0
        rv = None
        listed = False
        try:
            while not self.owner._stop.is_set():
                try:
                    if not listed:
                        # initial list pins the stream start (collection
                        # RV): the watch resumes from "now" with no
                        # synthetic replay of the existing objects
                        resp = list_fn(
                            namespace=self.owner.namespace, limit=1
                        )
                        rv = getattr(
                            getattr(resp, "metadata", None),
                            "resource_version", None,
                        )
                        listed = True
                    stream = w.stream(
                        list_fn,
                        namespace=self.owner.namespace,
                        timeout_seconds=30,
                        resource_version=rv,
                        allow_watch_bookmarks=True,
                    )
                    for ev in stream:
                        if self.owner._stop.is_set():
                            return
                        obj = ev.get("object")
                        # every event (bookmarks included) advances the RV
                        # so the next renewal resumes without replay
                        new_rv = _meta_attr(obj, "resource_version")
                        if new_rv:
                            rv = new_rv
                        if str(ev.get("type", "")).upper() == "BOOKMARK":
                            continue
                        name = _meta_attr(obj, "name")
                        if self.kind == "event":
                            # the change the analyzer cares about is the
                            # event's INVOLVED object; fall back to the
                            # event's own name
                            inv = getattr(obj, "involved_object", None)
                            if inv is not None and getattr(inv, "name", ""):
                                name = inv.name
                            elif isinstance(obj, dict):
                                name = (
                                    obj.get("involvedObject", {})
                                    .get("name", "")
                                    or name
                                )
                        if name:
                            # the delivered object's resourceVersion rides
                            # along: row-write consumers key
                            # re-encodes on it and skip already-seen
                            # versions without a re-fetch
                            self.owner.push(self.kind, name, rv=new_rv)
                    # normal stream end (server timeout): reopen at the
                    # tracked RV; a clean round also resets the backoff
                    attempt = 0
                except Exception as exc:
                    if self.owner._stop.is_set():
                        # a teardown-induced stream break is a shutdown,
                        # not a 410: expiring here would force every
                        # consumer of the NEXT connection's feed into a
                        # spurious resync
                        return
                    if _looks_like_gone(exc) or attempt >= retry.attempts:
                        # 410 (RV compacted — consumers MUST re-list) or
                        # retries exhausted: a dead pump silently dropping
                        # changes would be the one unrecoverable failure
                        # mode, so expire the set loudly
                        self.owner.mark_expired()
                        return
                    # transient stream error: resuming at the tracked RV
                    # replays nothing and loses nothing (that is what RV
                    # tracking buys) — back off and reopen instead of
                    # expiring every consumer into a full resync
                    attempt += 1
                    record_fault(f"watch_pump.{self.kind}.reopen", exc)
                    retry.sleep_for(attempt)
        finally:
            w.stop()


# process-wide consumer-token sequence.  This was a CLASS attribute
# incremented under each instance's own lock — a per-instance lock cannot
# guard class-shared state, so two pump sets (two namespaces) registering
# concurrently could mint the SAME token and silently cross their read
# positions.  The fix is a module-level atomic counter (itertools.count.__next__ is one bytecode
# on CPython — no lock needed, no shared RMW left to race).
_TOKEN_SEQ = itertools.count(1)


class WatchPumpSet:
    """Shared pumps + change journal for one namespace, many consumers."""

    def __init__(self, core_api: Any, namespace: str,
                 retry: Optional[Retry] = None):
        self.core = core_api
        self.namespace = namespace
        # transient stream errors reopen at the tracked RV with backoff
        # before the set expires (a 410 still expires immediately);
        # injectable for hermetic tests
        self.retry = retry or Retry(
            attempts=2, base_delay=0.2, max_delay=5.0, seed=0,
        )
        self._lock = make_lock("WatchPumpSet._lock")
        # journal window: _journal[i] has absolute sequence _base + i
        self._journal: collections.deque = collections.deque()
        self._base = 0
        self._next = 0
        # token -> absolute read position
        self._consumers: Dict[str, int] = {}
        self._stop = threading.Event()
        self._expired = threading.Event()
        self._threads = [_Pump(self, k, m) for k, m in _PUMPED]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            w = t.watch_handle
            if w is not None:
                with suppressed("watch_pump.stop"):
                    w.stop()

    # -- consumer registry --------------------------------------------------
    def register(self) -> str:
        """New consumer token positioned at the journal head (changes that
        predate the registration are the caller's resync's problem)."""
        with self._lock:
            token = f"pumps-{next(_TOKEN_SEQ)}"
            self._consumers[token] = self._next
            if len(self._consumers) > MAX_CONSUMERS:
                # evict the most-behind token (likely abandoned by a
                # resync); if its owner ever polls again the unknown token
                # reads as expired — the correct recovery either way
                victim = min(self._consumers, key=self._consumers.get)
                del self._consumers[victim]
            return token

    def deregister(self, token: str) -> None:
        """Drop a consumer whose owner is done with it (e.g. a session
        acquiring a fresh token on resync).  Without this, an abandoned
        token pins the journal's trim floor at its frozen position and the
        window sits at ``QUEUE_CAP`` entries forever on a busy namespace."""
        with self._lock:
            self._consumers.pop(token, None)
            floor = min(self._consumers.values(), default=self._next)
            while self._journal and self._base < floor:
                self._journal.popleft()
                self._base += 1

    def push(self, kind: str, name: str, rv: str = "") -> None:
        with self._lock:
            entry = {"kind": kind, "name": name}
            if rv:
                entry["rv"] = rv
            self._journal.append(entry)
            self._next += 1
            # trim what every consumer has already read
            floor = min(self._consumers.values(), default=self._next)
            while self._journal and self._base < floor:
                self._journal.popleft()
                self._base += 1
            # cap the window regardless: consumers lagging past the cap
            # expire individually on their next drain
            while len(self._journal) > QUEUE_CAP:
                self._journal.popleft()
                self._base += 1

    def drain(self, token: str) -> Optional[List[Dict[str, str]]]:
        """Changes since this consumer's position, deduped; ``None`` means
        the consumer (or the whole set) expired and must resync."""
        with self._lock:
            if self._expired.is_set():
                self._consumers.pop(token, None)
                return None
            pos = self._consumers.get(token)
            if pos is None or pos < self._base:
                # unknown token or lagged past the retained window
                self._consumers.pop(token, None)
                return None
            by_key: Dict[tuple, Dict[str, str]] = {}
            out = []
            for i in range(pos - self._base, len(self._journal)):
                c = self._journal[i]
                key = (c["kind"], c["name"])
                prev = by_key.get(key)
                if prev is None:
                    rec = dict(c)
                    by_key[key] = rec
                    out.append(rec)
                elif c.get("rv"):
                    # deduped entry keeps its first-seen position but the
                    # NEWEST resourceVersion (a row write wants the latest)
                    prev["rv"] = c["rv"]
            self._consumers[token] = self._next
            return out

    @property
    def expired(self) -> bool:
        return self._expired.is_set()

    def mark_expired(self) -> None:
        self._expired.set()
