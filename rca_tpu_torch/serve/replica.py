"""Engine replicas for the serve pool (the port's copy of
``rca_tpu.serve.replica``).

A :class:`ReplicaWorker` is one slice of the serving plane: its own
engine (dense on one device, or sharded over a device group carved from
the visible devices), its own :class:`rca_tpu_torch.serve.dispatcher.
BatchDispatcher` (prepared-graph cache and resident bases), its own
:class:`rca_tpu_torch.serve.batcher.ShapeBucketBatcher`, its own
:class:`rca_tpu_torch.resilience.policy.CircuitBreaker` and its own worker
thread.  The :class:`rca_tpu_torch.serve.pool.ServePool` routes shape
buckets from the ONE shared queue into replicas; everything a replica
answers flows through the pool-wide :class:`CompletionSink`, which owns
the exactly-once completion accounting and the degradation ladder's
last-known rankings.

Concurrency: worker threads come from
:func:`rca_tpu_torch.util.threads.make_thread`; every mutable replica
attribute the router or a stealing peer can touch is guarded by
``ReplicaWorker._lock``, and that lock is NEVER held across a device
dispatch or fetch, so stealing a dying replica's staged work never waits
on its device round trip.  Lock order (one-way): ``ServePool._route_lock``
→ ``ReplicaWorker._lock`` → ``BatchDispatcher._graphs_lock``;
``CompletionSink._lock``, ``ServeMetrics._lock`` and the registry's
election lock are leaves.  A dense replica commits its launches to its
device (``torch.cuda.device``); replicas that share a card launch on its
default stream from their own threads.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, List, Optional

import torch

from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.observability.spans import (
    default_tracer,
    device_annotation,
)
from rca_tpu_torch.resilience.policy import (
    CircuitBreaker,
    record_fault,
    suppressed,
)
from rca_tpu_torch.serve.batcher import ShapeBucketBatcher
from rca_tpu_torch.serve.dispatcher import BatchDispatcher, BatchHandle
from rca_tpu_torch.serve.request import GraphKey, ServeRequest, ServeResponse
from rca_tpu_torch.util.threads import make_lock, make_thread

#: last-known rankings kept pool-wide for degraded responses
LAST_KNOWN_CAP = 128
#: staging window: how far one replica reads ahead of its device
STAGE_AHEAD_BATCHES = 4


class ReplicaKilled(RuntimeError):
    """Raised inside a replica's scheduling iteration after
    :meth:`ReplicaWorker.kill` — the chaos/test seam for replica death
    (the worker's crash handler turns it into the same rebalance a real
    scheduling-loop exception triggers)."""


class CompletionSink:
    """The ONE place serve responses are delivered (pool-wide).

    Shared by every replica (and by the single-replica
    :class:`rca_tpu_torch.serve.loop.ServeLoop`), it owns:

    - **exactly-once accounting**: ``ServeRequest.complete`` is
      first-writer-wins; a second completion attempt (a steal racing the
      original owner) is counted in ``double_completions`` — the
      replica-kill tests assert it stays ZERO, the proof the steal
      protocol never re-serves an already-answered request;
    - **the degradation ladder's memory**: last-known rankings per graph
      key, shared pool-wide so ANY replica can serve a stale answer for a
      graph another replica computed;
    - **the flight recorder's serve frames** (``recorder``): an ``ok``
      response whose completion won writes one frame under the sink's
      lock, so N replica workers write one frame per request.  A failed
      frame is a recorded fault (``serve.record``), never a failed
      response;
    - **the investigation store's notes** (``store``): an ``ok`` response
      whose request names an investigation appends a serve note there
      (and the recording's path when a recorder is attached), and an
      explained one lands its provenance block, which ``why`` renders.
      Both are written before the completion, so a caller that reads the
      store after ``result()`` sees them; a store failure is a recorded
      fault, never a failed response.
    """

    def __init__(self, metrics, clock: Callable[[], float], tracer=None,
                 recorder=None, store=None):
        self.metrics = metrics
        self.clock = clock
        self.recorder = recorder
        self.store = store
        # the sink is where every request terminates exactly once, so the
        # root ``serve.request`` span and the duration sample belong here
        self.tracer = tracer if tracer is not None else default_tracer()
        self._lock = make_lock("CompletionSink._lock")
        self._last_known: "collections.OrderedDict[GraphKey, List[dict]]" = (
            collections.OrderedDict()
        )
        self.double_completions = 0

    # -- exactly-once core ---------------------------------------------------
    def _complete(self, req: ServeRequest, resp: ServeResponse) -> bool:
        resp.completed_at = self.clock()
        if req.complete(resp):
            # exactly-once telemetry rides the exactly-once completion:
            # a losing steal-race completion records neither a duration
            # sample nor a (duplicate) root span
            self._observe(req, resp.status, resp.completed_at)
            return True
        with self._lock:
            self.double_completions += 1
        return False

    def _observe(self, req: ServeRequest, status: str, now: float) -> None:
        """Terminal telemetry for one completed request: the per-tenant
        duration histogram and SLO burn sample (``degraded`` counts as
        served — stale by contract; ``shed``/``error`` burn budget at any
        speed), and the request's root span, closed under its pre-minted
        identity so every child recorded on the way is parented."""
        start = req.enqueued_at if req.enqueued_at > 0.0 else now
        self.metrics.request_duration(
            req.tenant, max(0.0, now - start),
            ok=status in ("ok", "degraded"),
        )
        if self.tracer.enabled and req.trace is not None:
            self.tracer.record(
                "serve.request", start, now,
                parent=req.trace_parent, context=req.trace,
                attrs={
                    "tenant": req.tenant, "status": status,
                    "request_id": req.request_id,
                },
            )

    # -- last-known ladder ---------------------------------------------------
    def remember(self, key: GraphKey, ranked: List[dict]) -> None:
        with self._lock:
            self._last_known[key] = ranked
            self._last_known.move_to_end(key)
            while len(self._last_known) > LAST_KNOWN_CAP:
                self._last_known.popitem(last=False)

    def last_known(self, key: GraphKey) -> Optional[List[dict]]:
        with self._lock:
            return self._last_known.get(key)

    # -- response paths ------------------------------------------------------
    def ok(self, req: ServeRequest, result, width: int,
           dispatched_at: float) -> None:
        ranked = [dict(r) for r in result.ranked]
        self.remember(req.graph_key, ranked)
        provenance = None
        if req.explain:
            # one extra pass, charged to the explaining request only; an
            # attribution failure never fails the ranking — the stub says
            # what broke instead
            self.metrics.explained(req.tenant)
            try:
                provenance = result.attribution()
            except Exception as exc:  # noqa: BLE001 - degrade, but say so
                record_fault("serve.explain", exc)
                provenance = {
                    "error": f"{type(exc).__name__}: {exc}",
                }
        queue_ms = max(0.0, (dispatched_at - req.enqueued_at) * 1e3)
        self.metrics.answered(req.tenant, queue_ms)
        self._store_note(req, result)
        if (provenance is not None and self.store is not None
                and req.investigation_id is not None):
            with suppressed("serve.store_provenance"):
                self.store.set_provenance(req.investigation_id, provenance)
        won = self._complete(req, ServeResponse(
            status="ok", request_id=req.request_id, tenant=req.tenant,
            ranked=ranked, queue_ms=round(queue_ms, 3), batch_size=width,
            deadline_missed=req.expired(self.clock()),
            result=result, provenance=provenance,
        ))
        if won and self.recorder is not None:
            with suppressed("serve.record"), self._lock:
                self.recorder.record_serve(req, ranked)

    def shed(self, req: ServeRequest, detail: str) -> None:
        self.metrics.shed(req.tenant)
        self._complete(req, ServeResponse(
            status="shed", request_id=req.request_id, tenant=req.tenant,
            detail=detail,
        ))

    def degraded(self, req: ServeRequest, detail: str) -> None:
        """Last-known ranking when one exists, ``error`` otherwise — the
        ladder's bottom rungs."""
        stale = self.last_known(req.graph_key)
        if stale is not None:
            self.metrics.degraded(req.tenant)
            self._complete(req, ServeResponse(
                status="degraded", request_id=req.request_id,
                tenant=req.tenant, ranked=[dict(r) for r in stale],
                detail=detail + " (serving last known ranking)",
            ))
        else:
            self.error(req, detail)

    def error(self, req: ServeRequest, detail: str) -> None:
        self.metrics.errors(req.tenant)
        self._complete(req, ServeResponse(
            status="error", request_id=req.request_id, tenant=req.tenant,
            detail=detail,
        ))

    def _store_note(self, req: ServeRequest, result) -> None:
        """The investigation-store append of one served request, safe from
        any worker thread (the store locks its files); a store failure
        never fails the response."""
        if self.store is None or req.investigation_id is None:
            return
        top = result.ranked[0]["component"] if result.ranked else None
        with suppressed("serve.store_note"):
            self.store.add_message(
                req.investigation_id, "serve",
                {
                    "request_id": req.request_id,
                    "tenant": req.tenant,
                    "top_component": top,
                    "engine": result.engine,
                },
            )
            if self.recorder is not None:
                self.store.set_recording_ref(
                    req.investigation_id, str(self.recorder.path)
                )


class ReplicaWorker:
    """One engine replica behind the pool's shared queue, or (with no
    pool) the device side of the single :class:`rca_tpu_torch.serve.loop.
    ServeLoop`.

    Life cycle: the pool routes requests in via :meth:`offer`; the
    worker thread (or the pool's fake-clock ``run_once``) forms
    shape-bucket batches, dispatches them breaker-guarded, and fetches
    one batch behind (the dispatch/fetch split, per replica).  A
    dead or breaker-open replica's staged work is taken back via
    :meth:`take_staged`/:meth:`take_inflight` by the pool's
    work-stealing rebalance.
    """

    def __init__(
        self,
        replica_id: int,
        engine=None,
        kind: str = "dense",
        device=None,
        config: Optional[ServeConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        sink: Optional[CompletionSink] = None,
        metrics=None,
        fault_hook: Optional[Callable[[str], None]] = None,
        breaker: Optional[CircuitBreaker] = None,
        dispatcher: Optional[BatchDispatcher] = None,
        pool=None,
        queue=None,
        tracer=None,
        name: Optional[str] = None,
    ):
        self.replica_id = int(replica_id)
        self.kind = kind
        #: the scope its faults and breaker are recorded under
        self.name = name or f"serve.replica{self.replica_id}"
        self.tracer = tracer if tracer is not None else default_tracer()
        #: the device this replica commits its dispatches to (dense
        #: replicas; sharded ones place through their engine's mesh)
        self.device = device
        self.config = config or ServeConfig.from_env()
        self.clock = clock
        self.sink = sink
        self.metrics = metrics
        self.pool = pool
        #: the admission queue feeding this worker (its drain check: a
        #: partial batch flushes at once only while nothing waits there)
        self.queue = queue
        self.batcher = ShapeBucketBatcher(
            self.config.max_batch, self.config.max_wait_us, clock=clock
        )
        self.dispatcher = dispatcher or BatchDispatcher(
            engine, fault_hook=fault_hook, metrics=metrics,
        )
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_after=1.0, clock=clock,
            name=self.name,
        )
        self._lock = make_lock("ReplicaWorker._lock")
        self._inflight: Optional[BatchHandle] = None
        self._alive = True
        self._killed = False
        self._stop = False
        self._thread = None
        self._device_batches = 0
        self._last_state = ""

    # -- state the router reads ----------------------------------------------
    def alive(self) -> bool:
        with self._lock:
            return self._alive and not self._killed

    def routable(self) -> bool:
        """May the router assign NEW work here?  Alive and breaker not
        open (half-open replicas take work — that traffic is the probe
        that closes the breaker)."""
        return self.alive() and self.breaker.state != "open"

    def occupancy(self) -> int:
        """Requests this replica currently holds (staged + in flight)."""
        with self._lock:
            inflight = (
                len(self._inflight.requests)
                if self._inflight is not None else 0
            )
            return self.batcher.staged() + inflight

    def has_room(self) -> bool:
        with self._lock:
            staged = self.batcher.staged()
        return staged < self.config.max_batch * STAGE_AHEAD_BATCHES

    def has_graph(self, key: GraphKey) -> bool:
        return self.dispatcher.has_graph(key)

    @property
    def device_batches(self) -> int:
        with self._lock:
            return self._device_batches

    # -- routing surface -----------------------------------------------------
    def offer(self, req: ServeRequest) -> bool:
        """Stage one routed request; False when this replica died between
        the router's liveness check and the offer (the router then
        re-places the request)."""
        with self._lock:
            if not self._alive or self._killed or self._stop:
                return False
            self.batcher.offer(req)
            return True

    # -- steal surface (pool rebalance; see pool.rebalance_from) -------------
    def take_staged(self) -> List[ServeRequest]:
        """Drain EVERYTHING staged here (steal path).  Idempotent: a
        second taker gets an empty list."""
        out: List[ServeRequest] = []
        with self._lock:
            while self.batcher.staged():
                batch = self.batcher.take_ready(drain=True)
                if not batch:
                    break
                out.extend(batch)
        return out

    def take_inflight(self) -> Optional[BatchHandle]:
        """Atomically claim the in-flight batch (steal path) — the taker
        owns its fetch; a second taker gets None, which is what makes
        double-completion impossible by construction."""
        with self._lock:
            handle, self._inflight = self._inflight, None
            return handle

    def kill(self) -> None:
        """Chaos/test seam: the next scheduling iteration raises
        :class:`ReplicaKilled`, driving the same crash-and-rebalance path
        a real worker death takes."""
        with self._lock:
            self._killed = True

    def mark_dead(self, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._alive = False
        if exc is not None and not isinstance(exc, ReplicaKilled):
            record_fault(self.name, exc)
        self._note_state("dead")

    def _note_state(self, state: Optional[str] = None) -> None:
        if self.metrics is None or self.pool is None:
            return
        if state is None:
            state = self.breaker.state if self.alive() else "dead"
        with self._lock:
            changed = state != self._last_state
            self._last_state = state
        if changed:
            self.metrics.replica_state(self.replica_id, state)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaWorker":
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                self._stop = False
            self._thread = make_thread(
                self._run, name=f"rca-serve-replica{self.replica_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def request_stop(self) -> None:
        with self._lock:
            self._stop = True

    def join(self, timeout: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- scheduling ----------------------------------------------------------
    def run_once(self, now: Optional[float] = None) -> bool:
        """One replica scheduling iteration: shed → form batch →
        breaker-guarded dispatch → fetch the PREVIOUS batch (its device
        round trip overlapped this iteration's host work).  Raises
        :class:`ReplicaKilled` after :meth:`kill` — callers (the worker
        thread's crash handler, the pool's fake-clock ``run_once``) turn that
        into death + rebalance."""
        if now is None:
            now = self.clock()
        with self._lock:
            if self._killed:
                raise ReplicaKilled(
                    f"replica {self.replica_id} killed"
                )
            expired = self.batcher.shed_expired(now)
        worked = False
        for req in expired:
            self.sink.shed(req, detail="expired_in_batcher")
            worked = True
        # open breaker in a pool: complete what is already in flight (the
        # dispatch happened — fetch either serves it or degrades it;
        # submitters must not park until the half-open probe), then hand
        # staged work back to the pool (work-stealing rebalance).  With no
        # pool (the single ServeLoop) the batch goes on to the guarded
        # dispatch, whose closed gate answers it degraded at once without
        # touching the device: a broken device must not accumulate queue
        if self.pool is not None and self.breaker.state == "open":
            self._note_state()
            prev = self.take_inflight()
            if prev is not None:
                self._fetch_guarded(prev)
                worked = True
            worked |= self.pool.rebalance_from(
                self, reason="breaker_open"
            ) > 0
            return worked
        with self._lock:
            drain = self._inflight is None and (
                self.queue is None or len(self.queue) == 0)
            batch = self.batcher.take_ready(now, drain=drain)
        handle = None
        if batch:
            worked = True
            live: List[ServeRequest] = []
            for req in batch:
                # last call: an expired request must not ride a device
                # slot even when its batch is already formed
                if req.expired(now):
                    self.sink.shed(req, detail="expired_at_dispatch")
                else:
                    live.append(req)
            if live:
                if self.tracer.enabled:
                    for req in live:
                        if req.trace is not None:
                            # batcher staging wait, on the replica that
                            # actually formed the batch (a steal restamps
                            # staged_at, so the span never spans replicas)
                            self.tracer.record(
                                "serve.batch",
                                req.staged_at or now, now,
                                parent=req.trace,
                                attrs={"replica": self.replica_id,
                                       "width": len(live)},
                            )
                handle = self._dispatch_guarded(live)
        prev = self.take_inflight()
        if prev is not None:
            # fetch the PREVIOUS batch only after this iteration's
            # dispatch is in flight
            self._fetch_guarded(prev)
            worked = True
        if handle is not None:
            with self._lock:
                self._inflight = handle
        if worked and self.metrics is not None and self.pool is not None:
            self.metrics.replica_occupancy(
                self.replica_id, self.occupancy()
            )
        self._note_state()
        return worked

    def drain_inflight(self) -> None:
        """Fetch whatever is still in flight (clean-shutdown path — the
        results exist; submitters must not park forever)."""
        prev = self.take_inflight()
        if prev is not None:
            self._fetch_guarded(prev)

    def _run(self) -> None:
        try:
            while True:
                with self._lock:
                    if self._stop:
                        break
                worked = False
                if self.pool is not None:
                    worked |= self.pool.route_once()
                worked |= self.run_once()
                if not worked and self.pool is not None:
                    with self._lock:
                        timeout = self.batcher.next_ready_in()
                    self.pool.park(timeout)
        except Exception as exc:  # noqa: BLE001 - crash = replica death
            self.mark_dead(exc)
            if self.pool is not None:
                self.pool.rebalance_from(self, reason="replica_death")
            return
        self.drain_inflight()

    # -- guarded device path -------------------------------------------------
    def _device_ctx(self):
        """Dense replicas commit their launches to their carved card;
        sharded replicas place through the engine's mesh, and the CPU has
        no current device."""
        if self.device is None or torch.device(self.device).type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def _dispatch_guarded(
        self, batch: List[ServeRequest]
    ) -> Optional[BatchHandle]:
        if not self.breaker.allow():
            # raced from half-open to open (or another probe is out):
            # give the batch back to the pool rather than burning it
            if self.pool is not None:
                self.pool.redistribute(
                    batch, exclude=self, reason="breaker_open"
                )
            else:
                for req in batch:
                    self.sink.degraded(req, detail="circuit_open")
            return None
        t0 = self.clock()
        try:
            with self._device_ctx(), device_annotation("serve.dispatch"):
                handle = self.dispatcher.dispatch(batch, now=self.clock())
        except Exception as exc:
            record_fault(f"{self.name}.dispatch", exc)
            self.breaker.record_failure()
            for req in batch:
                self.sink.degraded(
                    req, detail=f"dispatch_failed:{type(exc).__name__}"
                )
            return None
        self._dispatch_spans(batch, handle, t0, self.clock())
        with self._lock:
            self._device_batches += 1
        return handle

    def _dispatch_spans(
        self, batch: List[ServeRequest], handle, t0: float, t1: float,
    ) -> None:
        """One serve.dispatch span per traced request: the host-side
        pack/enqueue window, stamped with the engaged registry row and
        whether the resident delta path carried the upload."""
        if not self.tracer.enabled:
            return
        for req in batch:
            if req.trace is not None:
                self.tracer.record(
                    "serve.dispatch", t0, t1, parent=req.trace,
                    attrs={
                        "batch_size": len(batch),
                        "replica": self.replica_id,
                        "engine": getattr(
                            self.dispatcher, "engine_tag", ""
                        ),
                        "kernel": getattr(handle, "kernel", None),
                        "explain": req.explain,
                        "resident_delta": bool(getattr(
                            handle, "resident_delta", False
                        )),
                    },
                )

    def _fetch_guarded(self, handle: BatchHandle) -> None:
        t0 = self.clock()
        try:
            with self._device_ctx(), device_annotation("serve.fetch"):
                results = self.dispatcher.fetch(handle)
        except Exception as exc:
            record_fault(f"{self.name}.fetch", exc)
            self.breaker.record_failure()
            for req in handle.requests:
                self.sink.degraded(
                    req, detail=f"fetch_failed:{type(exc).__name__}"
                )
            return
        if self.tracer.enabled:
            t1 = self.clock()
            for req in handle.requests:
                if req.trace is not None:
                    # the device round-trip sync: dispatched_at→t0 is the
                    # overlapped in-flight window, t0→t1 the actual wait
                    self.tracer.record(
                        "serve.fetch", t0, t1, parent=req.trace,
                        attrs={
                            "batch_size": len(handle.requests),
                            "replica": self.replica_id,
                            "inflight_ms": round(max(
                                0.0, (t0 - handle.dispatched_at) * 1e3
                            ), 3),
                        },
                    )
        self.breaker.record_success()
        width = len(handle.requests)
        if self.metrics is not None:
            self.metrics.record_batch(width)
            if self.pool is not None:
                self.metrics.replica_batch(self.replica_id, width)
        for req, result in zip(handle.requests, results):
            self.sink.ok(req, result, width, handle.dispatched_at)


def build_replica_engines(
    specs,
    devices=None,
    config=None,
    params=None,
):
    """``(kind, group_size|None)`` specs (from
    :func:`rca_tpu_torch.config.parse_replica_mix`) → ``(kind, engine,
    device|None)`` triples, with device groups carved contiguously from
    ``devices`` (default: the visible CUDA devices; raises without a card)
    by :func:`rca_tpu_torch.parallel.mesh.carve_device_groups`.  A dense
    replica is a ``GraphEngine`` on its group's device; a sharded one a
    ``ShardedGraphEngine`` over a ``dp = 1`` mesh of its group, whose
    device list may repeat a card (logical shards)."""
    from rca_tpu_torch.engine.runner import GraphEngine, resolve_device
    from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine
    from rca_tpu_torch.parallel.mesh import (
        carve_device_groups,
        make_mesh,
        visible_devices,
    )

    if devices is None:
        devices = visible_devices(resolve_device(None))
    devices = [torch.device(d) for d in devices]
    n = max(1, len(specs))
    sizes = [
        group if group is not None
        else (1 if kind == "dense" else max(1, len(devices) // n))
        for kind, group in specs
    ]
    out = []
    for (kind, _), group in zip(specs, carve_device_groups(sizes, devices)):
        if kind == "sharded":
            mesh = make_mesh([("dp", 1), ("sp", len(group))], group)
            out.append((kind, ShardedGraphEngine(
                mesh=mesh, config=config, params=params,
            ), None))
        else:
            out.append((kind, GraphEngine(
                config=config, params=params, device=group[0],
            ), group[0]))
    return out
