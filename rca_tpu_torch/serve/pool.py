"""ServePool: the multi-replica, multi-device serving plane (the port's copy
of ``rca_tpu.serve.pool``).

One shared :class:`rca_tpu_torch.serve.queue.RequestQueue` (admission,
weighted-fair order, priorities, deadline shedding — unchanged) feeds N
:class:`rca_tpu_torch.serve.replica.ReplicaWorker` engine replicas, a
configurable dense/sharded mix each owning a device group carved from
the visible devices (groups wrap around, so replicas may share a card).
Aggregate throughput scales with replicas instead of being
capped by the one-engine :class:`rca_tpu_torch.serve.loop.ServeLoop`.

**Routing** (shape-bucket aware): a popped request's graph key is looked
up in this order —

1. **home stickiness**: the replica this bucket was last routed to,
   while it is routable and has stage room;
2. **resident stickiness**: any routable replica whose dispatcher
   already pins this graph's prepared state + resident feature base
   (``BatchDispatcher.has_graph``) — hot buckets keep their O(changed
   rows) delta path instead of re-staging on a cold replica;
3. **least-occupied**: cold buckets go to the routable replica holding
   the fewest requests (staged + in flight).

**Failover** (work-stealing rebalance): when a replica's worker dies
(any exception escaping its scheduling iteration, or the chaos
:meth:`ReplicaWorker.kill` seam) or its circuit breaker opens, its
staged requests are taken back and re-placed on surviving replicas, and
a dead replica's in-flight batch is claimed atomically and fetched by
the stealer (results exist on device; claiming is first-taker-wins, so
completion stays exactly-once — ``CompletionSink.double_completions``
stays 0 by construction, asserted under chaos in the tests).  With no
survivor — or ``RCA_SERVE_STEAL=0`` — stolen requests ride the existing
degradation ladder (last-known ranking, else ``error``) instead of
hanging.

Threading: each replica worker loops *route → schedule own replica*; the
route step is serialized by ``ServePool._route_lock`` so two workers
never place one request twice.  The pool also runs single-threaded under
a fake clock (:meth:`run_once`) for deterministic policy tests, exactly
like :class:`ServeLoop`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.observability.spans import default_tracer
from rca_tpu_torch.serve.metrics import ServeMetrics
from rca_tpu_torch.serve.queue import RequestQueue
from rca_tpu_torch.serve.replica import (
    STAGE_AHEAD_BATCHES,
    CompletionSink,
    ReplicaWorker,
    build_replica_engines,
)
from rca_tpu_torch.serve.request import GraphKey, ServeRequest, ServeResponse
from rca_tpu_torch.util.threads import make_lock

#: idle park time when a worker finds no routing or replica work
_IDLE_WAIT_S = 0.05


class ServePool:
    def __init__(
        self,
        engines=None,
        config: Optional[ServeConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_hook: Optional[Callable[[str], None]] = None,
        store=None,
        recorder=None,
        devices=None,
        dispatchers: Optional[Sequence] = None,
        breakers: Optional[Sequence] = None,
        tracer=None,
        kernelscope: Optional[bool] = None,
    ):
        """``engines``: optional replica engines — either bare engine
        objects (dense, placed where the engine was built) or ``(kind,
        engine, device)`` triples as built by
        :func:`rca_tpu_torch.serve.replica.build_replica_engines`.  When
        omitted, the replica set comes from ``config.replica_specs()``
        (``RCA_SERVE_REPLICAS`` / ``RCA_SERVE_REPLICA_MIX``) over
        ``devices`` (default: the visible CUDA devices).  ``dispatchers``
        (tests) builds one stub replica per entry instead.  ``recorder``
        writes one ``serve`` frame per ``ok`` response, whichever replica
        served it; ``store`` (an investigation store) takes each ``ok``
        response's serve note and explained provenance, as the loop's."""
        self.config = config or ServeConfig.from_env()
        self.clock = clock
        self.queue = RequestQueue(self.config.queue_cap, clock=clock)
        self.metrics = ServeMetrics()
        # ONE pool-wide recompile watchdog (the compile log is
        # process-global; per-replica monitors would double count)
        from rca_tpu_torch.observability.kernelscope import RecompileMonitor

        self.recompile_monitor = RecompileMonitor(enabled=kernelscope)
        # one tracer for the whole plane: admission mints the root
        # context, the router records queue/steal spans, replicas record
        # batch/dispatch/fetch, the sink closes the root
        self.tracer = tracer if tracer is not None else default_tracer()
        self.store = store
        self.sink = CompletionSink(self.metrics, clock, tracer=self.tracer,
                                   store=store, recorder=recorder)
        self.steal = bool(self.config.steal)
        self._route_lock = make_lock("ServePool._route_lock")
        self._home: dict = {}          # GraphKey -> replica_id (sticky)
        self.replicas: List[ReplicaWorker] = []
        if dispatchers is not None:
            triples = [("stub", None, None)] * len(dispatchers)
        elif engines is not None:
            triples = [
                e if isinstance(e, tuple) else ("dense", e, None)
                for e in engines
            ]
        else:
            triples = build_replica_engines(
                self.config.replica_specs(), devices=devices,
            )
        for i, (kind, engine, device) in enumerate(triples):
            self.replicas.append(ReplicaWorker(
                i, engine=engine, kind=kind, device=device,
                config=self.config, clock=clock, sink=self.sink,
                metrics=self.metrics, fault_hook=fault_hook,
                dispatcher=(
                    dispatchers[i] if dispatchers is not None else None
                ),
                breaker=(
                    breakers[i] if breakers is not None else None
                ),
                pool=self,
                queue=self.queue,
                tracer=self.tracer,
            ))
        self.recorder = recorder
        if recorder is not None:
            recorder.begin_session({
                "replicas": len(self.replicas),
                "mix": [r.kind for r in self.replicas],
                "max_batch": self.config.max_batch,
                "max_wait_us": self.config.max_wait_us,
                "queue_cap": self.config.queue_cap,
            })

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServePool":
        self.recompile_monitor.start()
        for r in self.replicas:
            r.start()
        return self

    def kernelscope_summary(self) -> dict:
        """See :func:`rca_tpu_torch.serve.loop.kernelscope_summary`."""
        from rca_tpu_torch.serve.loop import kernelscope_summary

        return kernelscope_summary(self.recompile_monitor)

    def stop(self, timeout: float = 10.0) -> None:
        self.recompile_monitor.stop()
        for r in self.replicas:
            r.request_stop()
        self.queue.kick()
        for r in self.replicas:
            r.join(timeout)
        # single-threaded now: complete everything still in the system —
        # in-flight batches fetch normally (results exist), the rest
        # errors out; a stopped pool must not leave submitters parked
        for r in self.replicas:
            r.drain_inflight()
        leftovers: List[ServeRequest] = []
        while True:
            req = self.queue.pop()
            if req is None:
                break
            leftovers.append(req)
        for r in self.replicas:
            leftovers.extend(r.take_staged())
        for req in leftovers:
            self.sink.error(req, "serve pool stopped")

    def __enter__(self) -> "ServePool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def park(self, timeout: Optional[float] = None) -> None:
        """Worker idle wait: parked on the shared queue's condition so a
        submit (or shutdown kick) wakes everyone."""
        self.queue.wait_for_work(
            min(timeout if timeout is not None else _IDLE_WAIT_S,
                _IDLE_WAIT_S)
        )

    @property
    def device_batches(self) -> int:
        return sum(r.device_batches for r in self.replicas)

    def occupancy(self) -> float:
        """Fraction of the live replicas' staging capacity in use (each
        replica's staged and in-flight requests over its stage-ahead cap);
        1.0 when no replica is alive.  The gateway's ``/healthz`` shows it
        for a pool."""
        live = [r for r in self.replicas if r.alive()]
        if not live:
            return 1.0
        cap = max(1, self.config.max_batch * STAGE_AHEAD_BATCHES * len(live))
        return min(1.0, sum(r.occupancy() for r in live) / cap)

    # -- admission (same contract as ServeLoop.submit) -----------------------
    def submit(self, req: ServeRequest) -> bool:
        """Admit one request; either way the request WILL be completed
        (``queue_full``/``shed`` are delivered synchronously here), so
        ``req.result()`` always terminates."""
        now = self.clock()
        if self.tracer.enabled and req.trace is None:
            # mint the request's root-span identity at admission: every
            # span recorded on its way through (queue, batch, dispatch,
            # fetch, steal) parents onto it; the sink records the span
            # itself at completion
            req.trace = self.tracer.new_context(parent=req.trace_parent)
        if req.expired(now):
            self.sink.shed(req, detail="expired_at_admission")
            return False
        if not self.queue.submit(req):
            self.metrics.rejected(req.tenant)
            req.complete(ServeResponse(
                status="queue_full", request_id=req.request_id,
                tenant=req.tenant,
                detail=f"queue at capacity ({self.queue.cap})",
            ))
            return False
        self.metrics.submitted(req.tenant, len(self.queue))
        return True

    # -- routing -------------------------------------------------------------
    def route_once(self, now: Optional[float] = None) -> bool:
        """Drain the shared queue into replica batchers (serialized: one
        router at a time).  Stops while every routable replica's staging
        window is full — backpressure stays in the shared queue where
        admission accounting lives."""
        if now is None:
            now = self.clock()
        worked = False
        with self._route_lock:
            for req in self.queue.shed_expired(now):
                self.sink.shed(req, detail="expired_in_queue")
                worked = True
            while True:
                routable = [r for r in self.replicas if r.routable()]
                if routable and not any(
                    r.has_room() for r in routable
                ):
                    # every live replica's staging window is full:
                    # backpressure stays in the shared queue
                    break
                req = self.queue.pop()
                if req is None:
                    break
                if self.tracer.enabled and req.trace is not None:
                    # the fair-queue wait ends here (route time)
                    self.tracer.record(
                        "serve.queue", req.enqueued_at, self.clock(),
                        parent=req.trace,
                        attrs={"tenant": req.tenant,
                               "priority": req.priority},
                    )
                # with NOTHING routable the pop continues: queued
                # requests ride the degradation ladder (in _place)
                # instead of parking forever behind dead replicas
                self._place(req)
                worked = True
        return worked

    def _replica_for(
        self, key: GraphKey, live: List[ReplicaWorker]
    ) -> Optional[ReplicaWorker]:
        """Sticky → resident → least-occupied (module docstring)."""
        by_id = {r.replica_id: r for r in live}
        home = by_id.get(self._home.get(key))
        if home is not None and home.has_room():
            return home
        for r in live:
            if r.has_room() and r.has_graph(key):
                self._home[key] = r.replica_id
                return r
        cands = [r for r in live if r.has_room()] or live
        if not cands:
            return None
        target = min(
            cands, key=lambda r: (r.occupancy(), r.replica_id)
        )
        self._home[key] = target.replica_id
        return target

    def _place(
        self, req: ServeRequest,
        exclude: Optional[ReplicaWorker] = None,
    ) -> Optional[ReplicaWorker]:
        """Offer one (already-popped) request to a replica; called under
        the route lock.  A replica dying between the liveness check and
        the offer just retries; with nothing routable left, the request
        rides the degradation ladder instead of hanging."""
        for _ in range(len(self.replicas) + 1):
            live = [
                r for r in self.replicas
                if r.routable() and r is not exclude
            ]
            target = self._replica_for(req.graph_key, live)
            if target is None:
                break
            if target.offer(req):
                return target
            self._home.pop(req.graph_key, None)
        self.sink.degraded(req, detail="no_replica_available")
        return None

    # -- work-stealing rebalance ---------------------------------------------
    def redistribute(
        self,
        batch: List[ServeRequest],
        exclude: Optional[ReplicaWorker] = None,
        reason: str = "",
    ) -> None:
        """Re-place an already-formed batch (a replica refused it at the
        breaker gate) onto other replicas."""
        with self._route_lock:
            for req in batch:
                target = self._place(req, exclude=exclude)
                if target is not None and exclude is not None:
                    self.metrics.stolen(
                        exclude.replica_id, target.replica_id, 1
                    )
                    self._steal_span(req, exclude, target, reason)

    def rebalance_from(self, replica: ReplicaWorker, reason: str) -> int:
        """Steal a dead/open replica's work: staged requests re-place on
        survivors; a dead replica's in-flight batch is claimed (atomic,
        first-taker-wins) and fetched here — its results exist, only its
        owner died.  Returns how many requests were re-placed.  With
        stealing disabled the same requests ride the degradation ladder
        — answered-or-shed holds either way."""
        dead = not replica.alive()
        if dead:
            orphan = replica.take_inflight()
            if orphan is not None:
                # fetch through the victim's own guarded path: success
                # completes ok, failure degrades — never drops
                replica._fetch_guarded(orphan)
        stolen = replica.take_staged()
        if not stolen:
            return 0
        if not self.steal:
            for req in stolen:
                self.sink.degraded(
                    req, detail=f"replica_unavailable:{reason}"
                )
            return 0
        moved = 0
        with self._route_lock:
            self._home = {
                k: rid for k, rid in self._home.items()
                if rid != replica.replica_id
            }
            for req in stolen:
                target = self._place(req, exclude=replica)
                if target is not None:
                    self.metrics.stolen(
                        replica.replica_id, target.replica_id, 1
                    )
                    self._steal_span(req, replica, target, reason)
                    moved += 1
        return moved

    def _steal_span(
        self, req: ServeRequest, victim: ReplicaWorker,
        target: ReplicaWorker, reason: str,
    ) -> None:
        """A zero-duration steal marker on the request's OWN trace — a
        stolen request keeps its trace, and the marker names both ends
        of the move (the test asserts the trace stays connected through
        a kill)."""
        if self.tracer.enabled and req.trace is not None:
            self.tracer.event(
                "serve.steal", self.clock(), parent=req.trace,
                attrs={
                    "from_replica": victim.replica_id,
                    "to_replica": target.replica_id,
                    "reason": reason,
                },
            )

    # -- single-threaded iteration (fake-clock policy tests) -----------------
    def run_once(self, now: Optional[float] = None) -> bool:
        """One pool iteration: route, then one scheduling iteration per
        replica, with death → rebalance handled inline (the threaded
        path does the same from each worker's crash handler)."""
        if now is None:
            now = self.clock()
        worked = self.route_once(now)
        for r in self.replicas:
            if not r.alive():
                r.mark_dead()
                worked |= self.rebalance_from(r, "replica_death") > 0
                continue
            try:
                worked |= r.run_once(now)
            except Exception as exc:
                r.mark_dead(exc)
                self.rebalance_from(r, "replica_death")
                worked = True
        return worked
