"""ServeLoop: the continuous-batching serve worker (the port's copy of
``rca_tpu.serve.loop``).

One worker drives the whole scheduler: it sheds expired requests, drains
the fair queue into the shape-bucket batcher, dispatches ready batches,
and fetches the PREVIOUS batch only after the next one is already in
flight — the dispatch/fetch split applied to serving, so batch N's device
round trip hides behind batch N+1's host-side assembly.

Resilience contract:

- every request is completed EXACTLY once, whatever fails — the loop never
  lets an exception escape a scheduling iteration;
- a dispatch/fetch failure records the fault (bounded fault log), counts
  against a :class:`rca_tpu_torch.resilience.policy.CircuitBreaker`, and
  answers the batch with the LAST KNOWN ranking for that graph
  (``degraded``) or ``error`` when none exists — the response says so; a
  failure never falls back to the CPU or to the kernels' plain versions;
- an OPEN breaker answers immediately without touching the device (the
  degraded path is also the overload path: a broken device must not
  accumulate queue);
- deadline shedding happens at admission, in the queue, in the batcher and
  once more at batch formation — an expired request NEVER consumes a
  device slot.  A request whose deadline lapses only while its batch is in
  flight is still answered ``ok`` with ``deadline_missed`` set.

The loop body lives in :meth:`ServeLoop.run_once` so policy tests can
drive the scheduler single-threaded with a fake clock;
:meth:`ServeLoop.start` runs the same body on a daemon worker.  With
``recorder=`` every ``ok`` response writes one self-contained ``serve``
frame (the request's inputs and its ranking), which ``replay`` re-runs
solo.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.observability.spans import default_tracer
from rca_tpu_torch.resilience.policy import CircuitBreaker
from rca_tpu_torch.serve.dispatcher import BatchDispatcher
from rca_tpu_torch.serve.metrics import ServeMetrics
from rca_tpu_torch.serve.queue import RequestQueue
from rca_tpu_torch.serve.replica import (
    STAGE_AHEAD_BATCHES as _STAGE_AHEAD_BATCHES,
    CompletionSink,
    ReplicaWorker,
)
from rca_tpu_torch.serve.request import ServeRequest, ServeResponse
from rca_tpu_torch.util.threads import make_thread

#: idle park time when nothing is queued, staged, or in flight
_IDLE_WAIT_S = 0.05


def kernelscope_summary(monitor) -> dict:
    """Kernelscope's view of a serve plane (a loop or a pool): the
    monitor's recompile counts (a plan election or a kernel build repeated
    inside its window), one device-memory sample, the kernel registry's
    rows (which row served each shape) and the kernel set's source hash
    (the winner cache's invalidation key)."""
    from rca_tpu_torch.engine.registry import kernel_set_hash, kernel_table
    from rca_tpu_torch.observability.kernelscope import sample_device_memory

    out = dict(monitor.snapshot())
    out["device_memory"] = sample_device_memory() if out["enabled"] else None
    out["kernel_registry"] = kernel_table()
    out["kernel_set"] = kernel_set_hash()
    return out


class ServeLoop:
    """The single-replica serve plane: admission and the fair queue here,
    and one :class:`rca_tpu_torch.serve.replica.ReplicaWorker` (no pool)
    for the batcher and the breaker-guarded device path, so the loop and
    the pool's replicas run the same shed → batch → dispatch → fetch
    steps."""

    def __init__(
        self,
        engine=None,
        config: Optional[ServeConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_hook: Optional[Callable[[str], None]] = None,
        breaker: Optional[CircuitBreaker] = None,
        dispatcher: Optional[BatchDispatcher] = None,
        store=None,
        recorder=None,
        tracer=None,
        kernelscope: Optional[bool] = None,
    ):
        self.config = config or ServeConfig.from_env()
        self.clock = clock
        # kernelscope: the serve plane's recompile watchdog, its window
        # opened by start(); ``kernelscope=None`` follows RCA_KERNELSCOPE
        from rca_tpu_torch.observability.kernelscope import RecompileMonitor

        self.recompile_monitor = RecompileMonitor(enabled=kernelscope)
        # tracing: admission mints each request's root context; the loop
        # records queue spans, the worker batch/dispatch/fetch spans; the
        # sink closes the root
        self.tracer = tracer if tracer is not None else default_tracer()
        self.queue = RequestQueue(self.config.queue_cap, clock=clock)
        self.metrics = ServeMetrics()
        dispatcher = dispatcher or BatchDispatcher(
            engine, fault_hook=fault_hook, metrics=self.metrics,
        )
        # an externally-built BatchDispatcher joins the loop's metrics
        # unless it already has its own; stub dispatchers without the
        # attribute are left alone
        if getattr(dispatcher, "metrics", "absent") is None:
            dispatcher.metrics = self.metrics
        # response delivery is shared with the serve pool: the sink owns
        # the last-known ladder and the exactly-once accounting
        # the optional investigation store: an ok response naming an
        # investigation appends a serve note there (the store's fcntl
        # locking makes that safe from the worker thread)
        self.store = store
        self.sink = CompletionSink(self.metrics, clock, tracer=self.tracer,
                                   store=store, recorder=recorder)
        self.worker = ReplicaWorker(
            0, config=self.config, clock=clock, sink=self.sink,
            metrics=self.metrics, dispatcher=dispatcher, queue=self.queue,
            device=getattr(getattr(dispatcher, "engine", None), "device",
                           None),
            breaker=breaker or CircuitBreaker(
                failure_threshold=3, reset_after=1.0, clock=clock,
                name="serve.dispatch",
            ),
            tracer=self.tracer, name="serve",
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.recorder = recorder
        if recorder is not None:
            engine = getattr(self.dispatcher, "engine", None)
            recorder.begin_session({
                "engine": type(engine).__name__,
                "device": str(getattr(engine, "device", None)),
                "max_batch": self.config.max_batch,
                "max_wait_us": self.config.max_wait_us,
                "queue_cap": self.config.queue_cap,
            })

    @property
    def dispatcher(self) -> BatchDispatcher:
        return self.worker.dispatcher

    @property
    def batcher(self):
        return self.worker.batcher

    @property
    def breaker(self) -> CircuitBreaker:
        return self.worker.breaker

    @property
    def device_batches(self) -> int:
        """Batches actually dispatched to the device."""
        return self.worker.device_batches

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServeLoop":
        if self._thread is None or not self._thread.is_alive():
            self.recompile_monitor.start()
            self._stop.clear()
            self._thread = make_thread(
                self._run, name="rca-serve", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self.queue.kick()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.recompile_monitor.stop()

    @property
    def stopped(self) -> bool:
        """Whether :meth:`stop` was called (a loop never started is not
        stopped: requests queued on it wait for :meth:`start`)."""
        return self._stop.is_set()

    def kernelscope_summary(self) -> dict:
        """See :func:`kernelscope_summary`."""
        return kernelscope_summary(self.recompile_monitor)

    def __enter__(self) -> "ServeLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def engine(self):
        return self.dispatcher.engine

    # -- admission -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> bool:
        """Admit one request.  Returns whether it was QUEUED; either way
        the request will be completed (``queue_full``/``shed`` responses
        are delivered synchronously here), so ``req.result()`` always
        terminates."""
        now = self.clock()
        if self.tracer.enabled and req.trace is None:
            req.trace = self.tracer.new_context(parent=req.trace_parent)
        if req.expired(now):
            # dead on arrival: shed at admission, never queued
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

    # -- scheduling iteration ------------------------------------------------
    def run_once(self) -> bool:
        """One scheduler iteration (shed → stage → the worker's dispatch
        and fetch of the previous batch).  Returns whether any work
        happened — the worker thread parks when none did.  Exposed for
        single-threaded policy tests."""
        now = self.clock()
        worked = False
        for req in self.queue.shed_expired(now):
            self.sink.shed(req, detail="expired_in_queue")
            worked = True
        # stage ahead of the device, but boundedly: the queue keeps
        # backpressure accounting while the batcher only holds what the
        # next few dispatches can consume
        stage_cap = self.config.max_batch * _STAGE_AHEAD_BATCHES
        while self.batcher.staged() < stage_cap:
            req = self.queue.pop()
            if req is None:
                break
            if self.tracer.enabled and req.trace is not None:
                self.tracer.record(
                    "serve.queue", req.enqueued_at, now,
                    parent=req.trace,
                    attrs={"tenant": req.tenant,
                           "priority": req.priority},
                )
            self.worker.offer(req)
            worked = True
        return self.worker.run_once(now) or worked

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.run_once():
                timeout = self.batcher.next_ready_in() or _IDLE_WAIT_S
                self.queue.wait_for_work(min(timeout, _IDLE_WAIT_S))
        self._shutdown_drain()

    def _shutdown_drain(self) -> None:
        """Complete everything still in the system: the in-flight batch
        fetches normally (results exist), everything else errors out —
        a stopped loop must not leave submitters parked forever."""
        self.worker.drain_inflight()
        pending: List[ServeRequest] = []
        while True:
            req = self.queue.pop()
            if req is None:
                break
            pending.append(req)
        pending.extend(self.worker.take_staged())
        for req in pending:
            self.sink.error(req, "serve loop stopped")
