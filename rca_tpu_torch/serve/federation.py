"""Cross-process serve federation: the control plane (the port's copy of
``rca_tpu.serve.federation``).

The serve pool is N replica threads in ONE process: a single process
death takes the whole plane down.  :class:`FederationPlane` closes that
gap: it supervises N worker PROCESSES (each running a full
:class:`rca_tpu_torch.serve.loop.ServeLoop` or
:class:`rca_tpu_torch.serve.pool.ServePool` on its own device, with its
own CUDA context and kernel library, bootstrapped through
:mod:`rca_tpu_torch.parallel.distributed`), connected over the
length-prefixed wire protocol in :mod:`rca_tpu_torch.serve.fedwire`.
The plane's ``device`` goes to every worker it spawns (``--device``);
the coordinator itself never touches the card.

**Liveness is a lease, not a socket.**  Each worker's hello is answered
with a lease (``ttl = heartbeat_s × lease_misses``); every heartbeat
renews it.  One late heartbeat never kills a worker; ``lease_misses``
consecutive misses expire the lease and the worker is marked dead even
if its socket is still open, which is exactly the ``worker_hang``
failure (a wedged process holds its fds).  A worker whose process dies
outright (``process_kill``) is detected faster, at socket EOF.  A
worker presenting a STALE lease (it hung, was declared dead, then woke
up) is rejected and must re-hello for a fresh lease: the rejoin path.
Time the coordinator itself stalled (its lease monitor woke late) is
credited to every lease: the heartbeats sent meanwhile sit unread in its
sockets, so the stall is not its workers' silence.

**Exactly-once across process death.**  Every routed request lives in
the coordinator's pending table, keyed by request id and OWNED by one
worker.  On worker death the entries it owned are reclaimed and
re-placed on survivors (drain-and-reroute); a late answer from the dead
worker no longer matches the owner and is dropped as a STALE response,
counted in ``stale_responses``, never delivered.  Delivery itself goes
through the pool's :class:`rca_tpu_torch.serve.replica.CompletionSink`,
so ``double_completions`` stays 0 by construction.

**Routing is consistent hashing on the graph digest** (rendezvous /
highest-random-weight): a graph key maps to the same worker wherever it
is submitted, so hot graphs keep their resident delta path across
processes; when one of N workers dies, ONLY the keys it owned move
(bounded handoff).  Stickiness is best-effort: past the per-worker
outstanding window (``RCA_FED_WINDOW``) a request spills to the next
worker on its ring so one hot bucket cannot wedge the plane behind one
process.  Placement is shape-aware on top of rendezvous: hello frames
carry each worker's kernel-registry and device-memory summaries, and for
graph buckets that ``PLACEMENT_RULES`` marks as informed-routable the
router prefers the worker with the winning per-shape timing (headroom as
the tie-break), falling back to pure rendezvous order when nobody has
data.  ``advertise_host`` separates the bind address from the address
spawned/external workers dial (the multi-host deploy seam).

**Ingest workers** (``role: "ingest"``) join a ring of their own and own
cluster capture mirrors; the cluster table here is the exactly-once
arbiter of their capture ticks (:mod:`rca_tpu_torch.serve.ingest`).

Retirement goes through :meth:`FederationPlane.drain_worker`: the worker
leaves the ring first, finishes its in-flight work, answers
``drained``, and only then is its process terminated, so a retirement is
invisible to the exactly-once contract (and never counted as a fault).
The autoscaler's controller (:class:`rca_tpu_torch.serve.autoscale.
AutoscaleController`) drives it, and registers itself as ``autoscaler``
so ``/healthz`` reports the elastic state.

Concurrency: all threads named via :mod:`rca_tpu_torch.util.threads`;
``FederationPlane._lock`` guards the worker table, ring, and pending map
and is never held across a socket write that can block long (sends are
to local buffers; the frame lock inside :class:`FrameConn` is a leaf).
Lock order: ``FederationPlane._lock`` → ``FrameConn._wlock``;
``CompletionSink._lock`` / ``ServeMetrics._lock`` are leaves.  Timing
goes through the injectable ``clock`` seam.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import os
import socket
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from rca_tpu_torch.config import (
    ServeConfig,
    fed_heartbeat_s,
    fed_lease_misses,
    fed_window,
    fed_workers,
)
from rca_tpu_torch.observability.spans import default_tracer
from rca_tpu_torch.serve.autoscale import PLACEMENT_RULES, shape_tier_ms
from rca_tpu_torch.serve.fedwire import (
    FrameConn,
    FrameError,
    PROTO,
    WireResult,
    encode_request,
)
from rca_tpu_torch.serve.queue import RequestQueue
from rca_tpu_torch.serve.replica import CompletionSink
from rca_tpu_torch.serve.request import ServeRequest, ServeResponse
from rca_tpu_torch.serve.metrics import ServeMetrics
from rca_tpu_torch.util.net import bound_address, make_server_socket
from rca_tpu_torch.util.threads import make_lock, spawn

#: the federation's fault classes — what the chaos gate must observe
FED_FAULT_CLASSES = ("process_kill", "worker_hang", "coordinator_partition")

#: the ingest-fleet fault class: an ingest worker's death; its cluster
#: mirrors move to rendezvous survivors with a fresh ownership epoch,
#: and the dead owner's in-flight tick stats are dropped as epoch-stale
#: (never double-applied)
INGEST_FAULT_CLASS = "ingest_death"

#: router idle park while nothing is queued / routable
_ROUTE_IDLE_S = 0.02

#: events kept for observability (oldest dropped)
_EVENT_CAP = 512


# ---------------------------------------------------------------------------
# Lease-based liveness
# ---------------------------------------------------------------------------


class Lease:
    """One worker's liveness lease: granted at hello, renewed by every
    heartbeat, expired after ``ttl_s`` without one."""

    __slots__ = ("lease_id", "worker_id", "granted_at", "renewed_at",
                 "ttl_s", "renewals")

    def __init__(self, worker_id: int, now: float, ttl_s: float,
                 lease_id: Optional[str] = None):
        self.lease_id = lease_id or uuid.uuid4().hex[:16]
        self.worker_id = int(worker_id)
        self.granted_at = now
        self.renewed_at = now
        self.ttl_s = float(ttl_s)
        self.renewals = 0

    def expires_at(self) -> float:
        return self.renewed_at + self.ttl_s

    def expired(self, now: float) -> bool:
        return now >= self.expires_at()


class LeaseTable:
    """The liveness source of truth, on an injectable clock.

    ``ttl_s = heartbeat_s × lease_misses``: missing ONE heartbeat keeps
    a worker alive (the miss-one-keep-alive property the tests pin);
    missing ``lease_misses`` in a row expires it.  A renewal carrying a
    lease id that is not the CURRENT lease for that worker — the worker
    was declared dead and a fresh lease was (or will be) minted — is
    refused: the holder must re-hello, which is what makes a recovered
    hung worker's rejoin explicit instead of a silent resurrection."""

    def __init__(self, heartbeat_s: float, lease_misses: int,
                 clock: Callable[[], float] = time.monotonic):
        if heartbeat_s <= 0:
            raise ValueError(f"heartbeat_s must be > 0, got {heartbeat_s}")
        if lease_misses < 2:
            raise ValueError(
                f"lease_misses must be >= 2 (one late heartbeat must "
                f"never kill a worker), got {lease_misses}"
            )
        self.heartbeat_s = float(heartbeat_s)
        self.ttl_s = float(heartbeat_s) * int(lease_misses)
        self.clock = clock
        self._lock = make_lock("LeaseTable._lock")
        self._leases: Dict[int, Lease] = {}

    def grant(self, worker_id: int, now: Optional[float] = None) -> Lease:
        """A FRESH lease (any previous lease for this worker becomes
        stale the moment this one exists)."""
        if now is None:
            now = self.clock()
        lease = Lease(worker_id, now, self.ttl_s)
        with self._lock:
            self._leases[int(worker_id)] = lease
        return lease

    def renew(self, worker_id: int, lease_id: str,
              now: Optional[float] = None) -> bool:
        """Heartbeat renewal; False when the lease is stale (not the
        current one), unknown, or already expired — the worker must
        re-hello."""
        if now is None:
            now = self.clock()
        with self._lock:
            lease = self._leases.get(int(worker_id))
            if (lease is None or lease.lease_id != lease_id
                    or lease.expired(now)):
                return False
            lease.renewed_at = now
            lease.renewals += 1
            return True

    def alive(self, worker_id: int, now: Optional[float] = None) -> bool:
        if now is None:
            now = self.clock()
        with self._lock:
            lease = self._leases.get(int(worker_id))
            return lease is not None and not lease.expired(now)

    def expired_workers(
        self, now: Optional[float] = None
    ) -> List[Tuple[int, float]]:
        """``(worker_id, overdue_s)`` for every held lease past its TTL
        (``overdue_s`` is the detection lag the chaos report reads)."""
        if now is None:
            now = self.clock()
        with self._lock:
            return [
                (wid, now - lease.expires_at())
                for wid, lease in self._leases.items()
                if lease.expired(now)
            ]

    def revoke(self, worker_id: int) -> None:
        with self._lock:
            self._leases.pop(int(worker_id), None)

    def credit(self, seconds: float) -> None:
        """Push every held lease's expiry ``seconds`` later: time the
        coordinator could not observe (a stall of its own process) is
        not its workers' silence."""
        with self._lock:
            for lease in self._leases.values():
                lease.renewed_at += seconds


# ---------------------------------------------------------------------------
# Consistent-hash routing (rendezvous)
# ---------------------------------------------------------------------------


class HashRing:
    """Rendezvous (highest-random-weight) hashing over worker ids.

    Chosen over a vnode ring for its EXACT remap property: when a node
    leaves, the only keys that move are the keys it owned (survivors'
    keys never reshuffle), which is the bounded-handoff contract the
    resident delta path depends on (a surviving worker's hot graphs
    stay hot through any topology change)."""

    def __init__(self) -> None:
        self._nodes: Tuple[int, ...] = ()

    def add(self, node: int) -> None:
        if int(node) not in self._nodes:
            self._nodes = tuple(sorted(self._nodes + (int(node),)))

    def remove(self, node: int) -> None:
        self._nodes = tuple(n for n in self._nodes if n != int(node))

    @property
    def nodes(self) -> Tuple[int, ...]:
        return self._nodes

    @staticmethod
    def _score(node: int, key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(f"{node}|{key}".encode("utf-8")).digest()[:8],
            "big",
        )

    def ranked(self, key: str) -> List[int]:
        """All nodes, preference order for ``key`` (owner first; the
        tail is the deterministic spill order under saturation)."""
        return sorted(
            self._nodes, key=lambda n: self._score(n, key), reverse=True
        )

    def owner(self, key: str) -> Optional[int]:
        ranked = self.ranked(key)
        return ranked[0] if ranked else None


def graph_route_key(graph_key: Tuple) -> str:
    """The routing key for a request's shape bucket: the graph identity
    tuple, digest included: the same identity the dispatcher's
    prepared-graph cache is keyed by, so ring ownership and resident
    stickiness agree by construction."""
    return "/".join(str(p) for p in graph_key)


# ---------------------------------------------------------------------------
# Worker handles
# ---------------------------------------------------------------------------


def _parse_shape_summary(registry: Any) -> Dict[int, float]:
    """A hello frame's ``registry`` summary → ``{n_pad: winner_ms}``.
    Hellos from fresh workers (or fakes) omit it; malformed entries are
    dropped, never fatal: placement is an optimization, not a
    dependency."""
    out: Dict[int, float] = {}
    if not isinstance(registry, dict):
        return out
    for n_pad, t_ms in registry.items():
        try:
            key, val = int(n_pad), float(t_ms)
        except (TypeError, ValueError):
            continue
        if key > 0 and val >= 0.0:
            out[key] = val
    return out


def _parse_headroom(headroom: Any) -> Optional[int]:
    """A hello frame's ``headroom`` summary → device ``bytes_in_use``
    (LOWER = more headroom), or None when absent/malformed."""
    if not isinstance(headroom, dict):
        return None
    try:
        return int(headroom.get("bytes_in_use"))
    except (TypeError, ValueError):
        return None


class _WorkerHandle:
    """Coordinator-side state for one worker (connection + lease +
    outstanding accounting).  Mutated only under FederationPlane._lock
    except the FrameConn (its own write lock) and plain reads."""

    def __init__(self, worker_id: int):
        self.worker_id = int(worker_id)
        self.conn: Optional[FrameConn] = None
        self.lease: Optional[Lease] = None
        self.live = False
        self.proc = None                  # util.procs.WorkerProc | None
        self.hello: Dict[str, Any] = {}
        self.outstanding = 0
        self.partitioned_until = 0.0
        self.partition_dropped = 0
        self.served = 0
        self.state = "connecting"
        # retirement and placement state.  ``draining`` marks
        # an intentional retirement in progress (the worker is off the
        # ring, not routable, and its eventual EOF is NOT a fault);
        # ``shape_ms``/``mem_bytes`` are the hello frame's registry and
        # headroom summaries the placement rules read.
        self.draining = False
        self.shape_ms: Dict[int, float] = {}     # n_pad -> winner ms
        self.mem_bytes: Optional[int] = None
        # worker class from the hello frame: "serve" workers join the
        # serve ring, "ingest" workers join the ingest ring and own
        # cluster capture mirrors instead
        self.role = "serve"
        # heartbeat timing, worst case over the worker's life: the
        # longest gap between two heartbeats of one lease the worker
        # SENT (its own clock), between two it was read HERE, and from
        # a send to its reading (clocks comparable only on one host:
        # ``time.monotonic`` is system-wide there).  A lease that
        # expires under load says which side fell behind.
        self.hb_last_sent: Optional[float] = None
        self.hb_last_recv: Optional[float] = None
        self.hb_send_gap_max_s = 0.0
        self.hb_recv_gap_max_s = 0.0
        self.hb_lag_max_s = 0.0
        # a process this plane spawned that has not said hello yet: the
        # autoscaler counts it as capacity on its way
        self.awaiting_hello = False
        # this plane SIGKILLed the worker's process (the chaos seam): its
        # down is a process_kill even when the lease expires before the
        # socket's EOF arrives
        self.killed = False

    def note_heartbeat(self, sent_at: Optional[float], now: float) -> None:
        """Fold one heartbeat read at ``now`` into the timing maxima."""
        if self.hb_last_recv is not None:
            self.hb_recv_gap_max_s = max(self.hb_recv_gap_max_s,
                                         now - self.hb_last_recv)
        self.hb_last_recv = now
        if sent_at is None:
            return
        if self.hb_last_sent is not None:
            self.hb_send_gap_max_s = max(self.hb_send_gap_max_s,
                                         sent_at - self.hb_last_sent)
        self.hb_last_sent = sent_at
        self.hb_lag_max_s = max(self.hb_lag_max_s, now - sent_at)

    def summary(self) -> Dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "role": self.role,
            "state": self.state,
            "live": self.live,
            "draining": self.draining,
            "outstanding": self.outstanding,
            "served": self.served,
            "pid": self.hello.get("pid"),
            "engine": self.hello.get("engine"),
            "lease_renewals": (
                self.lease.renewals if self.lease is not None else 0
            ),
            "shapes_known": len(self.shape_ms),
            "mem_bytes": self.mem_bytes,
            "hb_send_gap_max_s": self.hb_send_gap_max_s,
            "hb_recv_gap_max_s": self.hb_recv_gap_max_s,
            "hb_lag_max_s": self.hb_lag_max_s,
        }


class _Pending:
    __slots__ = ("req", "worker_id", "sent_at", "moves")

    def __init__(self, req: ServeRequest, worker_id: int, sent_at: float):
        self.req = req
        self.worker_id = worker_id
        self.sent_at = sent_at
        self.moves = 0


# ---------------------------------------------------------------------------
# The control plane
# ---------------------------------------------------------------------------


class FederationPlane:
    """Coordinator for N worker processes behind one admission queue.

    Presents the same surface the gateway and ``ServeClient`` expect of
    a serving plane (``submit`` / ``clock`` / ``metrics`` / ``queue`` /
    ``start`` / ``stop``), so ``GatewayServer(plane)`` is the TLS+authn
    front door over a whole fleet.

    ``workers``: how many processes to spawn (via the
    :mod:`rca_tpu_torch.util.procs` seam; each runs ``python -m
    rca_tpu_torch.serve.worker`` connected back here, on ``device``:
    the card unless ``device="cpu"``).  ``worker_env`` overlays the
    inherited environment of every spawned worker.
    ``spawn_workers=False`` opens the control port without spawning:
    tests connect their own (fake or real) workers, and external
    workers on other hosts join the same way."""

    def __init__(
        self,
        workers: Optional[int] = None,
        config: Optional[ServeConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_s: Optional[float] = None,
        lease_misses: Optional[int] = None,
        window: Optional[int] = None,
        spawn_workers: bool = True,
        worker_env: Optional[Dict[str, str]] = None,
        store=None,
        tracer=None,
        steal: Optional[bool] = None,
        advertise_host: Optional[str] = None,
        device=None,
    ):
        self.config = config or ServeConfig.from_env()
        self.clock = clock
        self.n_workers = int(workers) if workers is not None else fed_workers()
        self.heartbeat_s = (
            float(heartbeat_s) if heartbeat_s is not None
            else fed_heartbeat_s()
        )
        self.lease_misses = (
            int(lease_misses) if lease_misses is not None
            else fed_lease_misses()
        )
        self.window = int(window) if window is not None else fed_window()
        self.steal = bool(self.config.steal if steal is None else steal)
        self.spawn_workers = bool(spawn_workers)
        self.worker_env = worker_env
        self.device = None if device is None else str(device)
        self.tracer = tracer if tracer is not None else default_tracer()
        self.metrics = ServeMetrics()
        self.queue = RequestQueue(self.config.queue_cap, clock=clock)
        self.sink = CompletionSink(
            self.metrics, clock, store=store, tracer=self.tracer,
        )
        self.leases = LeaseTable(
            self.heartbeat_s, self.lease_misses, clock=clock
        )
        self.ring = HashRing()
        # the ingest worker class: cluster capture mirrors are
        # rendezvous-routed over THIS ring (``cid:digest`` keys), one
        # owner per cluster; the cluster table is the coordinator-side
        # exactly-once arbiter for capture ticks (epoch-stale and
        # replayed tick stats are dropped, counted)
        self.ingest_ring = HashRing()
        self.clusters: Dict[str, Dict[str, Any]] = {}
        self.ingest_stale = 0
        self._lock = make_lock("FederationPlane._lock")
        self.workers: Dict[int, _WorkerHandle] = {}
        self._pending: Dict[str, _Pending] = {}
        self._overflow: "collections.deque[ServeRequest]" = (
            collections.deque()
        )
        self.events: List[Dict[str, Any]] = []
        self.stale_responses = 0
        self.reroutes = 0
        # the longest the lease monitor's sweep came late (seconds): a
        # stall of this process, credited to every lease
        self.stall_max_s = 0.0
        self._conn_counter = itertools.count()
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._threads: List[threading.Thread] = []
        sock = make_server_socket("federation", host, port)
        self.host, self.port = bound_address(sock)
        self._server_sock = sock
        # multi-host: the address workers DIAL may differ from the bind
        # address (bind 0.0.0.0, advertise the host's reachable IP); an
        # attached autoscale controller registers itself here so
        # /healthz can report the elastic state
        self.advertise_host = advertise_host
        self.autoscaler = None

    # -- introspection --------------------------------------------------------
    @property
    def address(self) -> str:
        host = self.advertise_host if self.advertise_host else self.host
        return f"{host}:{self.port}"

    def live_workers(self) -> List[int]:
        with self._lock:
            return [w.worker_id for w in self.workers.values() if w.live]

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending) + len(self._overflow)

    def worker_table(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                self.workers[wid].summary()
                for wid in sorted(self.workers)
            ]

    def _event(self, kind: str, worker_id: Optional[int] = None,
               **extra: Any) -> None:
        with self._lock:
            self.events.append({
                "event": kind, "worker_id": worker_id,
                "t": self.clock(), **extra,
            })
            while len(self.events) > _EVENT_CAP:
                self.events.pop(0)

    def fault_classes_observed(self) -> List[str]:
        with self._lock:
            return sorted({
                e["class"] for e in self.events
                if e["event"] == "worker_down" and e.get("class")
            })

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FederationPlane":
        self._stop.clear()
        self._threads = [
            spawn(self._accept_loop, name="rca-fed-accept", daemon=True),
            spawn(self._route_loop, name="rca-fed-route", daemon=True),
            spawn(self._monitor_loop, name="rca-fed-monitor", daemon=True),
        ]
        if self.spawn_workers:
            for i in range(self.n_workers):
                self.spawn_worker(i)
        return self

    def spawn_worker(self, worker_id: int, role: str = "serve"):
        """Spawn (or respawn) one worker process through the procs seam;
        it connects back to the control port and hellos.  ``role``
        selects the worker class (``"ingest"`` spawns a cluster-capture
        worker that joins the ingest ring instead of the serve ring)."""
        from rca_tpu_torch.config import environ_copy
        from rca_tpu_torch.util.procs import python_argv, spawn_worker

        env = environ_copy()
        if self.worker_env:
            env.update(self.worker_env)
        # the worker imports the very package this coordinator runs,
        # wherever the coordinator was started from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        args = [
            "--connect", self.address,
            "--worker-id", str(worker_id),
        ]
        if role != "serve":
            args += ["--role", str(role)]
        if self.device is not None:
            args += ["--device", self.device]
        proc = spawn_worker(
            f"fed-worker{worker_id}",
            python_argv("rca_tpu_torch.serve.worker", *args),
            env=env,
        )
        with self._lock:
            handle = self.workers.setdefault(
                int(worker_id), _WorkerHandle(worker_id)
            )
            handle.proc = proc
            handle.role = str(role)
            handle.awaiting_hello = True
        self._event("worker_spawned", worker_id, pid=proc.pid)
        return proc

    def wait_ready(self, n: Optional[int] = None,
                   timeout_s: float = 60.0) -> bool:
        """Block until ``n`` (default: all spawned) workers hold leases.
        False on timeout — callers decide whether a partial fleet is a
        failure (selftest) or a degraded start (demo)."""
        want = int(n) if n is not None else self.n_workers
        deadline = self.clock() + timeout_s
        while self.clock() < deadline:
            if len(self.live_workers()) >= want:
                return True
            if self._stop.wait(0.05):
                return False
        return len(self.live_workers()) >= want

    def stop(self, timeout: float = 15.0) -> None:
        deadline = self.clock() + timeout
        # drain: workers finish in flight, answer, and exit
        with self._lock:
            conns = [
                w.conn for w in self.workers.values()
                if w.live and w.conn is not None
            ]
        for conn in conns:
            conn.send({"t": "drain"})
        while self.pending_count() > 0 and self.clock() < deadline:
            if self._stop.wait(0.02):
                break
        self._stop.set()
        self.queue.kick()
        # complete everything still in the system — a stopped plane must
        # not leave submitters parked
        with self._lock:
            leftovers = [p.req for p in self._pending.values()]
            self._pending.clear()
            leftovers.extend(self._overflow)
            self._overflow.clear()
        while True:
            with self._lock:
                req = self.queue.pop()
            if req is None:
                break
            leftovers.append(req)
        for req in leftovers:
            self.sink.error(req, "federation stopped")
        with self._lock:
            handles = list(self.workers.values())
        for w in handles:
            if w.conn is not None:
                w.conn.close()
            if w.proc is not None:
                w.proc.terminate(grace_s=3.0)
        try:
            # shutdown first: a bare close does not wake the accept
            # thread parked in accept(), whose join would then time out
            self._server_sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server_sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(5.0)
        self._threads = []

    def __enter__(self) -> "FederationPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission (ServeLoop/ServePool submit contract) ----------------------
    def submit(self, req: ServeRequest) -> bool:
        now = self.clock()
        if self.tracer.enabled and req.trace is None:
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

    # -- chaos seams ----------------------------------------------------------
    def kill_worker(self, worker_id: int) -> bool:
        """SIGKILL one worker process (the ``process_kill`` fault; procs
        seam).  For fake/externally-connected workers the connection is
        severed instead — same failure shape at this layer."""
        with self._lock:
            w = self.workers.get(int(worker_id))
            proc = w.proc if w is not None else None
            conn = w.conn if w is not None else None
            if proc is not None:
                w.killed = True
        if proc is not None:
            proc.kill()
            return True
        if conn is not None:
            conn.close()
            return True
        return False

    def hang_worker(self, worker_id: int, for_s: float) -> bool:
        """Tell one worker to stop heartbeating for ``for_s`` seconds
        while keeping its socket open — the ``worker_hang`` fault."""
        with self._lock:
            w = self.workers.get(int(worker_id))
            conn = w.conn if w is not None and w.live else None
        return conn is not None and conn.send(
            {"t": "hang", "for_s": float(for_s)}
        )

    def partition(self, worker_id: int, for_s: float) -> bool:
        """Drop every frame from (and ack to) one worker for ``for_s``
        seconds — the ``coordinator_partition`` fault: both sides are
        healthy, the control channel is not."""
        now = self.clock()
        with self._lock:
            w = self.workers.get(int(worker_id))
            if w is None:
                return False
            w.partitioned_until = now + float(for_s)
        self._event("partition_start", worker_id, for_s=float(for_s))
        return True

    # -- retirement (drain-and-retire) -----------------------------------------
    def drain_worker(self, worker_id: int) -> bool:
        """Begin one worker's intentional retirement: off the ring first
        (no new routes), then a ``drain`` frame — the worker finishes
        its in-flight work, answers ``drained``, and
        :meth:`_scaledown_complete` retires it.  False when the worker
        is not live (or already draining)."""
        with self._lock:
            w = self.workers.get(int(worker_id))
            if w is None or not w.live or w.draining or w.conn is None:
                return False
            w.draining = True
            w.state = "draining"
            self.ring.remove(worker_id)
            conn = w.conn
        self._event("drain_started", worker_id)
        if not conn.send({"t": "drain"}):
            # died before the frame landed: the conn loop's EOF path
            # handles it as a fault; nothing to retire politely here
            return True
        return True

    def drain_all(self, timeout_s: float = 60.0) -> Dict[int, Dict[str, Any]]:
        """Retire every routable worker through :meth:`drain_worker` and
        wait for each one's ``drained`` report (its ``worker_drained``
        event: ``served`` and, from a port worker, its kernel launch
        counters, device batches and registry rows).  Returns the reports
        by worker id; a worker that has not answered within ``timeout_s``
        is missing from them."""
        t0 = self.clock()
        with self._lock:
            wids = sorted(w.worker_id for w in self.workers.values()
                          if w.live and not w.draining)
        started = [wid for wid in wids if self.drain_worker(wid)]
        reports: Dict[int, Dict[str, Any]] = {}
        deadline = t0 + timeout_s
        while True:
            with self._lock:
                for e in self.events:
                    if (e["event"] == "worker_drained" and e["t"] >= t0
                            and e["worker_id"] in started):
                        reports[e["worker_id"]] = {
                            k: v for k, v in e.items()
                            if k not in ("event", "worker_id", "t")}
            if len(reports) == len(started) or self.clock() >= deadline:
                return reports
            if self._stop.wait(0.02):
                return reports

    def _scaledown_complete(self, w: _WorkerHandle) -> None:
        """Finish one intentional retirement (the ``drained`` ack).
        ``live`` drops FIRST, so the socket EOF (and the monitor's
        dead-proc sweep) that follow hit :meth:`_worker_down`'s
        not-live early-return — a scale-down must never be counted as a
        ``process_kill``.  Anything still pending on the worker (a race
        with the router) reroutes through overflow."""
        with self._lock:
            if not w.live:
                return
            w.live = False
            w.draining = False
            w.state = "drained"
            self.ring.remove(w.worker_id)
            reclaimed = [
                p for p in self._pending.values()
                if p.worker_id == w.worker_id
            ]
            for p in reclaimed:
                del self._pending[p.req.request_id]
            w.outstanding = 0
            proc = w.proc
            for p in reclaimed:
                p.moves += 1
                self.reroutes += 1
                self._overflow.append(p.req)
        self.leases.revoke(w.worker_id)
        self._event("worker_scaled_down", w.worker_id,
                    rerouted=len(reclaimed))
        if proc is not None:
            proc.terminate(grace_s=3.0)
        self.queue.kick()

    def scale_status(self) -> Dict[str, Any]:
        """The fleet in one lock acquisition (what the autoscaler's
        controller reads): routable workers, retirements in progress, the
        serve processes spawned here that have not said hello yet (alive:
        capacity on its way), the per-worker outstanding map (the
        scale-down victim policy), and the next NEVER-REUSED worker id
        (reusing a retired id would alias its late, stale responses onto
        a fresh worker)."""
        with self._lock:
            live = sorted(
                w.worker_id for w in self.workers.values()
                if w.live and not w.draining
            )
            draining = sorted(
                w.worker_id for w in self.workers.values()
                if w.live and w.draining
            )
            spawning = sorted(
                w.worker_id for w in self.workers.values()
                if w.awaiting_hello and w.role == "serve"
                and w.proc is not None and w.proc.alive()
            )
            outstanding = {
                w.worker_id: w.outstanding
                for w in self.workers.values() if w.live
            }
            next_id = max(self.workers) + 1 if self.workers else 0
        return {
            "live": live, "draining": draining, "spawning": spawning,
            "outstanding": outstanding, "next_id": next_id,
        }

    # -- connection handling --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._server_sock.accept()
            except OSError:
                return   # socket closed = shutdown
            conn = FrameConn(client, name="fed-coord")
            spawn(
                self._conn_loop,
                name=f"rca-fed-conn{next(self._conn_counter)}",
                daemon=True, args=(conn,),
            )

    def _register(self, conn: FrameConn,
                  hello: Dict[str, Any]) -> Optional[_WorkerHandle]:
        """Handle one hello: proto + lease staleness checks, then grant.
        Returns the registered handle, or None when rejected."""
        if int(hello.get("proto", -1)) != PROTO:
            conn.send({"t": "reject", "reason": "bad_proto"})
            return None
        worker_id = int(hello.get("worker_id", -1))
        if worker_id < 0:
            conn.send({"t": "reject", "reason": "bad_worker_id"})
            return None
        presented = hello.get("lease_id")
        if presented is not None and not self.leases.renew(
            worker_id, presented
        ):
            # rejoin with a stale lease: refused — the worker re-hellos
            # WITHOUT a lease and gets a fresh grant (tested)
            self._event("stale_lease_rejected", worker_id)
            conn.send({"t": "reject", "reason": "stale_lease",
                       "lease_id": str(presented)})
            return None
        lease = self.leases.grant(worker_id)
        with self._lock:
            w = self.workers.setdefault(worker_id, _WorkerHandle(worker_id))
            # a rejoin is any hello from a worker that held a lease
            # before — whether on a fresh connection (restart) or the
            # SAME one (a hung/partitioned worker whose stale lease was
            # just rejected)
            rejoin = w.lease is not None
            old_conn = (
                w.conn if (w.conn is not None and w.conn is not conn)
                else None
            )
            w.conn = conn
            w.lease = lease
            w.hello = dict(hello)
            w.live = True
            w.awaiting_hello = False
            w.partitioned_until = 0.0
            w.hb_last_sent = w.hb_last_recv = None   # a fresh lease
            # a hello on a NEW connection is a new process: any drain
            # sent to the old one died with its socket, so this worker
            # is volunteering back in.  On the SAME connection (a hung/
            # partitioned worker re-helloing past a stale lease) a
            # drain already sent is still in that process's inbox —
            # KEEP the draining intent, or a stale-heartbeat re-hello
            # racing a scale-down wipes it and the retirement never
            # completes (a rejoin racing a drain)
            if old_conn is not None:
                w.draining = False
            w.state = "draining" if w.draining else "live"
            w.shape_ms = _parse_shape_summary(hello.get("registry"))
            w.mem_bytes = _parse_headroom(hello.get("headroom"))
            w.role = str(hello.get("role") or "serve")
            if not w.draining:
                # worker class decides the ring: ingest workers own
                # cluster mirrors, never serve traffic
                (self.ingest_ring if w.role == "ingest"
                 else self.ring).add(worker_id)
        if old_conn is not None:
            old_conn.close()
        self._event("rejoin" if rejoin else "worker_joined", worker_id,
                    lease_id=lease.lease_id, role=w.role)
        conn.send({
            "t": "lease", "lease_id": lease.lease_id,
            "ttl_s": self.leases.ttl_s,
            "heartbeat_s": self.heartbeat_s,
        })
        self.queue.kick()    # routable capacity appeared
        if w.role == "ingest":
            # a (re)joined ingest worker may rendezvous-reclaim clusters
            self._ingest_rebalance()
        return w

    def _conn_loop(self, conn: FrameConn) -> None:
        """One connection's read loop: hello/handshake, then heartbeats,
        responses, and drain acks until EOF (EOF = process death)."""
        handle: Optional[_WorkerHandle] = None
        while not self._stop.is_set():
            try:
                msg = conn.recv()
            except FrameError:
                msg = None   # poisoned stream: treat as death
            if msg is None:
                break
            now = self.clock()
            if handle is not None and now < handle.partitioned_until:
                # coordinator_partition chaos: frames are dropped on the
                # floor — no renewals, no acks, no responses delivered
                with self._lock:
                    handle.partition_dropped += 1
                continue
            t = msg.get("t")
            if t == "hello":
                got = self._register(conn, msg)
                if got is not None:
                    handle = got
            elif t == "hb" and handle is not None:
                sent_at = msg.get("sent_at")
                handle.note_heartbeat(
                    float(sent_at) if sent_at is not None else None, now)
                if self.leases.renew(
                    handle.worker_id, str(msg.get("lease_id")), now
                ):
                    conn.send({"t": "hb_ack", "seq": msg.get("seq", 0)})
                else:
                    # stale/expired lease: the worker was declared dead;
                    # make it re-hello explicitly.  The reject names the
                    # lease it refuses: every heartbeat still in flight
                    # on the old lease is refused too, and a worker that
                    # has already re-helloed must not drop its fresh
                    # lease for those
                    conn.send({"t": "reject", "reason": "stale_lease",
                               "lease_id": str(msg.get("lease_id"))})
            elif t == "resp" and handle is not None:
                self._on_response(handle, msg)
            elif t == "ingest_stat" and handle is not None:
                self._on_ingest_stat(handle, msg)
            elif t == "drained" and handle is not None:
                # a port worker's drain report: its launch counters,
                # device batches and registry rows (optional fields)
                self._event("worker_drained", handle.worker_id,
                            served=msg.get("served"), **{
                                key: msg[key] for key in (
                                    "launches", "persist_launches",
                                    "device_batches", "kernel_rows")
                                if key in msg})
                with self._lock:
                    draining = handle.draining
                if draining:
                    # intentional retirement (scale-down): complete it
                    # BEFORE the socket drops so the EOF below is a
                    # no-op, never a process_kill
                    self._scaledown_complete(handle)
        if handle is not None:
            self._worker_down(handle.worker_id, eof=True)

    # -- completion (exactly-once across the wire) ----------------------------
    def _on_response(self, w: _WorkerHandle, msg: Dict[str, Any]) -> None:
        rid = str(msg.get("request_id"))
        with self._lock:
            entry = self._pending.get(rid)
            if entry is None or entry.worker_id != w.worker_id:
                # reassigned or already completed: a late answer from a
                # declared-dead worker must not double-complete
                self.stale_responses += 1
                stale = True
            else:
                del self._pending[rid]
                w.outstanding = max(0, w.outstanding - 1)
                w.served += 1
                stale = False
        if stale:
            return
        req = entry.req
        status = str(msg.get("status", "error"))
        if status == "ok":
            ranked = [dict(r) for r in msg.get("ranked") or []]
            self.sink.remember(req.graph_key, ranked)
            queue_ms = max(0.0, (entry.sent_at - req.enqueued_at) * 1e3)
            self.metrics.answered(req.tenant, queue_ms)
            self.metrics.record_batch(int(msg.get("batch_size") or 1))
            self.sink._complete(req, ServeResponse(
                status="ok", request_id=req.request_id, tenant=req.tenant,
                ranked=ranked, queue_ms=round(queue_ms, 3),
                batch_size=int(msg.get("batch_size") or 1),
                deadline_missed=req.expired(self.clock()),
                result=WireResult(ranked, str(msg.get("engine") or "")),
            ))
        elif status == "shed":
            self.sink.shed(req, detail=str(msg.get("detail") or "shed"))
        elif status in ("degraded", "error", "queue_full"):
            # honest forwarding: the worker's ladder already ran; a
            # queue_full from a saturated worker degrades here (the
            # coordinator's ladder may still hold a last-known ranking)
            self.sink.degraded(
                req,
                detail=f"worker{w.worker_id}:{status}:"
                       f"{msg.get('detail') or ''}",
            )
        else:
            self.sink.error(req, f"worker{w.worker_id}:bad_status:{status}")
        self.queue.kick()    # window room appeared

    # -- death, drain-and-reroute ---------------------------------------------
    def _worker_down(self, worker_id: int, eof: bool = False) -> None:
        """Mark one worker dead and reclaim everything it owned.  The
        fault class is derived from HOW it died: socket EOF means the
        process is gone (``process_kill``); lease expiry with the socket
        open during a partition window is ``coordinator_partition``;
        lease expiry with an open socket otherwise is ``worker_hang``.
        A process this plane SIGKILLed is a ``process_kill`` however its
        down is detected: a CUDA process's exit can outlast the lease
        before its socket closes.  The event's ``eof`` is true when the
        process's own end (its socket's EOF, or its exit seen by the
        monitor) convicted it, false when its lease did."""
        now = self.clock()
        with self._lock:
            w = self.workers.get(int(worker_id))
            if w is None or not w.live:
                return
            w.live = False
            w.state = "dead"
            self.ring.remove(worker_id)
            self.ingest_ring.remove(worker_id)
            was_ingest = w.role == "ingest"
            lease = w.lease
            overdue = (
                max(0.0, now - lease.expires_at())
                if lease is not None else 0.0
            )
            if was_ingest:
                # any ingest-owner loss is the same fault from the
                # capture plane's point of view: mirrors must move
                fault = INGEST_FAULT_CLASS
            elif eof or w.killed:
                fault = "process_kill"
            elif w.partitioned_until > 0.0:
                fault = "coordinator_partition"
            else:
                fault = "worker_hang"
            reclaimed = [
                p for p in self._pending.values()
                if p.worker_id == w.worker_id
            ]
            for p in reclaimed:
                del self._pending[p.req.request_id]
            w.outstanding = 0
        self.leases.revoke(worker_id)
        self._event(
            "worker_down", worker_id, **{
                "class": fault, "reclaimed": len(reclaimed),
                "detect_lag_ms": round(overdue * 1e3, 3), "eof": bool(eof),
            },
        )
        for p in reclaimed:
            if not self.steal:
                self.sink.degraded(
                    p.req, detail=f"worker_unavailable:{fault}"
                )
                continue
            p.moves += 1
            with self._lock:
                self.reroutes += 1
                self._overflow.append(p.req)
        self.queue.kick()
        if was_ingest:
            # drain-and-reroute for the capture plane: every cluster the
            # dead worker owned moves to its rendezvous survivor
            self._ingest_rebalance()

    # -- ingest worker class: federated cluster capture ------------------------
    def register_clusters(self, specs: Dict[str, Dict[str, Any]]) -> None:
        """Register captured clusters with the ingest fleet.

        ``specs`` maps cluster id -> a spec dict carrying at least
        ``digest`` (the :meth:`ClusterSet.cluster_digest` value; the
        rendezvous routing key is ``"<cid>:<digest>"``) plus whatever
        world parameters the worker-side runner needs to host the
        mirror.  Each cluster gets EXACTLY ONE live ingest owner; every
        ownership change bumps the cluster's epoch so stats from
        deposed owners are dropped, never double-applied."""
        with self._lock:
            for cid, spec in specs.items():
                ent = self.clusters.setdefault(str(cid), {
                    "digest": "", "spec": {}, "owner": None, "epoch": 0,
                    "last_seq": 0, "ticks": 0, "double_applied": 0,
                    "moves": 0, "sweep_ms": None, "coldiff_bytes": None,
                })
                ent["digest"] = str(spec.get("digest") or cid)
                ent["spec"] = dict(spec)
        self._ingest_rebalance()

    def _ingest_rebalance(self) -> None:
        """Recompute every cluster's owner over the live ingest ring and
        ship (un)assign frames for the moves.  Rendezvous keys are
        ``cid:digest`` — a digest change (topology change) is allowed to
        move a mirror; a rejoining worker reclaims exactly the clusters
        it owned before (HRW stickiness)."""
        sends: List[Any] = []
        moved: List[Dict[str, Any]] = []
        with self._lock:
            for cid in sorted(self.clusters):
                ent = self.clusters[cid]
                key = f"{cid}:{ent['digest']}"
                new_owner = None
                for wid in self.ingest_ring.ranked(key):
                    w = self.workers.get(wid)
                    if (w is not None and w.live and not w.draining
                            and w.conn is not None):
                        new_owner = wid
                        break
                if new_owner == ent["owner"]:
                    continue
                old_id = ent["owner"]
                old = (
                    self.workers.get(old_id)
                    if old_id is not None else None
                )
                ent["owner"] = new_owner
                ent["epoch"] += 1
                ent["moves"] += 1
                if (old is not None and old.live
                        and old.conn is not None):
                    sends.append((old.conn, {
                        "t": "ingest_unassign", "cluster": cid,
                        "epoch": ent["epoch"],
                    }))
                if new_owner is not None:
                    sends.append((self.workers[new_owner].conn, {
                        "t": "ingest_assign", "cluster": cid,
                        "epoch": ent["epoch"],
                        "resume_seq": ent["last_seq"],
                        "spec": ent["spec"],
                    }))
                moved.append({
                    "cluster": cid, "from": old_id, "to": new_owner,
                    "epoch": ent["epoch"],
                })
        for m in moved:
            self._event(
                "ingest_assigned" if m["to"] is not None
                else "ingest_orphaned",
                m["to"], cluster=m["cluster"], epoch=m["epoch"],
                prev_owner=m["from"],
            )
        for conn, msg in sends:
            conn.send(msg)

    def _on_ingest_stat(self, w: _WorkerHandle,
                        msg: Dict[str, Any]) -> None:
        """One capture-tick report from an ingest worker.  The cluster
        table arbitrates exactly-once: stats from a deposed owner
        (wrong worker or stale epoch) and replayed tick seqs are
        counted and dropped — a tick is applied at most once."""
        cid = str(msg.get("cluster"))
        epoch = int(msg.get("epoch") or -1)
        seq = int(msg.get("tick_seq") or 0)
        with self._lock:
            ent = self.clusters.get(cid)
            if (ent is None or ent["owner"] != w.worker_id
                    or ent["epoch"] != epoch):
                self.ingest_stale += 1
                return
            if seq <= ent["last_seq"]:
                ent["double_applied"] += 1
                return
            ent["last_seq"] = seq
            ent["ticks"] += 1
            if msg.get("sweep_ms") is not None:
                ent["sweep_ms"] = float(msg["sweep_ms"])
            if msg.get("coldiff_bytes") is not None:
                ent["coldiff_bytes"] = int(msg["coldiff_bytes"])

    def ingest_status(self) -> Dict[str, Dict[str, Any]]:
        """Snapshot of the cluster-ownership table (CLI + tests)."""
        with self._lock:
            return {
                cid: {k: v for k, v in ent.items() if k != "spec"}
                for cid, ent in self.clusters.items()
            }

    # -- routing --------------------------------------------------------------
    def _pick_worker(self, req: ServeRequest) -> Optional[_WorkerHandle]:
        """Ring owner first; spill down the preference order past the
        outstanding window.  None while nothing live has room (the
        router parks) — and None with NOTHING live at all (the ladder
        answers).  Called under the plane lock.

        Shape-aware placement: for graph buckets the
        ``PLACEMENT_RULES`` table marks as informed-routable, the pick
        prefers the candidate whose hello'd registry summary shows the
        winning timing at this request's shape tier (device
        ``bytes_in_use`` breaks ties toward headroom, ring order breaks
        the rest; the scoring is deterministic, so a hot bucket stays
        STICKY to its preferred worker).  No candidate with data, or a
        bucket the table leaves alone → pure rendezvous order.  The
        metrics lock is a documented leaf under the plane lock."""
        key = graph_route_key(req.graph_key)
        candidates = []
        for wid in self.ring.ranked(key):
            w = self.workers.get(wid)
            if (w is not None and w.live and not w.draining
                    and w.conn is not None
                    and w.outstanding < self.window):
                candidates.append(w)
        if not candidates:
            return None
        rule = PLACEMENT_RULES.rule_for(int(req.graph_key[0]))
        if "timings" in rule.prefer and len(candidates) > 1:
            scored = []
            for pos, w in enumerate(candidates):
                t_ms = shape_tier_ms(w.shape_ms, int(req.graph_key[0]))
                if t_ms is None:
                    continue
                mem = (
                    w.mem_bytes
                    if ("headroom" in rule.prefer
                        and w.mem_bytes is not None)
                    else float("inf")
                )
                scored.append((t_ms, mem, pos, w))
            if scored:
                self.metrics.placement("preferred")
                return min(scored)[3]
        self.metrics.placement("rendezvous")
        return candidates[0]

    def _route_one(self, req: ServeRequest, now: float) -> bool:
        """Place one popped request.  True when it reached a worker (or
        terminally completed); False = no capacity right now, the router
        holds it in overflow."""
        if req.expired(now):
            self.sink.shed(req, detail="expired_in_router")
            return True
        conn = None
        with self._lock:
            target = self._pick_worker(req)
            if target is not None:
                self._pending[req.request_id] = _Pending(
                    req, target.worker_id, now
                )
                target.outstanding += 1
                conn = target.conn
        if target is None:
            if not self.live_workers():
                # no fleet: ride the degradation ladder, never hang
                self.sink.degraded(req, detail="no_worker_available")
                return True
            return False
        if self.tracer.enabled and req.trace is not None:
            self.tracer.record(
                "serve.queue", req.enqueued_at, now, parent=req.trace,
                attrs={"tenant": req.tenant, "priority": req.priority,
                       "worker": target.worker_id},
            )
        if not conn.send(encode_request(req)):
            # died between pick and send: reclaim immediately and retry
            with self._lock:
                entry = self._pending.pop(req.request_id, None)
                if entry is not None:
                    target.outstanding = max(0, target.outstanding - 1)
            self._worker_down(target.worker_id, eof=True)
            if entry is not None:
                with self._lock:
                    self._overflow.append(req)
            return True
        return True

    def _route_loop(self) -> None:
        while not self._stop.is_set():
            now = self.clock()
            worked = False
            for req in self.queue.shed_expired(now):
                self.sink.shed(req, detail="expired_in_queue")
                worked = True
            with self._lock:
                held = self._overflow.popleft() if self._overflow else None
            if held is not None:
                if self._route_one(held, now):
                    worked = True
                else:
                    with self._lock:
                        self._overflow.appendleft(held)
                    self._stop.wait(_ROUTE_IDLE_S)
                    continue
            with self._lock:
                req = self.queue.pop()
            if req is not None:
                if self._route_one(req, now):
                    worked = True
                else:
                    with self._lock:
                        self._overflow.appendleft(req)
                    self._stop.wait(_ROUTE_IDLE_S)
                    continue
            if not worked and req is None:
                self.queue.wait_for_work(_ROUTE_IDLE_S)

    # -- liveness monitor ------------------------------------------------------
    def check_leases(self, now: Optional[float] = None) -> List[int]:
        """One liveness sweep (the monitor thread's body; also driven
        directly by fake-clock tests): expire overdue leases → mark
        workers down → drain-and-reroute.  Returns the worker ids
        expired this sweep."""
        if now is None:
            now = self.clock()
        downed = []
        for worker_id, _overdue in self.leases.expired_workers(now):
            with self._lock:
                w = self.workers.get(worker_id)
                live = w is not None and w.live
            if live:
                self._worker_down(worker_id)
                downed.append(worker_id)
            else:
                self.leases.revoke(worker_id)
        return downed

    def _monitor_loop(self) -> None:
        interval = max(0.01, self.heartbeat_s / 2.0)
        slept_at = self.clock()
        while not self._stop.wait(interval):
            # a sweep that wakes late means this process stalled (a
            # garbage collection, a starved core): the heartbeats sent
            # meanwhile wait unread in its sockets, so the lateness is
            # credited to every lease before it is judged.  A reader
            # that renews before this sweep may still find its lease
            # expired: that worker re-hellos, and nothing is rerouted.
            now = self.clock()
            late = max(0.0, now - slept_at - interval)
            if late > 0.0:
                self.leases.credit(late)
                self.stall_max_s = max(self.stall_max_s, late)
            # a worker whose PROCESS is gone or exiting while its socket
            # teardown lags is downed as such BEFORE its lease is judged
            with self._lock:
                procs = [(w.worker_id, w.proc) for w in self.workers.values()
                         if w.live and w.proc is not None]
            for wid, proc in procs:
                if proc.exiting():
                    self._worker_down(wid, eof=True)
            self.check_leases(now)
            slept_at = self.clock()

    # -- health (gateway /healthz, the ``fleet`` command) ---------------------
    def health(self) -> Dict[str, Any]:
        with self._lock:
            states = {
                str(w.worker_id): w.state for w in self.workers.values()
            }
            ok = any(w.live for w in self.workers.values())
            fleet = [
                self.workers[wid].summary() for wid in sorted(self.workers)
            ]
        out = {
            "ok": bool(ok), "workers": states,
            "queue_depth": len(self.queue),
            "pending": self.pending_count(),
            "fleet": fleet,
        }
        auto = self.autoscaler
        if auto is not None:
            out["autoscale"] = auto.status()
        ingest = self.ingest_status()
        if ingest:
            out["ingest"] = ingest
        return out


# ---------------------------------------------------------------------------
# Selftest (``serve --federation N [--kill-worker]``)
# ---------------------------------------------------------------------------


def federation_selftest(
    workers: int = 3,
    n_requests: int = 36,
    seed: int = 0,
    kill_worker: bool = False,
    submitters: int = 6,
    config: Optional[ServeConfig] = None,
    services: Tuple[int, ...] = (24, 60, 120),
    heartbeat_s: float = 0.15,
    timeout_s: float = 180.0,
    ready_timeout_s: float = 90.0,
    bind_external: bool = False,
    device=None,
    worker_env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """End-to-end federation contract check, the cross-process twin of
    :func:`rca_tpu_torch.serve.client.serve_selftest`, with the workers
    and the parity oracle on ``device`` (the card unless
    ``device="cpu"``):

    - ``workers`` real worker PROCESSES under one control plane, wire
      load from ``submitters`` concurrent threads over several shape
      buckets and tenants;
    - ``kill_worker``: SIGKILL one worker mid-wave (the procs seam's
      ``process_kill``): every request must still end terminal
      (ok/shed/degraded, none hung), with ZERO double completions;
    - bit parity across processes: every ok ranking must equal a solo
      analysis of the same request in THIS process on the same device,
      bit for bit: the wire codec's float32→JSON→float32 identity plus
      the serve coalesced-vs-solo contract.  The workers run with
      ``RCA_SHARD=0`` unless ``worker_env`` says otherwise, so worker and
      oracle build the same engine whatever the host's device count
      (the oracle still follows a sharded worker's engine tag);
    - ``bind_external``: the multi-host deploy leg: the coordinator binds
      ``0.0.0.0`` and advertises the host's primary interface IP, so
      every worker joins via a REAL non-loopback ``--connect host:port``
      exactly as an external host would.
    """
    import threading as _threading   # Event only (signal, not a lock)

    import numpy as np

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine.runner import GraphEngine
    from rca_tpu_torch.util.threads import make_thread

    cases = [
        synthetic_cascade_arrays(n, n_roots=1, seed=seed + i)
        for i, n in enumerate(services)
    ]
    tenants = [f"tenant-{c}" for c in "abcd"]
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_requests):
        case = cases[i % len(cases)]
        feats = np.clip(
            case.features + rng.uniform(
                0, 0.05, case.features.shape
            ).astype(np.float32),
            0, 1,
        )
        specs.append({
            "case": case, "features": feats,
            "tenant": tenants[i % len(tenants)],
            # a few requests arrive already expired: the shed contract
            # must hold across the wire too
            "deadline_expired": i % 11 == 10,
        })

    plane_kwargs: Dict[str, Any] = {}
    if bind_external:
        from rca_tpu_torch.util.net import primary_host_ip

        plane_kwargs.update(
            host="0.0.0.0", advertise_host=primary_host_ip(),
        )
    env = {"RCA_SHARD": "0", **(worker_env or {})}
    plane = FederationPlane(
        workers=workers, config=config, heartbeat_s=heartbeat_s,
        device=device, worker_env=env, **plane_kwargs,
    )
    requests: List[Optional[ServeRequest]] = [None] * n_requests
    kill_at: Dict[str, Any] = {"t": None, "worker": None}
    kill_lock = make_lock("federation_selftest.kill_lock")
    killed = _threading.Event()
    t0 = plane.clock()
    with plane:
        if not plane.wait_ready(workers, timeout_s=ready_timeout_s):
            table = plane.worker_table()
            diag = [
                {**w.summary(), "stderr_tail": (
                    w.proc.output()[1][-2000:] if w.proc else ""
                )}
                for w in plane.workers.values()
            ]
            raise RuntimeError(
                f"federation selftest: only {len(plane.live_workers())}"
                f"/{workers} workers joined within {ready_timeout_s}s: "
                f"{table}; {diag}"
            )
        startup_s = plane.clock() - t0

        def submitter(worker: int) -> None:
            for i in range(worker, n_requests, submitters):
                s = specs[i]
                if (kill_worker and not killed.is_set()
                        and i >= n_requests // 2):
                    with kill_lock:
                        fire = not killed.is_set()
                        if fire:
                            killed.set()
                    if fire:
                        victims = plane.live_workers()
                        victim = victims[0] if victims else 0
                        kill_at["t"] = plane.clock()
                        kill_at["worker"] = victim
                        plane.kill_worker(victim)
                req = ServeRequest(
                    tenant=s["tenant"], features=s["features"],
                    dep_src=s["case"].dep_src, dep_dst=s["case"].dep_dst,
                    names=s["case"].names, k=3,
                    deadline_s=(plane.clock() - 1.0
                                if s["deadline_expired"] else None),
                )
                requests[i] = req
                plane.submit(req)

        threads = [
            make_thread(submitter, name=f"fed-selftest-submit-{w}",
                        daemon=True, args=(w,))
            for w in range(submitters)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        responses = [r.result(timeout_s) for r in requests]  # type: ignore
        all_terminal_at = plane.clock()
        # each surviving worker's drain report: what it launched and the
        # registry rows it served with
        drain_reports = plane.drain_all(timeout_s=60.0)
        events = list(plane.events)
        worker_table = plane.worker_table()
        with plane._lock:
            hellos = {
                str(wid): {key: w.hello.get(key) for key in (
                    "pid", "engine", "local_devices", "process_count",
                    "registry", "headroom")}
                for wid, w in sorted(plane.workers.items())
            }
        double = plane.sink.double_completions
        stale = plane.stale_responses
        reroutes = plane.reroutes

    by_status: Dict[str, int] = {}
    for resp in responses:
        by_status[resp.status] = by_status.get(resp.status, 0) + 1
    # parity oracles per ENGINE KIND, like the pool selftest: a worker
    # whose environment shards (RCA_SHARD) tags its answers so, and
    # dense-vs-sharded float differences must not masquerade as
    # federation-parity failures.  The solo rerun uses the SAME kind
    # (and the same dp/sp layout, parsed from the tag) on the SAME
    # device.
    import re as _re

    solo_cache: Dict[str, Any] = {}

    def _oracle(tag: str):
        if tag not in solo_cache:
            m = _re.search(r"sharded\(dp=(\d+),sp=(\d+)\)", tag or "")
            if m:
                from rca_tpu_torch.engine.sharded_runner import (
                    ShardedGraphEngine,
                )

                solo_cache[tag] = ShardedGraphEngine(
                    spec=f"dp={m.group(1)},sp={m.group(2)}", device=device
                )
            else:
                solo_cache[tag] = GraphEngine(device=device)
        return solo_cache[tag]

    parity_checked = 0
    parity_ok = True
    for spec, resp in zip(specs, responses):
        if not resp.ok:
            continue
        tag = getattr(resp.result, "engine", "") or ""
        ref = _oracle(tag).analyze_arrays(
            spec["features"], spec["case"].dep_src,
            spec["case"].dep_dst, spec["case"].names, k=3,
        )
        parity_checked += 1
        if [dict(r) for r in ref.ranked] != resp.ranked:
            parity_ok = False
    expected_shed = sum(1 for s in specs if s["deadline_expired"])
    all_resolved = all(r is not None and r.done() for r in requests)
    terminal_ok = all(
        r.status in ("ok", "shed", "degraded", "queue_full")
        for r in responses
    ) if not kill_worker else all(
        r.status in ("ok", "shed", "degraded", "error", "queue_full")
        for r in responses
    )
    fault_classes = sorted({
        e["class"] for e in events
        if e["event"] == "worker_down" and e.get("class")
    })
    ok = (
        all_resolved
        and parity_ok
        and double == 0
        and terminal_ok
        and by_status.get("shed", 0) >= expected_shed
        and (not kill_worker or "process_kill" in fault_classes)
        and (kill_worker or (
            by_status.get("error", 0) == 0
            and by_status.get("ok", 0)
            == n_requests - by_status.get("shed", 0)
        ))
    )
    out = {
        "ok": bool(ok),
        "workers": workers,
        "requests": n_requests,
        "kill_worker": bool(kill_worker),
        "startup_s": round(startup_s, 3),
        **({
            "bind_external": {
                "listen": "0.0.0.0",
                "advertised": plane.address,
            },
        } if bind_external else {}),
        "by_status": by_status,
        "expected_shed_min": expected_shed,
        "all_resolved": bool(all_resolved),
        "parity_checked": parity_checked,
        "parity_ok": bool(parity_ok),
        "double_completions": double,
        "stale_responses": stale,
        "reroutes": reroutes,
        "fault_classes_observed": fault_classes,
        "worker_table": worker_table,
        "hellos": hellos,
        "drain_reports": {str(k): v for k, v in sorted(
            drain_reports.items())},
    }
    if kill_worker and kill_at["t"] is not None:
        out["killed_worker"] = kill_at["worker"]
        out["recovery_ms"] = round(
            (all_terminal_at - kill_at["t"]) * 1e3, 1
        )
        down = [
            e for e in events
            if e["event"] == "worker_down"
            and e["worker_id"] == kill_at["worker"]
        ]
        if down:
            out["detect_ms"] = round(
                (down[0]["t"] - kill_at["t"]) * 1e3, 1
            )
    return out


# ---------------------------------------------------------------------------
# Chaos harness (the ``chaos`` command's federation leg)
# ---------------------------------------------------------------------------


def run_federation_chaos(
    seed: int = 7,
    workers: int = 3,
    heartbeat_s: float = 0.12,
    services: int = 32,
    timeout_s: float = 240.0,
    ready_timeout_s: float = 90.0,
    device=None,
    worker_env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Drive all three federation fault classes against one live fleet
    under continuous wire load, and score the contract:

    1. **worker_hang**: a seeded-chosen worker is told to stop
       heartbeating past the lease TTL (socket stays open) → lease
       expiry → drain-and-reroute; when the hang ends, its stale lease
       is REJECTED and it re-hellos — the rejoin path;
    2. **coordinator_partition**: the coordinator drops another
       worker's frames for a window → same expiry/reroute; on heal the
       worker rejoins the same way;
    3. **process_kill**: a third worker is SIGKILLed (procs seam) and
       stays dead — survivors absorb its keys.

    Exit contract: every submitted request terminal, ZERO double
    completions (stale late answers from hung/partitioned workers are
    dropped and counted), all three classes observed, and at least one
    rejoin."""
    import random as _random

    import numpy as np

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.util.threads import make_thread

    rng = _random.Random(seed)
    case = synthetic_cascade_arrays(services, n_roots=1, seed=seed)
    nprng = np.random.default_rng(seed)
    plane = FederationPlane(workers=workers, heartbeat_s=heartbeat_s,
                            device=device, worker_env=worker_env)
    ttl = plane.leases.ttl_s
    submitted: List[ServeRequest] = []
    stop_load = threading.Event()

    def load() -> None:
        i = 0
        while not stop_load.is_set():
            feats = np.clip(
                case.features + nprng.uniform(
                    0, 0.05, case.features.shape
                ).astype(np.float32),
                0, 1,
            )
            req = ServeRequest(
                tenant=f"chaos-{i % 3}", features=feats,
                dep_src=case.dep_src, dep_dst=case.dep_dst,
                names=case.names, k=3,
            )
            submitted.append(req)
            plane.submit(req)
            i += 1
            stop_load.wait(0.03)

    def wait_event(pred, deadline: float) -> bool:
        while plane.clock() < deadline:
            if any(pred(e) for e in list(plane.events)):
                return True
            stop_load.wait(0.05)
        return False

    phases: List[Dict[str, Any]] = []
    with plane:
        if not plane.wait_ready(workers, timeout_s=ready_timeout_s):
            raise RuntimeError(
                "federation chaos: workers failed to join: "
                f"{plane.worker_table()}"
            )
        loader = make_thread(load, name="fed-chaos-load", daemon=True)
        loader.start()

        def downed(wid, klass):
            return lambda e: (
                e["event"] == "worker_down"
                and e["worker_id"] == wid and e.get("class") == klass
            )

        def rejoined(wid, after):
            return lambda e: (
                e["event"] == "rejoin" and e["worker_id"] == wid
                and e["t"] >= after
            )

        # 1. worker_hang → expiry → rejoin
        victims = plane.live_workers()
        hang_w = victims[rng.randrange(len(victims))]
        t_h = plane.clock()
        plane.hang_worker(hang_w, for_s=ttl * 2.5)
        hang_seen = wait_event(
            downed(hang_w, "worker_hang"), plane.clock() + timeout_s / 4
        )
        hang_rejoin = wait_event(
            rejoined(hang_w, t_h), plane.clock() + timeout_s / 4
        )
        phases.append({"fault": "worker_hang", "worker": hang_w,
                       "observed": hang_seen, "rejoined": hang_rejoin})

        # 2. coordinator_partition → expiry → heal → rejoin
        candidates = [
            w for w in plane.live_workers() if w != hang_w
        ] or plane.live_workers()
        part_w = candidates[rng.randrange(len(candidates))]
        t_p = plane.clock()
        plane.partition(part_w, for_s=ttl * 2.5)
        part_seen = wait_event(
            downed(part_w, "coordinator_partition"),
            plane.clock() + timeout_s / 4,
        )
        part_rejoin = wait_event(
            rejoined(part_w, t_p), plane.clock() + timeout_s / 4
        )
        phases.append({"fault": "coordinator_partition", "worker": part_w,
                       "observed": part_seen, "rejoined": part_rejoin})

        # 3. process_kill — permanent; survivors absorb the keys
        live = plane.live_workers()
        kill_w = live[rng.randrange(len(live))]
        t_k = plane.clock()
        plane.kill_worker(kill_w)
        reap_ms = (plane.clock() - t_k) * 1e3
        kill_seen = wait_event(
            downed(kill_w, "process_kill"), plane.clock() + timeout_s / 4
        )
        down = next((
            {k: e.get(k) for k in ("class", "eof", "detect_lag_ms")}
            | {"after_kill_ms": round((e["t"] - t_k) * 1e3, 3)}
            for e in list(plane.events)
            if e["event"] == "worker_down" and e["worker_id"] == kill_w
            and e["t"] >= t_k
        ), None)
        phases.append({"fault": "process_kill", "worker": kill_w,
                       "observed": kill_seen,
                       "reap_ms": round(reap_ms, 3), "down": down})

        # let the plane settle under load, then stop
        stop_load.wait(ttl)
        stop_load.set()
        loader.join(10.0)
        responses = [r.result(timeout_s / 2) for r in submitted]
        double = plane.sink.double_completions
        stale = plane.stale_responses
        reroutes = plane.reroutes
        classes = plane.fault_classes_observed()
        events = list(plane.events)

    by_status: Dict[str, int] = {}
    for r in responses:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    detect = [
        e["detect_lag_ms"] for e in events
        if e["event"] == "worker_down" and "detect_lag_ms" in e
    ]
    all_terminal = all(r.done() for r in submitted)
    ok = (
        all_terminal
        and double == 0
        and all(p["observed"] for p in phases)
        and all(p.get("rejoined", True) for p in phases)
        and set(classes) >= set(FED_FAULT_CLASSES)
    )
    return {
        "ok": bool(ok),
        "workers": workers,
        "requests": len(submitted),
        "by_status": by_status,
        "all_terminal": bool(all_terminal),
        "double_completions": double,
        "stale_responses": stale,
        "reroutes": reroutes,
        "fault_classes_observed": classes,
        "phases": phases,
        "lease_ttl_s": ttl,
        "detect_lag_ms_max": round(max(detect), 3) if detect else None,
        "rejoins": sum(1 for e in events if e["event"] == "rejoin"),
    }


def run_ingest_chaos(
    seed: int = 17,
    workers: int = 3,
    clusters: int = 4,
    heartbeat_s: float = 0.12,
    timeout_s: float = 180.0,
    ready_timeout_s: float = 90.0,
    worker_env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Drive the ``ingest_death`` fault class against a live ingest
    fleet mid-sweep, and score the capture-ownership contract:

    1. spawn an ingest-worker fleet and register ``clusters`` synthetic
       clusters — each rendezvous-routed to exactly one owner, ticking
       its columnar mirror continuously;
    2. SIGKILL the owner of a seeded-chosen cluster while its ticks are
       flowing (mid-sweep by construction: the runner never pauses);
    3. assert every orphaned cluster moves to EXACTLY ONE live
       survivor with a fresh epoch and resumes ticking, with ZERO
       double-applied ticks (late stats from the dead owner are
       epoch-stale and dropped);
    4. respawn the dead worker id: HRW stickiness must hand it back
       exactly the clusters it owned before (rejoin reclaims)."""
    import random as _random

    rng = _random.Random(seed)
    plane = FederationPlane(
        workers=0, heartbeat_s=heartbeat_s, spawn_workers=False,
        worker_env=worker_env,
    )

    def wait_for(pred, deadline: float) -> bool:
        while plane.clock() < deadline:
            if pred():
                return True
            if plane._stop.wait(0.05):
                return False
        return bool(pred())

    with plane:
        for i in range(workers):
            plane.spawn_worker(i, role="ingest")
        if not plane.wait_ready(workers, timeout_s=ready_timeout_s):
            raise RuntimeError(
                "ingest chaos: workers failed to join: "
                f"{plane.worker_table()}"
            )
        specs = {
            f"ing{j}": {
                "digest": f"digest-{seed}-{j}",
                "services": 6, "pods_per_service": 1,
                "seed": seed + j, "namespace": "synthetic",
            }
            for j in range(clusters)
        }
        plane.register_clusters(specs)

        def ticking(min_ticks: int, table=None) -> bool:
            status = plane.ingest_status()
            return all(
                c["owner"] is not None and c["ticks"] >= (
                    (table or {}).get(cid, 0) + min_ticks
                )
                for cid, c in status.items()
            )

        deadline = plane.clock() + timeout_s
        if not wait_for(lambda: ticking(3), deadline):
            raise RuntimeError(
                f"ingest chaos: fleet never ticked: {plane.ingest_status()}"
            )

        pre = plane.ingest_status()
        owners = sorted({c["owner"] for c in pre.values()})
        victim = owners[rng.randrange(len(owners))]
        victim_clusters = sorted(
            cid for cid, c in pre.items() if c["owner"] == victim
        )
        pre_ticks = {cid: pre[cid]["ticks"] for cid in pre}
        # mid-sweep: ticks are flowing when the SIGKILL lands
        plane.kill_worker(victim)

        death_seen = wait_for(
            lambda: any(
                e["event"] == "worker_down"
                and e["worker_id"] == victim
                and e.get("class") == INGEST_FAULT_CLASS
                for e in list(plane.events)
            ),
            deadline,
        )

        def moved() -> bool:
            status = plane.ingest_status()
            live = set(plane.live_workers())
            return all(
                status[cid]["owner"] in live
                and status[cid]["owner"] != victim
                and status[cid]["epoch"] > pre[cid]["epoch"]
                and status[cid]["ticks"] >= pre_ticks[cid] + 2
                for cid in victim_clusters
            )

        moved_ok = wait_for(moved, deadline)
        mid = plane.ingest_status()

        # rejoin: the respawned worker id must reclaim ITS clusters
        plane.spawn_worker(victim, role="ingest")

        def reclaimed() -> bool:
            status = plane.ingest_status()
            return all(
                status[cid]["owner"] == victim
                and status[cid]["ticks"] >= mid[cid]["ticks"] + 2
                for cid in victim_clusters
            )

        reclaimed_ok = wait_for(reclaimed, deadline)
        status = plane.ingest_status()
        double = sum(c["double_applied"] for c in status.values())
        stale = plane.ingest_stale
        classes = plane.fault_classes_observed()
        single_owner = all(
            c["owner"] is not None for c in status.values()
        )

    ok = (
        death_seen
        and moved_ok
        and reclaimed_ok
        and single_owner
        and double == 0
        and INGEST_FAULT_CLASS in classes
        and bool(victim_clusters)
    )
    return {
        "ok": bool(ok),
        "workers": workers,
        "clusters": clusters,
        "victim": victim,
        "victim_clusters": victim_clusters,
        "death_seen": bool(death_seen),
        "moved_to_survivor": bool(moved_ok),
        "rejoin_reclaimed": bool(reclaimed_ok),
        "double_applied": double,
        "stale_stats_dropped": stale,
        "fault_classes_observed": classes,
        "table": status,
    }
