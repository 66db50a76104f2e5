"""Federation worker: one serve process in the fleet (the port's copy of
``rca_tpu.serve.worker``).

``python -m rca_tpu_torch.serve.worker --connect HOST:PORT --worker-id N
[--role serve|ingest] [--device cuda|cpu]`` runs ONE slice of the
federated serving plane: a full :class:`rca_tpu_torch.serve.loop.
ServeLoop` (or, when ``RCA_SERVE_REPLICAS`` / ``RCA_SERVE_REPLICA_MIX``
names more than one replica, a whole :class:`rca_tpu_torch.serve.pool.
ServePool`) over this process's own device, fronted by a control-channel
connection back to the :class:`rca_tpu_torch.serve.federation.
FederationPlane`.

A serve worker runs on the CUDA card unless ``--device cpu`` asks for the
CPU, as every entry point of the port does: with no card and no
``--device cpu`` it raises at start, before it connects, and exits
non-zero.  It never serves from the CPU in the card's place.  Each
worker owns its own CUDA context, kernel library and registry; a worker
that inherits ``RCA_KERNEL_CACHE`` reads the rows its coordinator (or an
earlier worker) elected instead of racing the shape again.  An ingest
worker (``--role ingest``) builds no engine and never touches the card.

Bootstrap goes through :mod:`rca_tpu_torch.parallel.distributed` first
(a no-op unless a coordinator is named); the hello frame carries the
bootstrap topology so the coordinator can see what it federates.

Protocol behaviour (see :mod:`rca_tpu_torch.serve.fedwire`):

- hello → lease; heartbeats on the granted cadence renew it;
- a ``reject`` (stale lease: this worker was declared dead while it
  was hung or partitioned) triggers an explicit RE-HELLO for a fresh
  lease: rejoin is loud, never a silent resurrection.  A reject that
  names a lease this worker no longer holds (a heartbeat that crossed
  its re-hello) is ignored;
- ``req`` frames become local :class:`ServeRequest` submissions; each
  completion is answered with a ``resp`` frame.  A request that was
  rerouted while this worker was presumed dead may still complete here;
  the coordinator drops that answer as stale (ITS pending table is the
  exactly-once arbiter, not this process);
- ``hang`` (chaos seam) suspends heartbeats for a window while leaving
  the socket (and local serving) untouched: the ``worker_hang`` fault
  class from the inside;
- ``drain`` stops intake, finishes in flight, answers ``drained`` (with
  the worker's kernel launch counters and registry rows), and exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from rca_tpu_torch.serve.fedwire import (
    FrameConn,
    FrameError,
    PROTO,
    decode_request_kwargs,
    encode_response,
)
from rca_tpu_torch.resilience.policy import suppressed
from rca_tpu_torch.serve.request import ServeRequest
from rca_tpu_torch.util.net import make_client_socket, parse_hostport
from rca_tpu_torch.util.threads import make_lock, spawn

#: bound on one request's local serve time before the worker answers
#: ``error`` for it (the coordinator's deadline machinery is the real
#: latency policy; this only prevents a wedged local plane from
#: accumulating parked waiter threads forever)
REQUEST_TIMEOUT_S = 120.0

#: seeded jittered backoff for the re-hello loop: a healing partition
#: ages out MANY leases at once; without backoff every survivor
#: re-hellos in the same instant, a rejoin stampede on the coordinator
#: it just stopped being able to reach
REJOIN_BACKOFF_BASE_S = 0.05
REJOIN_BACKOFF_CAP_S = 2.0


def _registry_summary() -> Dict[str, float]:
    """The hello frame's kernel-registry digest: winning per-shape
    timing (ms) per ``n_pad`` tier, from this process's own
    :class:`KernelRegistry`.  Empty when nothing is resolved yet or no
    row was timed (a forced or cached row carries no race): the field is
    OPTIONAL on the wire and the coordinator treats absence as 'no
    placement evidence'."""
    try:
        from rca_tpu_torch.engine.registry import kernel_table

        out: Dict[str, float] = {}
        for row in kernel_table():
            n_pad = int(row.get("n_pad") or 0)
            timings = row.get("timings_ms") or {}
            winner = row.get("winner")
            ms = timings.get(winner) if winner else None
            if n_pad <= 0 or ms is None:
                continue
            key = str(n_pad)
            if key not in out or float(ms) < out[key]:
                out[key] = float(ms)
        return out
    except Exception:  # noqa: BLE001 - evidence is optional, never fatal
        return {}


def _headroom_summary() -> Optional[Dict[str, int]]:
    """The hello frame's device-memory digest from the CUDA caching
    allocator: ``bytes_in_use`` lets the coordinator's headroom placement
    prefer the emptier device.  None when this process never touched the
    card (an ingest worker, a CPU worker): sampling there would create a
    CUDA context for nothing.  Optional, like the registry."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        from rca_tpu_torch.observability.kernelscope import (
            sample_device_memory,
        )

        mem = sample_device_memory()
        return {"bytes_in_use": int(mem["bytes_in_use"])}
    except Exception:  # noqa: BLE001 - evidence is optional, never fatal
        return None


def drain_report(loop) -> Dict[str, Any]:
    """What a serve worker adds to its ``drained`` frame: its kernel
    launch counters over its whole life (a fresh process starts them at
    0, so they are the launches of the device batches it served), its
    device batches, and the registry rows it served with (shape, winner,
    how the winner was chosen, the timings of a race)."""
    from rca_tpu_torch.engine.registry import kernel_table
    from rca_tpu_torch.kernels import LAUNCHES, PERSIST_LAUNCHES

    rows = [
        {key: row.get(key) for key in (
            "variant", "n_pad", "e_pad", "backend", "winner", "source",
            "timings_ms")}
        for row in kernel_table()
    ]
    return {
        "launches": dict(LAUNCHES),
        "persist_launches": dict(PERSIST_LAUNCHES),
        "device_batches": int(getattr(loop, "device_batches", 0)),
        "kernel_rows": rows,
    }


class WorkerAgent:
    """The control-channel client around one local serving plane.

    ``loop`` is a STARTED ServeLoop/ServePool; the agent owns only the
    wire conversation.  The clock is injectable (the tests drive it);
    heartbeat cadence comes from the coordinator's lease grant."""

    def __init__(
        self,
        worker_id: int,
        host: str,
        port: int,
        loop,
        clock: Callable[[], float] = time.monotonic,
        connect_timeout_s: float = 30.0,
        engine_tag: str = "",
        rejoin_seed: Optional[int] = None,
        sleeper: Callable[[float], None] = time.sleep,
        role: str = "serve",
    ):
        self.worker_id = int(worker_id)
        self.loop = loop
        self.clock = clock
        self.engine_tag = engine_tag
        # worker class: "serve" joins the serve ring;
        # "ingest" joins the ingest ring and hosts capture mirrors via
        # the runner attached at `self.ingest`
        self.role = str(role)
        self.ingest = None
        # seeded per-worker: every fleet member jitters DIFFERENTLY, so
        # a mass lease expiry heals as a spread, not a stampede
        self._rejoin_rng = random.Random(
            rejoin_seed if rejoin_seed is not None else worker_id
        )
        self._rejoin_attempts = 0
        self.rejoin_delays: List[float] = []
        self.sleeper = sleeper
        sock = make_client_socket(
            f"fed-worker{worker_id}", host, port,
            timeout_s=connect_timeout_s,
        )
        self.conn = FrameConn(sock, name=f"fed-worker{worker_id}")
        self._lock = make_lock("WorkerAgent._lock")
        self.lease_id: Optional[str] = None
        self.heartbeat_s = 0.5
        self.hang_until = 0.0
        self.draining = False
        self.inflight = 0
        self.served = 0
        self.acks = 0
        self._hb_seq = 0
        self._hb_thread = None

    # -- handshake ------------------------------------------------------------
    def _hello(self, with_lease: bool = True) -> bool:
        from rca_tpu_torch.parallel.distributed import initialize_distributed

        boot = initialize_distributed()
        msg = {
            "t": "hello", "proto": PROTO, "worker_id": self.worker_id,
            "pid": os.getpid(),
            "role": self.role,
            "engine": self.engine_tag,
            "process_count": boot.get("process_count"),
            "process_index": boot.get("process_index"),
            "local_devices": boot.get("local_device_count"),
        }
        # placement evidence: OPTIONAL fields; a bare hello (a fresh
        # process, an ingest worker) still joins, it just gets pure
        # rendezvous placement
        registry = _registry_summary()
        if registry:
            msg["registry"] = registry
        headroom = _headroom_summary()
        if headroom is not None:
            msg["headroom"] = headroom
        with self._lock:
            if with_lease and self.lease_id is not None:
                msg["lease_id"] = self.lease_id
        return self.conn.send(msg)

    def _next_rejoin_delay(self) -> float:
        """Exponential backoff with full-range jitter for the re-hello
        loop: ``min(cap, base * 2^attempts) * uniform(0.5, 1.5)``.
        Every call is a DISTINCT delay, and the sequence is seeded:
        replayable stampede spreading."""
        raw = min(
            REJOIN_BACKOFF_CAP_S,
            REJOIN_BACKOFF_BASE_S * (2.0 ** self._rejoin_attempts),
        )
        self._rejoin_attempts += 1
        delay = raw * (0.5 + self._rejoin_rng.random())
        self.rejoin_delays.append(delay)
        return delay

    # -- heartbeats -----------------------------------------------------------
    def _hb_loop(self) -> None:
        """Fine-grained scheduler: wake at a fraction of the cadence and
        send when due, so the FIRST heartbeat lands well inside the
        lease TTL even when the granted cadence is much faster than the
        default (the coordinator, not this process, owns the cadence)."""
        last_sent = 0.0
        while True:
            with self._lock:
                lease, hung = self.lease_id, self.hang_until
                cadence = self.heartbeat_s
                # draining is NOT an exit: a worker finishing in-flight
                # work is alive and must keep its lease, or a drain
                # longer than the TTL reads as worker_hang death and
                # the retirement never completes
                if self.conn.closed:
                    return
            now = self.clock()
            if (lease is not None and now >= hung
                    and now - last_sent >= cadence):
                # between leases or hung (chaos): stay quiet instead
                self._hb_seq += 1
                # ``sent_at`` (optional): the coordinator reads the gaps
                # between sends and the delay to its renewal from it
                if not self.conn.send({
                    "t": "hb", "worker_id": self.worker_id,
                    "lease_id": lease, "seq": self._hb_seq,
                    "sent_at": now,
                }):
                    return   # coordinator gone; read loop sees EOF too
                last_sent = now
            time.sleep(max(0.005, cadence / 4.0))

    # -- request handling -----------------------------------------------------
    def _serve_one(self, request_id: str, req: ServeRequest) -> None:
        """Waiter-thread body: park on the local plane's completion and
        answer over the wire.  Send failures are ignored — a vanished
        coordinator re-places the request elsewhere; its pending table
        arbitrates exactly-once, not this send."""
        try:
            resp = req.result(REQUEST_TIMEOUT_S)
        except TimeoutError:
            from rca_tpu_torch.serve.request import ServeResponse

            resp = ServeResponse(
                status="error", request_id=req.request_id,
                tenant=req.tenant,
                detail=f"worker timeout after {REQUEST_TIMEOUT_S}s",
            )
        self.conn.send(encode_response(request_id, resp, self.engine_tag))
        with self._lock:
            self.inflight -= 1
            self.served += 1

    def _on_request(self, msg) -> None:
        request_id = str(msg.get("request_id"))
        try:
            kwargs = decode_request_kwargs(msg)
            req = ServeRequest(**kwargs)
        except Exception as exc:  # noqa: BLE001 - answer, never wedge
            self.conn.send({
                "t": "resp", "request_id": request_id, "status": "error",
                "ranked": [], "batch_size": 0, "engine": self.engine_tag,
                "detail": f"bad request frame: {type(exc).__name__}: {exc}",
            })
            return
        with self._lock:
            if self.draining:
                self.conn.send({
                    "t": "resp", "request_id": request_id,
                    "status": "shed", "ranked": [], "batch_size": 0,
                    "engine": self.engine_tag, "detail": "worker draining",
                })
                return
            self.inflight += 1
        self.loop.submit(req)
        spawn(
            self._serve_one,
            name=f"rca-fedw{self.worker_id}-wait{request_id[:8]}",
            daemon=True, args=(request_id, req),
        )

    # -- main loop ------------------------------------------------------------
    def run(self) -> int:
        """Connect → hello → serve until drain or coordinator loss.
        Returns the process exit code."""
        if not self._hello(with_lease=False):
            return 2
        self._hb_thread = spawn(
            self._hb_loop, name=f"rca-fedw{self.worker_id}-hb",
            daemon=True,
        )
        while True:
            try:
                msg = self.conn.recv()
            except FrameError:
                return 2
            if msg is None:
                # coordinator gone: nothing to answer to — exit; the
                # supervisor (or operator) restarts the fleet member
                return 0 if self.draining else 3
            t = msg.get("t")
            if t == "lease":
                with self._lock:
                    self.lease_id = str(msg.get("lease_id"))
                    self.heartbeat_s = float(
                        msg.get("heartbeat_s") or self.heartbeat_s
                    )
                self._rejoin_attempts = 0   # granted: backoff re-arms
            elif t == "reject":
                if str(msg.get("reason")) == "stale_lease":
                    refused = msg.get("lease_id")
                    with self._lock:
                        held = self.lease_id
                    if refused is not None and str(refused) != held:
                        # a reject of a lease this worker no longer holds
                        # (a heartbeat sent before its re-hello): the
                        # fresh hello is on the wire already, and dropping
                        # the lease it brings would re-hello again, past
                        # the TTL of the lease granted meanwhile
                        continue
                    # declared dead while hung/partitioned: rejoin with
                    # an explicit fresh hello (stale lease dropped) —
                    # after a jittered backoff, so a healing partition's
                    # worth of workers doesn't stampede the coordinator
                    with self._lock:
                        self.lease_id = None
                    self.sleeper(self._next_rejoin_delay())
                    if not self._hello(with_lease=False):
                        return 3
                else:
                    return 2
            elif t == "hb_ack":
                self.acks += 1
            elif t == "req":
                self._on_request(msg)
            elif t in ("ingest_assign", "ingest_unassign"):
                if self.ingest is not None:
                    self.ingest.handle(msg)
            elif t == "hang":
                with self._lock:
                    self.hang_until = self.clock() + float(
                        msg.get("for_s") or 0.0
                    )
            elif t == "drain":
                with self._lock:
                    self.draining = True
                if self.ingest is not None:
                    self.ingest.stop()
                deadline = self.clock() + REQUEST_TIMEOUT_S
                while self.clock() < deadline:
                    with self._lock:
                        if self.inflight == 0:
                            break
                    time.sleep(0.01)
                report = {}
                if self.role == "serve":
                    with suppressed("fedworker.drain_report"):
                        report = drain_report(self.loop)
                self.conn.send({"t": "drained", "served": self.served,
                                **report})
                return 0

    def close(self) -> None:
        self.conn.close()


def build_local_plane(config=None, device=None):
    """The worker's serving plane from its OWN environment on ``device``
    (default: the card; raises without one): one engine by default
    (``make_engine``, so ``RCA_SHARD`` decides dense or sharded); a
    replica mix (``RCA_SERVE_REPLICAS`` / ``RCA_SERVE_REPLICA_MIX``)
    builds a full in-process pool over this worker's devices: a
    federation of pools, not just loops."""
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine import make_engine
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.parallel.mesh import visible_devices
    from rca_tpu_torch.serve.loop import ServeLoop
    from rca_tpu_torch.serve.pool import ServePool

    cfg = config or ServeConfig.from_env()
    dev = resolve_device(device)
    if len(cfg.replica_specs()) > 1:
        return ServePool(config=cfg, devices=visible_devices(dev)), \
            "serve+pool"
    engine = make_engine(device=dev)
    return ServeLoop(engine=engine, config=cfg), getattr(
        engine, "engine_tag", type(engine).__name__
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rca_tpu_torch.serve.worker",
        description="federation serve worker",
    )
    parser.add_argument("--connect", required=True, metavar="HOST:PORT",
                        help="coordinator control address")
    parser.add_argument("--worker-id", type=int, required=True,
                        dest="worker_id")
    parser.add_argument("--role", choices=("serve", "ingest"),
                        default="serve",
                        help="worker class: serve (default) joins the "
                             "serve ring; ingest hosts cluster capture "
                             "mirrors and never touches the card")
    parser.add_argument("--device", default=None,
                        help="cuda | cpu (default: cuda; a serve worker "
                             "without a card raises)")
    args = parser.parse_args(argv)
    host, port = parse_hostport(args.connect, 0)
    if args.role == "ingest":
        # no engine, no serve plane: ingest workers never see requests
        from rca_tpu_torch.serve.ingest import NullServePlane

        loop, tag = NullServePlane(), "ingest"
    else:
        loop, tag = build_local_plane(device=args.device)
    loop.start()
    agent = WorkerAgent(args.worker_id, host, port, loop, engine_tag=tag,
                        role=args.role)
    if args.role == "ingest":
        from rca_tpu_torch.serve.ingest import IngestRunner

        agent.ingest = IngestRunner(agent)
    # the one stdout line: machine-parseable liveness for the procs
    # seam's capture (everything else goes to stderr)
    print(json.dumps({
        "worker": args.worker_id,
        "pid": os.getpid(),
        "coordinator": args.connect,
        "engine": tag,
    }), flush=True)
    try:
        code = agent.run()
    finally:
        agent.close()
        loop.stop()
    print(json.dumps({
        "worker": args.worker_id, "exit": code,
        "served": agent.served,
    }), file=sys.stderr, flush=True)
    return code


if __name__ == "__main__":   # pragma: no cover - subprocess entry
    sys.exit(main())
