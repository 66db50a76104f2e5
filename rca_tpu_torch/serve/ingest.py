"""Ingest worker runtime: hosting cluster capture mirrors in the fleet
(the port's copy of ``rca_tpu.serve.ingest``).

An ingest worker (``python -m rca_tpu_torch.serve.worker --role
ingest``) is a fleet member of a different class: it joins the
coordinator with ``role: "ingest"`` in its hello, lives on the ingest
ring instead of the serve ring, and owns COLUMNAR CAPTURE MIRRORS for the
clusters the coordinator assigns it (``ingest_assign`` frames,
rendezvous-routed on ``cluster_id:digest``).  For every assigned cluster
the :class:`IngestRunner` sweeps the cluster's ``get_columnar`` feed on
the ``RCA_INGEST_TICK_S`` cadence and reports one ``ingest_stat`` frame
per tick: cluster id, ownership epoch, monotone tick seq, sweep latency,
and coldiff payload bytes.  The COORDINATOR's cluster table is the
exactly-once arbiter: this process just ticks and reports; a deposed
owner's late stats are epoch-stale there, never double-applied.

An ingest worker never touches the card: it builds no engine, launches
no kernel and creates no CUDA context (its hello reports no device
memory), as the gateway never does.

Assignment specs carry the synthetic world parameters (services, seed,
namespace): the hermetic fleet drives generator-built clusters through
the same :class:`~rca_tpu_torch.cluster.mock_client.MockClusterClient`
and columnar master the parity gates test.  A live deployment would hand
the runner a connected
:class:`~rca_tpu_torch.cluster.k8s_client.K8sApiClient` instead; the
sweep loop is client-agnostic because ``get_columnar`` is.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, Optional

from rca_tpu_torch.util.threads import make_lock, spawn


class NullServePlane:
    """The 'serving plane' of an ingest worker: none.  Ingest workers
    are off the serve ring (nothing routes requests here), but the
    WorkerAgent surface expects a loop with start/stop/submit."""

    def start(self) -> "NullServePlane":
        return self

    def stop(self, *args: Any, **kwargs: Any) -> None:
        return None

    def submit(self, req: Any) -> bool:
        return False


def _payload_bytes(payload: Dict[str, Any]) -> int:
    """Wire-size accounting for one coldiff payload (ndarray-tolerant,
    never fatal — the stat is observability, not correctness)."""
    try:
        return len(json.dumps(
            payload, default=lambda o: (
                o.tolist() if hasattr(o, "tolist") else str(o)
            ),
        ))
    except Exception:  # noqa: BLE001 - stat only
        return 0


class IngestRunner:
    """The per-process capture loop behind one ingest WorkerAgent.

    One background thread sweeps every assigned cluster in sorted order
    each cycle; assignment state is swapped under a lock by the frame
    handler (:meth:`handle`), so a reassignment mid-cycle simply makes
    the next sweep skip the cluster.  Tick seqs resume from the
    coordinator's ``resume_seq`` — the rejoin/reclaim path continues the
    dead owner's count instead of restarting at zero (restarting would
    make every replayed seq look double-applied)."""

    def __init__(self, agent: Any, tick_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        from rca_tpu_torch.config import ingest_tick_s

        self.agent = agent
        self.clock = clock
        self.tick_s = float(
            ingest_tick_s() if tick_s is None else tick_s
        )
        self._lock = make_lock("IngestRunner._lock")
        #: cluster id -> {"epoch", "seq", "spec", "state"}
        self.assigned: Dict[str, Dict[str, Any]] = {}
        self.ticks_sent = 0
        self._stop = threading.Event()
        self._thread = spawn(
            self._loop,
            name=f"rca-ingest{getattr(agent, 'worker_id', '?')}",
            daemon=True,
        )

    # -- frame handling (called from the agent's read loop) -----------------
    def handle(self, msg: Dict[str, Any]) -> None:
        if msg.get("t") == "ingest_assign":
            self.assign(msg)
        else:
            self.unassign(msg)

    def assign(self, msg: Dict[str, Any]) -> None:
        cid = str(msg.get("cluster"))
        with self._lock:
            prev = self.assigned.get(cid)
            self.assigned[cid] = {
                "epoch": int(msg.get("epoch") or 0),
                "seq": int(msg.get("resume_seq") or 0),
                "spec": dict(msg.get("spec") or {}),
                # keep a rebuilt-once world across same-process
                # reassignments (epoch bumps reuse the mirror)
                "state": prev.get("state") if prev else None,
            }

    def unassign(self, msg: Dict[str, Any]) -> None:
        with self._lock:
            self.assigned.pop(str(msg.get("cluster")), None)

    def stop(self) -> None:
        self._stop.set()

    # -- the sweep loop ------------------------------------------------------
    def _build(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        from rca_tpu_torch.cluster.generator import synthetic_cascade_world
        from rca_tpu_torch.cluster.mock_client import MockClusterClient

        ns = str(spec.get("namespace") or "synthetic")
        world = synthetic_cascade_world(
            int(spec.get("services") or 6),
            seed=int(spec.get("seed") or 0),
            namespace=ns,
            pods_per_service=int(spec.get("pods_per_service") or 1),
        )
        return {
            "world": world, "client": MockClusterClient(world),
            "ns": ns, "cursor": None, "churn": 0,
        }

    def _tick(self, cid: str, st: Dict[str, Any]) -> None:
        if st["state"] is None:
            st["state"] = self._build(st["spec"])
        s = st["state"]
        world, ns = s["world"], s["ns"]
        pods = world.pods.get(ns) or []
        if pods:
            # deterministic churn: one metrics touch per sweep keeps
            # the coldiff stream non-trivial (quiet ticks still happen
            # between sweeps when nothing else changed)
            victim = pods[s["churn"] % len(pods)]
            world.touch(
                "pod_metrics", ns, victim["metadata"]["name"]
            )
            s["churn"] += 1
        t0 = self.clock()
        payload = s["client"].get_columnar(ns, s["cursor"])
        sweep_ms = (self.clock() - t0) * 1e3
        if payload.get("supported"):
            s["cursor"] = payload.get("cursor")
        st["seq"] += 1
        self.ticks_sent += 1
        self.agent.conn.send({
            "t": "ingest_stat",
            "cluster": cid,
            "epoch": st["epoch"],
            "tick_seq": st["seq"],
            "sweep_ms": round(sweep_ms, 3),
            "coldiff_bytes": _payload_bytes(payload),
            "full": bool(payload.get("full")),
        })

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                cids = sorted(self.assigned)
            for cid in cids:
                if self._stop.is_set():
                    return
                with self._lock:
                    st = self.assigned.get(cid)
                if st is not None:
                    try:
                        self._tick(cid, st)
                    except Exception:  # noqa: BLE001 - keep sweeping
                        # a torn-down conn mid-stop; the agent's read
                        # loop owns lifecycle, the sweep must not die
                        if self._stop.is_set():
                            return
            self._stop.wait(self.tick_s)
