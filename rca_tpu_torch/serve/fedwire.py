"""The federation's internal wire protocol (the port's copy of
``rca_tpu.serve.fedwire``; frames from either package read in the other).

Coordinator and worker processes speak length-prefixed JSON frames over
one TCP connection per worker: a 4-byte big-endian payload length, then
the UTF-8 JSON payload.  JSON because the analyze arrays already have a
proven bit-exact JSON encoding (:mod:`rca_tpu_torch.gateway.wire`:
float32 → JSON → float32 is the identity, which is what lets the
federation selftest demand bit parity between a worker's ranking and a
solo analysis instead of tolerances); length-prefixed because a frame
boundary must survive a worker dying mid-write (a short read is a clean,
detectable connection death, never a half-parsed message).

Message vocabulary (``t`` field):

=============  =========  =================================================
frame          direction  meaning
=============  =========  =================================================
``hello``      w → c      worker introduces itself (worker_id, pid, role,
                          engine, the bootstrap's process and device
                          counts; optional lease_id when re-joining: a
                          STALE lease is rejected and the worker must
                          re-hello fresh after a seeded jittered backoff).
                          Two OPTIONAL placement-evidence fields:
                          ``registry``, the kernel registry's winning
                          per-shape timings ``{n_pad: winner_ms}``, and
                          ``headroom``, ``{"bytes_in_use": N}`` of the
                          worker's CUDA allocator.  Absent fields mean
                          'no evidence': the worker places by pure
                          rendezvous
``lease``      c → w      lease grant: lease_id + ttl_s + heartbeat_s
``reject``     c → w      hello/heartbeat refused (stale_lease, bad_proto);
                          a stale_lease reject names the refused
                          ``lease_id`` (an optional field: a worker
                          ignores a reject of a lease it no longer holds)
``hb``         w → c      heartbeat (renews the lease)
``hb_ack``     c → w      heartbeat acknowledged
``req``        c → w      one analyze request (gateway-wire analyze body)
``resp``       w → c      terminal answer for one request_id
``hang``       c → w      CHAOS: stop heartbeating for ``for_s`` seconds
                          (the socket stays open: ``worker_hang``)
``drain``      c → w      stop accepting, finish in flight, answer
                          ``drained``, exit (fleet stop and scale-down
                          both retire workers with this; the
                          coordinator's ``draining`` flag on the handle
                          tells the two apart when ``drained`` lands)
``drained``    w → c      drain complete: ``served`` (the worker's
                          lifetime answer count) and, from a port worker,
                          two optional fields: ``launches`` (its kernel
                          launch counters) and ``kernel_rows`` (the
                          registry rows it served with)
``ingest_*``   both       the ingest ring: ``ingest_assign`` /
                          ``ingest_unassign`` (c → w) and one
                          ``ingest_stat`` per capture tick (w → c)
=============  =========  =================================================

The codec refuses frames over :data:`MAX_FRAME` loudly: an unbounded
length prefix is how one corrupt frame becomes an OOM.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional

from rca_tpu_torch.util.threads import make_lock

#: protocol version, checked at hello (mismatch = reject, not a guess)
PROTO = 1

#: hard frame cap: analyze bodies are feature matrices — 64 MiB covers
#: a 1M-row float32 wire body with room; anything larger is corruption
MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


class FrameError(ConnectionError):
    """A malformed frame (oversized length, non-JSON payload) — the
    connection is poisoned and must be dropped, not resynchronized."""


class FrameConn:
    """One framed connection: concurrent senders serialize on a lock
    (responses, heartbeats, and chaos frames interleave), reads are
    single-threaded by construction (one reader thread per connection).

    ``recv`` returns None on clean EOF — a dead peer is an ordinary
    value, not an exception, because worker death is the event the
    federation exists to absorb."""

    def __init__(self, sock: socket.socket, name: str = "fed"):
        self.sock = sock
        self.name = name
        self._wlock = make_lock("FrameConn._wlock")
        # one reader thread per connection by construction, but the
        # reader differs by deployment (coordinator conn loop, worker
        # main, thread-mode fleet members) — the lock makes the buffer
        # read-modify-write atomic whichever thread owns the read side
        self._rlock = make_lock("FrameConn._rlock")
        self._rbuf = b""
        self.closed = False

    # -- send ----------------------------------------------------------------
    def send(self, msg: Dict[str, Any]) -> bool:
        """Frame + write one message; False when the peer is gone (the
        caller treats that as worker/coordinator death, exactly like a
        recv EOF)."""
        payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        if len(payload) > MAX_FRAME:
            raise FrameError(
                f"{self.name}: outbound frame {len(payload)} B over the "
                f"{MAX_FRAME} B cap"
            )
        data = _LEN.pack(len(payload)) + payload
        with self._wlock:
            if self.closed:
                return False
            try:
                self.sock.sendall(data)
                return True
            except OSError:
                self.closed = True
                return False

    # -- recv ----------------------------------------------------------------
    def _read_exact(self, n: int) -> Optional[bytes]:
        while len(self._rbuf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None   # EOF mid-frame == peer death, clean stop
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def recv(self) -> Optional[Dict[str, Any]]:
        """The next message, or None when the peer is gone."""
        with self._rlock:
            head = self._read_exact(_LEN.size)
            if head is None:
                return None
            (length,) = _LEN.unpack(head)
            if length > MAX_FRAME:
                raise FrameError(
                    f"{self.name}: inbound frame claims {length} B "
                    f"(cap {MAX_FRAME} B) — poisoned stream"
                )
            payload = self._read_exact(length)
        if payload is None:
            return None
        try:
            msg = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise FrameError(f"{self.name}: non-JSON frame: {exc}")
        if not isinstance(msg, dict) or "t" not in msg:
            raise FrameError(f"{self.name}: frame without a 't' field")
        return msg

    def close(self) -> None:
        with self._wlock:
            self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


# -- request/response bodies --------------------------------------------------

def encode_request(req: Any) -> Dict[str, Any]:
    """A queued :class:`rca_tpu_torch.serve.request.ServeRequest` → the
    ``req`` frame.  The analyze payload reuses the gateway codec,
    inheriting its bit-parity argument verbatim."""
    from rca_tpu_torch.gateway.wire import encode_analyze

    return {
        "t": "req",
        "request_id": req.request_id,
        "priority": int(req.priority),
        "explain": bool(getattr(req, "explain", False)),
        "analyze": encode_analyze(
            req.features, req.dep_src, req.dep_dst, names=req.names,
            tenant=req.tenant, k=req.k,
        ),
    }


def decode_request_kwargs(msg: Dict[str, Any]) -> Dict[str, Any]:
    """``req`` frame → ``ServeRequest`` kwargs on the worker side (same
    decoder the gateway trusts; a malformed frame raises WireError and
    the worker answers ``error`` for that request_id)."""
    from rca_tpu_torch.gateway.wire import decode_analyze

    kwargs = decode_analyze(msg["analyze"])
    kwargs.pop("deadline_ms", None)     # deadlines live on the coordinator
    kwargs.pop("investigation_id", None)
    kwargs["priority"] = int(msg.get("priority", 1))
    kwargs["explain"] = bool(msg.get("explain", False))
    return kwargs


def encode_response(request_id: str, resp: Any, engine: str) -> Dict[str, Any]:
    """A worker-local :class:`ServeResponse` → the ``resp`` frame."""
    return {
        "t": "resp",
        "request_id": request_id,
        "status": resp.status,
        "ranked": resp.ranked,
        "detail": resp.detail,
        "batch_size": int(resp.batch_size),
        "engine": getattr(resp.result, "engine", None) or engine,
    }


class WireResult:
    """The coordinator-side stand-in for an ``EngineResult`` on wire
    responses: carries what crossed the process boundary (ranking +
    engine tag) so ``response_body`` and the parity gates read it like
    a local result; everything device-resident stayed in the worker."""

    __slots__ = ("ranked", "engine")

    def __init__(self, ranked: List[dict], engine: str):
        self.ranked = ranked
        self.engine = engine
