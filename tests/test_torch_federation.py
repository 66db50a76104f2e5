"""The port's cross-process serve plane (``rca_tpu_torch.serve.federation``,
``fedwire``, ``worker``, ``util.procs``) against the JAX package's.

- pure units on a fake clock, each held to the reference: the lease
  table (grant, renew, miss-one-keep-alive, expiry, the stale-lease
  reject) runs one operation script through both packages with the same
  answers; the rendezvous ring's owners and ``ranked`` orders equal the
  reference's key for key, before and after one of N workers dies (the
  bounded remap), and ``graph_route_key`` of the same numpy inputs is the
  reference's string; the config knobs;
- the frame codec: ``encode_request`` / ``encode_response`` dicts equal
  the reference's, and frames written by either package's ``FrameConn``
  are read by the other's over a socketpair;
- the control plane against in-process fake workers speaking the real
  protocol over loopback: sticky routing (the serving worker is the
  reference ring's owner), exactly-once under 8 racing submitters and a
  kill, a hung worker's late answers dropped as stale, a backlogged
  worker keeping its lease, the mute-then-rejoin lease, the coordinator partition, the no-fleet ladder, ``stop``
  resolving everything, and the gateway's lease-fed ``/healthz`` that the
  ``fleet`` command renders;
- the procs seam (capture, the kill ladder) and the worker's seeded
  rejoin backoff against the reference's.

The real-process gates (``--device cpu`` workers) are in
``tests/test_torch_federation_procs.py``.  Every wait takes a timeout
and every plane is stopped in ``finally``.
"""

import math
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

from rca_tpu.serve import federation as ref_fed
from rca_tpu.serve import fedwire as ref_wire
from rca_tpu.serve.request import ServeRequest as RefRequest
from rca_tpu.serve.request import ServeResponse as RefResponse
from rca_tpu_torch.serve import federation as fed
from rca_tpu_torch.serve import fedwire
from rca_tpu_torch.serve.federation import (
    FED_FAULT_CLASSES,
    FederationPlane,
    HashRing,
    LeaseTable,
    graph_route_key,
)
from rca_tpu_torch.serve.fedwire import FrameConn, FrameError, PROTO
from rca_tpu_torch.serve.request import ServeRequest, ServeResponse
from rca_tpu_torch.util.net import make_client_socket
from rca_tpu_torch.util.threads import spawn


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _arrays(n=8, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 14), dtype=np.float32)
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    return feats, src, dst


def _req(tenant="t", n=8, seed=0, cls=ServeRequest, **kw):
    feats, src, dst = _arrays(n, seed)
    return cls(tenant=tenant, features=feats, dep_src=src, dep_dst=dst, **kw)


def _keys(k: int):
    return [f"{64 + i}/14/{128 + i}/d{i:05x}" for i in range(k)]


# ---------------------------------------------------------------------------
# Leases on a fake clock, one script through both packages
# ---------------------------------------------------------------------------


def _lease_script(mod):
    """The lease state machine's answers to one operation sequence."""
    clock = FakeClock()
    leases = mod.LeaseTable(heartbeat_s=0.5, lease_misses=3, clock=clock)
    out = {"ttl": leases.ttl_s}
    first = leases.grant(7)
    out["grant"] = (first.worker_id, first.ttl_s, first.granted_at)
    clock.advance(0.6)                       # one late heartbeat...
    out["alive_late"] = leases.alive(7)      # ...keeps the worker alive
    out["renew"] = leases.renew(7, first.lease_id)
    out["renewals"] = first.renewals
    clock.advance(1.49)
    out["alive_inside"] = leases.alive(7)
    clock.advance(0.02)                      # past 3 misses
    out["expired"] = [(w, round(o, 6)) for w, o in leases.expired_workers()]
    out["renew_expired"] = leases.renew(7, first.lease_id)
    fresh = leases.grant(7)
    out["stale_reject"] = leases.renew(7, first.lease_id)
    out["fresh_renew"] = leases.renew(7, fresh.lease_id)
    out["unknown"] = leases.renew(99, fresh.lease_id)
    leases.revoke(7)
    out["revoked"] = leases.alive(7)
    return out


def test_lease_table_answers_equal_the_reference():
    got, want = _lease_script(fed), _lease_script(ref_fed)
    assert got == want
    assert got["alive_late"] and got["renew"] and got["alive_inside"]
    assert got["expired"] and got["expired"][0][0] == 7
    assert not got["renew_expired"] and not got["stale_reject"]
    assert got["fresh_renew"] and not got["revoked"]


def test_a_credit_pushes_every_lease_out_by_the_stall():
    clock = FakeClock(0.0)
    leases = fed.LeaseTable(heartbeat_s=0.5, lease_misses=3, clock=clock)
    a, b = leases.grant(1), leases.grant(2)
    clock.advance(1.0)
    assert leases.renew(2, b.lease_id)
    clock.advance(1.0)                       # 1's lease is 0.5 s overdue
    leases.credit(0.75)
    assert leases.expired_workers() == []
    assert leases.renew(1, a.lease_id)
    assert b.expires_at() == pytest.approx(1.0 + 0.75 + 1.5)


@pytest.mark.parametrize("kwargs", [
    {"heartbeat_s": 0.0, "lease_misses": 3},
    {"heartbeat_s": 0.5, "lease_misses": 1},
])
def test_lease_table_rejects_bad_params_like_the_reference(kwargs):
    with pytest.raises(ValueError) as mine:
        LeaseTable(**kwargs)
    with pytest.raises(ValueError) as theirs:
        ref_fed.LeaseTable(**kwargs)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# The rendezvous ring and the route key
# ---------------------------------------------------------------------------


def test_ring_owner_and_ranked_equal_the_reference():
    mine, theirs = HashRing(), ref_fed.HashRing()
    for n in (3, 0, 2, 1):
        mine.add(n)
        theirs.add(n)
    assert mine.nodes == theirs.nodes == (0, 1, 2, 3)
    for key in _keys(64):
        assert mine.ranked(key) == theirs.ranked(key)
        assert mine.owner(key) == theirs.owner(key)
    assert HashRing().owner("x") is None


@pytest.mark.parametrize("dead", [0, 1, 2])
def test_ring_remap_bound_when_one_of_n_dies(dead):
    """Kill any one of N=3 workers over K=64 keys: exactly the dead
    worker's keys move (as in the reference's ring), at most ceil(K/N),
    and re-adding it restores the exact map."""
    K, N = 64, 3
    mine, theirs = HashRing(), ref_fed.HashRing()
    for n in range(N):
        mine.add(n)
        theirs.add(n)
    keys = _keys(K)
    before = {k: mine.owner(k) for k in keys}
    mine.remove(dead)
    theirs.remove(dead)
    after = {k: mine.owner(k) for k in keys}
    assert after == {k: theirs.owner(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert all(before[k] == dead for k in moved)
    assert len(moved) == sum(1 for k in keys if before[k] == dead)
    assert len(moved) <= math.ceil(K / N)
    mine.add(dead)
    assert {k: mine.owner(k) for k in keys} == before


@pytest.mark.parametrize("n,seed", [(8, 1), (9, 2), (60, 3)])
def test_graph_route_key_equals_the_reference(n, seed):
    mine = _req(n=n, seed=seed)
    theirs = _req(n=n, seed=seed, cls=RefRequest)
    assert graph_route_key(mine.graph_key) == ref_fed.graph_route_key(
        theirs.graph_key)
    assert graph_route_key(mine.graph_key) == graph_route_key(
        _req(n=n, seed=seed).graph_key)
    assert graph_route_key(mine.graph_key) != graph_route_key(
        _req(n=n + 1, seed=seed).graph_key)


def test_fault_class_vocabularies_equal_the_reference():
    assert FED_FAULT_CLASSES == ref_fed.FED_FAULT_CLASSES
    assert fed.INGEST_FAULT_CLASS == ref_fed.INGEST_FAULT_CLASS


# ---------------------------------------------------------------------------
# The frame codec, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("explain", [False, True])
def test_encode_request_equals_the_reference(explain):
    mine = _req(tenant="acme", n=12, seed=5, k=3, priority=0,
                explain=explain)
    theirs = _req(tenant="acme", n=12, seed=5, k=3, priority=0,
                  explain=explain, cls=RefRequest)
    a, b = fedwire.encode_request(mine), ref_wire.encode_request(theirs)
    a.pop("request_id")
    b.pop("request_id")
    assert a == b
    msg = fedwire.encode_request(mine)
    kwargs = fedwire.decode_request_kwargs(msg)
    assert kwargs == {**ref_wire.decode_request_kwargs(msg),
                      "features": kwargs["features"],
                      "dep_src": kwargs["dep_src"],
                      "dep_dst": kwargs["dep_dst"]}
    twin = ServeRequest(**kwargs)
    assert np.array_equal(twin.features, mine.features)
    assert twin.features.dtype == np.float32
    assert twin.graph_key == mine.graph_key
    assert twin.explain is explain and twin.k == 3


@pytest.mark.parametrize("status", ["ok", "shed", "degraded", "error"])
def test_encode_response_equals_the_reference(status):
    ranked = [{"component": "svc-3", "score": 0.75}] if status != "shed" \
        else []
    kw = dict(status=status, request_id="r1", tenant="t", ranked=ranked,
              detail=None if status == "ok" else "why", batch_size=2)
    a = fedwire.encode_response("r1", ServeResponse(**kw), "single")
    b = ref_wire.encode_response("r1", RefResponse(**kw), "single")
    assert a == b


def _pair(writer_mod, reader_mod):
    a, b = socket.socketpair()
    return writer_mod.FrameConn(a, "w"), reader_mod.FrameConn(b, "r")


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port",
                                       "port_to_port"])
def test_frames_cross_the_packages_over_a_socketpair(direction):
    writer_mod, reader_mod = {
        "port_to_ref": (fedwire, ref_wire),
        "ref_to_port": (ref_wire, fedwire),
        "port_to_port": (fedwire, fedwire),
    }[direction]
    w, r = _pair(writer_mod, reader_mod)
    try:
        req = _req(tenant="x", n=16, seed=4, k=5)
        frames = [
            {"t": "hello", "proto": PROTO, "worker_id": 3, "pid": 1,
             "registry": {"2048": 0.5}, "headroom": {"bytes_in_use": 7}},
            fedwire.encode_request(req),
            {"t": "drained", "served": 4},
        ]
        for frame in frames:
            assert w.send(frame)
        for frame in frames:
            assert r.recv() == frame
        got = ServeRequest(**reader_mod.decode_request_kwargs(frames[1]))
        assert np.array_equal(got.features, req.features)
        w.close()
        assert r.recv() is None      # clean EOF = peer death, not an error
    finally:
        w.close()
        r.close()


def test_frame_protocol_constants_equal_the_reference():
    assert fedwire.PROTO == ref_wire.PROTO == 1
    assert fedwire.MAX_FRAME == ref_wire.MAX_FRAME == 64 * 1024 * 1024


@pytest.mark.parametrize("payload,ok", [
    (struct.pack(">I", 1 << 31), False),            # over MAX_FRAME
    (struct.pack(">I", 4) + b"\xff\xfe{}", False),  # not UTF-8 JSON
    (struct.pack(">I", 2) + b"[]", False),          # no 't' field
])
def test_poisoned_frames_raise_in_both_packages(payload, ok):
    for mod in (fedwire, ref_wire):
        a, b = socket.socketpair()
        conn = mod.FrameConn(b, "b")
        try:
            a.sendall(payload)
            with pytest.raises(mod.FrameError):
                conn.recv()
        finally:
            a.close()
            conn.close()


def test_outbound_frame_over_the_cap_raises(monkeypatch):
    monkeypatch.setattr(fedwire, "MAX_FRAME", 16)
    a, b = socket.socketpair()
    conn = FrameConn(a, "a")
    try:
        with pytest.raises(FrameError):
            conn.send({"t": "x", "pad": "0123456789abcdef"})
    finally:
        conn.close()
        b.close()


# ---------------------------------------------------------------------------
# Config knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,value", [
    ("RCA_FED_WORKERS", "5"), ("RCA_FED_HEARTBEAT_S", "0.25"),
    ("RCA_FED_LEASE_MISSES", "4"), ("RCA_FED_WINDOW", "16"),
    ("RCA_INGEST_TICK_S", "0.5"), ("RCA_FED_LEASE_MISSES", "1"),
    ("RCA_FED_WORKERS", "0"), ("RCA_FED_WINDOW", "abc"), (None, None),
])
def test_fed_knobs_equal_the_reference(monkeypatch, name, value):
    from rca_tpu import config as ref_config
    from rca_tpu_torch import config

    if name is not None:
        monkeypatch.setenv(name, value)
    for fn in ("fed_workers", "fed_heartbeat_s", "fed_lease_misses",
               "fed_window", "ingest_tick_s"):
        try:
            want = getattr(ref_config, fn)()
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                getattr(config, fn)()
            assert str(got.value) == str(exc)
        else:
            assert getattr(config, fn)() == want


# ---------------------------------------------------------------------------
# The procs seam and the rejoin backoff
# ---------------------------------------------------------------------------


def test_procs_spawn_capture_and_join():
    from rca_tpu_torch.util.procs import python_argv, spawn_worker

    w = spawn_worker("echo", [
        sys.executable, "-c",
        "import sys; print('out-line'); print('err-line', file=sys.stderr)",
    ])
    assert w.join(60.0) == 0
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        out, err = w.output()
        if "out-line" in out and "err-line" in err:
            break
        time.sleep(0.05)
    assert "out-line" in out and "err-line" in err
    assert not w.alive() and w.returncode == 0
    assert python_argv("m", "--x") == [sys.executable, "-m", "m", "--x"]


def test_procs_kill_ladder_and_capture_cap():
    from rca_tpu_torch.util import procs

    w = procs.spawn_worker("sleeper", [
        sys.executable, "-c", "import time; time.sleep(600)"])
    assert w.alive() and w.pid > 0
    rc = w.kill()
    assert rc is not None and rc != 0
    assert not w.alive()
    assert w.terminate() == rc       # idempotent on a dead child
    chatty = procs.spawn_worker("chatty", [
        sys.executable, "-c",
        "import sys\nfor i in range(6000): print('x' * 99)"])
    assert chatty.join(60.0) == 0
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not chatty.output()[0].endswith(
            "x" * 99 + "\n"):
        time.sleep(0.05)
    time.sleep(0.2)
    out, _ = chatty.output()
    assert 0 < len(out) <= procs.CAPTURE_CAP


def test_procs_exiting_reads_the_childs_state():
    """``exiting`` is False while the child runs and True once it is
    killed: reaped, or a zombie read from ``/proc`` before the reap."""
    import os
    import signal

    from rca_tpu_torch.util import procs

    w = procs.spawn_worker("sleeper", [
        sys.executable, "-c", "import time; time.sleep(600)"])
    try:
        assert w.alive() and not w.exiting()
        os.kill(w.pid, signal.SIGKILL)       # dead, not reaped yet
        assert _wait(w.exiting, timeout_s=10.0)
    finally:
        w.kill()
    assert w.exiting()


def test_rejoin_backoff_is_the_references_for_the_same_seed():
    """Seeded, jittered, distinct delays: the port's worker agent and the
    reference's give the same sequence (both connect to a port plane)."""
    from rca_tpu.serve.worker import WorkerAgent as RefAgent
    from rca_tpu_torch.serve.ingest import NullServePlane
    from rca_tpu_torch.serve.worker import WorkerAgent

    plane = FederationPlane(workers=1, spawn_workers=False).start()
    agents = []
    try:
        for cls in (WorkerAgent, RefAgent):
            agent = cls(4, plane.host, plane.port, NullServePlane(),
                        rejoin_seed=11)
            agents.append(agent)
            for _ in range(8):
                agent._next_rejoin_delay()
        mine, theirs = (a.rejoin_delays for a in agents)
        assert mine == theirs
        assert len(set(mine)) == len(mine)
        assert max(mine) <= 2.0 * 1.5
    finally:
        for agent in agents:
            agent.close()
        plane.stop(timeout=2.0)


# ---------------------------------------------------------------------------
# The control plane against fake workers (the real wire protocol)
# ---------------------------------------------------------------------------


class FakeWorker:
    """An in-process worker speaking the real protocol over a loopback
    socket.  ``behavior``: ``serve`` (heartbeat, answer every request ok,
    naming itself in the ranking), ``slow`` (the same, reading each
    request 50 ms late), ``hold`` (heartbeat, hold requests until
    :meth:`release_held` answers them late), ``mute`` (no
    heartbeats)."""

    def __init__(self, worker_id, plane, behavior="serve",
                 heartbeat_s=0.05):
        self.worker_id = worker_id
        self.behavior = behavior
        self.heartbeat_s = heartbeat_s
        self.lease_id = None
        self.held = []
        self.served = 0
        self.rejected = 0
        self._lock = threading.Lock()
        sock = make_client_socket(f"fake{worker_id}", plane.host,
                                  plane.port)
        self.conn = FrameConn(sock, name=f"fake{worker_id}")
        self._hello()
        self._reader = spawn(self._read_loop, name=f"fake{worker_id}-read",
                             daemon=True)
        self._hb = spawn(self._hb_loop, name=f"fake{worker_id}-hb",
                         daemon=True)

    def _hello(self):
        self.conn.send({"t": "hello", "proto": PROTO,
                        "worker_id": self.worker_id, "pid": 0,
                        "engine": "fake"})

    def _answer(self, request_id):
        self.conn.send({
            "t": "resp", "request_id": request_id, "status": "ok",
            "ranked": [{"component": f"svc-{self.worker_id}",
                        "score": 1.0}],
            "batch_size": 1, "engine": "fake",
        })

    def _read_loop(self):
        while True:
            try:
                msg = self.conn.recv()
            except (FrameError, OSError):
                return
            if msg is None:
                return
            t = msg.get("t")
            if t == "lease":
                with self._lock:
                    self.lease_id = msg["lease_id"]
            elif t == "reject":
                with self._lock:
                    self.rejected += 1
                    self.lease_id = None
                self._hello()
            elif t == "req":
                if self.behavior == "hold":
                    with self._lock:
                        self.held.append(msg["request_id"])
                else:
                    if self.behavior == "slow":
                        time.sleep(0.05)   # a reader slower than the router
                    self._answer(msg["request_id"])
                    self.served += 1
            elif t == "drain":
                self.conn.send({"t": "drained", "served": self.served})

    def _hb_loop(self):
        seq = 0
        while not self.conn.closed:
            time.sleep(self.heartbeat_s)
            with self._lock:
                lease = self.lease_id
            if lease is None or self.behavior == "mute":
                continue
            seq += 1
            if not self.conn.send({"t": "hb", "worker_id": self.worker_id,
                                   "lease_id": lease, "seq": seq}):
                return

    def release_held(self):
        with self._lock:
            held, self.held = self.held, []
        for rid in held:
            self._answer(rid)

    def close(self):
        self.conn.close()


def _plane(**kw):
    kw.setdefault("heartbeat_s", 0.05)
    kw.setdefault("lease_misses", 3)
    return FederationPlane(workers=1, spawn_workers=False, **kw).start()


def _join(plane, n, behaviors=None, **kw):
    fakes = [FakeWorker(i, plane, behavior=(behaviors or {}).get(i, "serve"),
                        **kw) for i in range(n)]
    assert plane.wait_ready(n, timeout_s=30.0)
    return fakes


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _downed(plane, klass=None, wid=None):
    return any(e["event"] == "worker_down"
               and (klass is None or e.get("class") == klass)
               and (wid is None or e["worker_id"] == wid)
               for e in list(plane.events))


def test_plane_routes_sticky_to_the_reference_rings_owner():
    plane = _plane()
    fakes = _join(plane, 3)
    ring = ref_fed.HashRing()
    for n in range(3):
        ring.add(n)
    try:
        for seed, n in ((9, 8), (10, 12), (11, 30)):
            reqs = [_req(seed=seed, n=n) for _ in range(5)]   # one graph
            for r in reqs:
                assert plane.submit(r)
            assert all(r.result(30.0).ok for r in reqs)
            servers = {r.response.ranked[0]["component"] for r in reqs}
            owner = ring.owner(ref_fed.graph_route_key(
                _req(seed=seed, n=n, cls=RefRequest).graph_key))
            assert servers == {f"svc-{owner}"}
        assert plane.metrics.summary()["placement"]["rendezvous"] == 15
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_exactly_once_eight_threads_racing_worker_kill():
    plane = _plane()
    fakes = _join(plane, 3)
    all_reqs = []
    lock = threading.Lock()
    try:
        def submitter(w):
            for i in range(12):
                r = _req(tenant=f"t{w}", seed=(w * 31 + i) % 7,
                         n=8 + (i % 3))
                with lock:
                    all_reqs.append(r)
                plane.submit(r)
                if w == 0 and i == 4:
                    fakes[1].close()          # process death mid-storm
        threads = [threading.Thread(target=submitter, args=(w,),
                                    name=f"race-{w}", daemon=True)
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        responses = [r.result(30.0) for r in all_reqs]
        assert len(responses) == 96
        assert all(r.status in ("ok", "shed", "degraded", "error")
                   for r in responses)
        assert plane.sink.double_completions == 0
        assert _wait(lambda: _downed(plane, "process_kill", 1))
        assert 1 not in plane.live_workers()
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_plane_and_leases_under_rsan():
    """The federation plane's in-process parts with every lock sanitized:
    eight threads hammer one ``LeaseTable`` (grant, renew, alive, sweep,
    credit) while eight submitters race a worker kill through a plane
    over three fake workers — every request terminal once, no observed
    race, no lock-order contradiction against the port's static model,
    and the lease table's, the plane's and the queue's locks taken from
    several threads."""
    from rca_tpu_torch.analysis.concurrency import model_for, rsan
    from rca_tpu_torch.analysis.concurrency.crosscheck import (
        order_contradictions,
    )
    from rca_tpu_torch.analysis.core import repo_root

    was = rsan.enabled()
    rsan.enable()
    rsan.RSAN.reset()
    try:
        table = LeaseTable(heartbeat_s=1.0, lease_misses=3)

        def leases(w):
            for i in range(200):
                lease = table.grant(w % 4)
                table.renew(w % 4, lease.lease_id)
                table.alive((w + 1) % 4)
                table.expired_workers()
                if i % 50 == 0:
                    table.credit(0.001)

        hammer = [threading.Thread(target=leases, args=(w,),
                                   name=f"lease-{w}", daemon=True)
                  for w in range(8)]
        for t in hammer:
            t.start()
        for t in hammer:
            t.join(30.0)
        assert all(table.alive(w) for w in range(4))

        plane = _plane()
        fakes = _join(plane, 3)
        all_reqs = []
        lock = threading.Lock()
        try:
            def submitter(w):
                for i in range(12):
                    r = _req(tenant=f"t{w}", seed=(w * 31 + i) % 7,
                             n=8 + (i % 3))
                    with lock:
                        all_reqs.append(r)
                    plane.submit(r)
                    if w == 0 and i == 4:
                        fakes[1].close()
            threads = [threading.Thread(target=submitter, args=(w,),
                                        name=f"race-{w}", daemon=True)
                       for w in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            responses = [r.result(30.0) for r in all_reqs]
            assert len(responses) == 96
            assert plane.sink.double_completions == 0
        finally:
            plane.stop()
            for f in fakes:
                f.close()

        assert rsan.RSAN.races_observed() == []
        lt = rsan.RSAN.lock_threads()
        for name in ("LeaseTable._lock", "FederationPlane._lock",
                     "RequestQueue._cond", "ServeMetrics._lock"):
            assert len(lt.get(name, ())) >= 2, name
        assert order_contradictions(
            model_for(repo_root()).static_order_edges(),
            rsan.RSAN.order_edges()) == []
    finally:
        rsan.RSAN.reset()
        if not was:
            rsan.disable()


def test_hung_worker_late_answers_dropped_as_stale():
    plane = _plane()
    fakes = _join(plane, 2, behaviors={0: "hold"})
    try:
        reqs = [_req(seed=s, n=8 + s % 4) for s in range(8)]
        for r in reqs:
            plane.submit(r)
        # every request either answered by worker 1 or held by worker 0
        assert _wait(lambda: sum(r.done() for r in reqs)
                     + len(fakes[0].held) == len(reqs))
        held_n = len(fakes[0].held)
        assert held_n > 0
        fakes[0].behavior = "mute"      # heartbeats stop: a hang
        assert _wait(lambda: _downed(plane, "worker_hang", 0))
        responses = [r.result(30.0) for r in reqs]
        assert all(r.status == "ok" for r in responses)
        assert all(r.ranked[0]["component"] == "svc-1" for r in responses)
        fakes[0].release_held()         # the hung worker answers LATE
        assert _wait(lambda: plane.stale_responses >= held_n)
        assert plane.sink.double_completions == 0
        assert plane.reroutes >= held_n
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_mute_worker_expires_and_rejoins_with_fresh_lease():
    plane = _plane()
    fakes = _join(plane, 2)
    try:
        fakes[0].behavior = "mute"
        assert _wait(lambda: _downed(plane, wid=0))
        assert 0 not in plane.live_workers()
        fakes[0].behavior = "serve"     # stale hb → reject → re-hello
        assert _wait(lambda: any(e["event"] == "rejoin"
                                 and e["worker_id"] == 0
                                 for e in list(plane.events)))
        assert 0 in plane.live_workers()
        assert fakes[0].rejected >= 1
    finally:
        plane.stop()
        for f in fakes:
            f.close()


@pytest.mark.parametrize("names_lease", [True, False])
def test_a_reject_of_a_lease_no_longer_held_keeps_the_fresh_one(
        names_lease):
    """Heartbeats on the old lease that crossed the worker's re-hello are
    refused one by one.  The worker re-hellos once and keeps the lease
    that hello brings: it used to drop it on the second reject, re-hello
    again and let the lease granted meanwhile lapse, a second down (a
    ``worker_hang``) of a worker that had just rejoined.  A reject that
    names no lease (the reference's coordinator) still re-hellos."""
    from rca_tpu_torch.serve.ingest import NullServePlane
    from rca_tpu_torch.serve.worker import WorkerAgent
    from rca_tpu_torch.util.net import bound_address, make_server_socket

    server = make_server_socket("test-coordinator", "127.0.0.1", 0)
    host, port = bound_address(server)
    server.settimeout(10.0)
    agent = WorkerAgent(0, host, port, NullServePlane(),
                        sleeper=lambda s: None)
    runner = spawn(agent.run, name="stale-reject-agent", daemon=True)
    client, _ = server.accept()
    client.settimeout(10.0)
    coord = FrameConn(client, name="test-coordinator")

    def frames_until(kind):
        while True:
            msg = coord.recv()
            assert msg is not None, f"worker closed before a {kind}"
            if msg["t"] == kind:
                return msg

    try:
        assert frames_until("hello").get("lease_id") is None
        # a cadence far past the test: no heartbeat of its own
        coord.send({"t": "lease", "lease_id": "L0", "ttl_s": 600.0,
                    "heartbeat_s": 300.0})
        assert _wait(lambda: agent.lease_id == "L0")
        refusal = {"t": "reject", "reason": "stale_lease"}
        if names_lease:
            refusal["lease_id"] = "L0"
        coord.send(refusal)
        coord.send(refusal)      # a second heartbeat that was in flight
        assert frames_until("hello").get("lease_id") is None
        coord.send({"t": "lease", "lease_id": "L1", "ttl_s": 600.0,
                    "heartbeat_s": 300.0})
        if names_lease:
            assert _wait(lambda: agent.lease_id == "L1")
            coord.send({"t": "drain"})
            assert frames_until("drained")["t"] == "drained"
            assert len(agent.rejoin_delays) == 1
        else:
            # the reference's behaviour: each reject re-hellos
            assert frames_until("hello").get("lease_id") is None
            assert len(agent.rejoin_delays) == 2
    finally:
        coord.close()
        server.close()
        runner.join(10.0)
    assert not runner.is_alive()


class _TearingDownProc:
    """A SIGKILLed CUDA worker mid-exit: not reaped, its socket still
    open.  ``flagged`` is whether ``/proc`` already shows it exiting."""

    def __init__(self, flagged):
        self.flagged = flagged
        self.kills = 0

    def alive(self):
        return True

    def exiting(self):
        return self.flagged

    def kill(self):
        self.kills += 1

    def terminate(self, grace_s=None):
        return None


def test_a_killed_worker_whose_lease_expires_before_its_eof_is_a_kill():
    """The plane SIGKILLed the process, whose socket outlives the lease:
    the lease monitor downs it, and the class is still process_kill."""
    plane = _plane()
    fakes = _join(plane, 2)
    proc = _TearingDownProc(flagged=False)
    try:
        with plane._lock:
            plane.workers[1].proc = proc
        fakes[1].behavior = "mute"           # no heartbeat after the kill
        assert plane.kill_worker(1) and proc.kills == 1
        assert _wait(lambda: _downed(plane, wid=1))
        down = [e for e in plane.events
                if e["event"] == "worker_down" and e["worker_id"] == 1]
        assert [(e["class"], e["eof"]) for e in down] == [
            ("process_kill", False)]
        assert plane.fault_classes_observed() == ["process_kill"]
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_an_exiting_process_is_downed_before_its_lease_is_judged():
    """A process killed from outside the plane, exiting but not reaped
    and its socket open: the monitor's sweep downs it as a process_kill
    long before its 3 s lease would expire."""
    plane = _plane(heartbeat_s=1.0)
    fakes = _join(plane, 2, heartbeat_s=0.05)
    proc = _TearingDownProc(flagged=False)
    try:
        with plane._lock:
            plane.workers[0].proc = proc
        fakes[0].behavior = "mute"
        t0 = time.monotonic()
        proc.flagged = True
        assert _wait(lambda: _downed(plane, wid=0), timeout_s=10.0)
        assert time.monotonic() - t0 < plane.leases.ttl_s
        down = [e for e in plane.events
                if e["event"] == "worker_down" and e["worker_id"] == 0]
        assert [(e["class"], e["eof"]) for e in down] == [
            ("process_kill", True)]
        assert proc.kills == 0
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_a_backlogged_worker_keeps_its_lease():
    """A slow reader gets large frames for far longer than a lease: it
    still heartbeats, so the coordinator goes on renewing its lease and
    no request moves."""
    plane = _plane(heartbeat_s=0.2)        # a 0.6 s lease
    fakes = _join(plane, 1, behaviors={0: "slow"}, heartbeat_s=0.05)
    try:
        # ~0.6 MB each, read 50 ms apart: a backlog of ~2 s
        reqs = [_req(seed=5, n=3000) for _ in range(40)]
        for r in reqs:
            plane.submit(r)
        assert all(r.result(60.0).ok for r in reqs)
        assert not _downed(plane), plane.events
        assert plane.reroutes == 0 and plane.stale_responses == 0
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_the_worker_table_reports_heartbeat_timing():
    """A port worker stamps each heartbeat with its send time: the table
    shows the longest gap between sends, between readings here, and from
    a send to its reading.  A heartbeat without the stamp (the
    reference's worker) still times the readings."""
    from rca_tpu_torch.serve.ingest import NullServePlane
    from rca_tpu_torch.serve.worker import WorkerAgent

    plane = _plane()                        # 0.05 s cadence
    agent = WorkerAgent(0, plane.host, plane.port, NullServePlane())
    runner = spawn(agent.run, name="hb-timing-agent", daemon=True)
    fakes = []
    try:
        assert plane.wait_ready(1, timeout_s=30.0)
        fakes = [FakeWorker(1, plane)]
        assert plane.wait_ready(2, timeout_s=30.0)
        assert _wait(lambda: all(row["lease_renewals"] >= 5
                                 for row in plane.worker_table()))
        rows = {row["worker_id"]: row for row in plane.worker_table()}
        mine, ref_shaped = rows[0], rows[1]
        assert 0.04 <= mine["hb_send_gap_max_s"] < 5.0
        assert 0.0 < mine["hb_recv_gap_max_s"] < 5.0
        assert 0.0 <= mine["hb_lag_max_s"] < 5.0
        assert ref_shaped["hb_send_gap_max_s"] == 0.0
        assert ref_shaped["hb_lag_max_s"] == 0.0
        assert 0.0 < ref_shaped["hb_recv_gap_max_s"] < 5.0
    finally:
        agent.close()
        runner.join(10.0)
        plane.stop()
        for f in fakes:
            f.close()


def test_heartbeat_timing_folds_the_worst_case():
    w = fed._WorkerHandle(0)
    for sent, read in ((1.0, 1.1), (1.5, 2.4), (2.0, 2.45), (4.0, 4.05)):
        w.note_heartbeat(sent, read)
    w.note_heartbeat(None, 4.5)
    row = w.summary()
    assert row["hb_send_gap_max_s"] == pytest.approx(2.0)
    assert row["hb_recv_gap_max_s"] == pytest.approx(1.6)
    assert row["hb_lag_max_s"] == pytest.approx(0.9)


def test_a_stall_of_the_coordinator_convicts_no_worker():
    """The coordinator's clock jumps 5 s past its workers' 3 s leases
    between two sweeps of its monitor: the sweep comes late, credits the
    stall to every lease, and no worker is declared dead.  The workers
    send no heartbeat, so only the monitor judges."""
    offset = [0.0]
    plane = _plane(heartbeat_s=1.0,         # a 3 s lease, a sweep a 0.5 s
                   clock=lambda: time.monotonic() + offset[0])
    fakes = _join(plane, 2, behaviors={0: "mute", 1: "mute"})
    try:
        time.sleep(0.2)
        offset[0] += 5.0
        time.sleep(0.8)
        assert not _downed(plane), plane.events
        assert plane.stall_max_s >= 4.9
        assert sorted(plane.live_workers()) == [0, 1]
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_no_fleet_rides_the_ladder_instead_of_hanging():
    plane = _plane()
    try:
        req = _req(seed=3)
        plane.submit(req)
        resp = req.result(30.0)
        assert resp.status == "error"
        assert "no_worker" in resp.detail
    finally:
        plane.stop()


def test_coordinator_partition_drops_frames_then_heals():
    plane = _plane()
    fakes = _join(plane, 2)
    try:
        plane.partition(0, for_s=plane.leases.ttl_s * 3)
        assert _wait(lambda: _downed(plane, "coordinator_partition", 0))
        assert _wait(lambda: any(e["event"] == "rejoin"
                                 and e["worker_id"] == 0
                                 for e in list(plane.events)))
        assert 0 in plane.live_workers()
        assert plane.fault_classes_observed() == ["coordinator_partition"]
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_plane_stop_resolves_everything():
    plane = _plane()
    fakes = _join(plane, 1, behaviors={0: "hold"})
    try:
        reqs = [_req(seed=s) for s in range(4)]
        for r in reqs:
            plane.submit(r)
        assert _wait(lambda: len(fakes[0].held) == 4)
    finally:
        plane.stop(timeout=2.0)
        for f in fakes:
            f.close()
    assert all(r.done() for r in reqs)
    assert {r.response.status for r in reqs} == {"error"}


def test_drain_worker_retires_without_a_fault():
    plane = _plane()
    fakes = _join(plane, 2)
    try:
        assert plane.drain_worker(1)
        assert not plane.drain_worker(1)        # already draining
        assert _wait(lambda: any(e["event"] == "worker_scaled_down"
                                 for e in list(plane.events)))
        assert plane.live_workers() == [0]
        assert plane.fault_classes_observed() == []
        drained = [e for e in plane.events if e["event"] == "worker_drained"]
        assert drained[0]["worker_id"] == 1 and "served" in drained[0]
        assert plane.scale_status()["next_id"] == 2
    finally:
        plane.stop()
        for f in fakes:
            f.close()


def test_gateway_healthz_is_lease_fed_and_fleet_renders_it(capsys):
    from rca_tpu_torch.cli import main
    from rca_tpu_torch.gateway import GatewayClient, GatewayServer

    plane = _plane()
    fakes = _join(plane, 2)
    plane.register_clusters({})
    try:
        with GatewayServer(plane, port=0) as gw:
            client = GatewayClient(gw.host, gw.port, timeout_s=30)
            code, body = client.healthz()
            assert code == 200 and body["ok"]
            assert [w["worker_id"] for w in body["fleet"]] == [0, 1]
            assert body["workers"] == {"0": "live", "1": "live"}
            assert main(["fleet", f"http://{gw.host}:{gw.port}"]) == 0
            out = capsys.readouterr().out.splitlines()
            assert out[0].split()[:3] == ["worker", "state", "outstanding"]
            assert [r.split()[:2] for r in out[1:3]] == [
                ["0", "live"], ["1", "live"]]
            for f in fakes:
                f.close()
            assert _wait(lambda: not plane.live_workers())
            code, body = client.healthz()
            assert code == 503 and not body["ok"]
            assert main(["fleet", f"http://{gw.host}:{gw.port}"]) == 1
    finally:
        plane.stop()
        for f in fakes:
            f.close()
