"""The port's serving scheduler (``rca_tpu_torch.serve``) against the JAX
package's, and against itself.

- the scheduling policy on the host (fake clock, stub dispatcher), as
  ``tests/test_serve.py`` holds the reference's: bounded admission,
  weighted-fair and priority order, per-tenant FIFO, deadline shedding at
  every stage, the shape-bucket flush policy, the loop's batch accounting,
  its breaker and degraded / error answers, a shutdown that resolves
  everything; the ``RCA_SERVE_*`` knobs and the primitives the plane runs
  on (``CircuitBreaker``, the seeded fault hook, ``LatencyHistogram``,
  ``PhaseStats``, the condition constructor);
- against the reference: the same seeded requests at 48, 120 and 260
  services (NaN / Inf rows, full and delta staging, a shed request)
  through the reference's ``ServeLoop`` (JAX on the CPU) and the port's
  (the plain ``torch`` row), single-threaded on a fake clock so both form
  the same batches: per request the ranking and its tie order identical,
  ``sanitized_rows`` identical, scores within rtol 1e-5 / atol 1e-6, and
  the status counts and batch widths equal;
- against itself: every width 1–16, full and delta staging, each lane
  bitwise a solo analysis; ``serve_selftest`` with and without chaos;
- the registry elects a shape once when serve threads ask at once (one
  race on the card, one kernelscope note), and the launch counters lose
  no update under threads;
- the coordinator with ``serve=`` and ``python -m rca_tpu_torch serve``.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.config import ServeConfig as RefServeConfig
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.serve import ServeLoop as RefServeLoop
from rca_tpu.serve import ServeRequest as RefServeRequest
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.serve import (
    PRIORITY_HIGH,
    BatchDispatcher,
    RequestQueue,
    ServeClient,
    ServeLoop,
    ServeRequest,
    ShapeBucketBatcher,
    serve_selftest,
)

ROOT = Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _req(tenant="t", n=8, k=3, seed=0, **kw) -> ServeRequest:
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    return ServeRequest(
        tenant=tenant, features=feats, dep_src=src, dep_dst=dst, k=k, **kw
    )


class StubHandle:
    def __init__(self, requests, dispatched_at):
        self.requests = requests
        self.dispatched_at = dispatched_at


class StubResult:
    def __init__(self, tag):
        self.ranked = [{"component": f"svc-{tag}", "score": 1.0}]
        self.engine = "stub"
        self.score = np.ones(1, np.float32)


class StubDispatcher:
    """Device-free dispatcher: records every batch, optional scripted
    failures per op ("dispatch"/"fetch")."""

    engine = None
    engine_tag = "stub"

    def __init__(self):
        self.dispatched = []   # list of batch widths
        self.fail_next = []    # ops to fail, consumed front-first

    def dispatch(self, batch, now=None):
        if self.fail_next and self.fail_next[0] == "dispatch":
            self.fail_next.pop(0)
            raise RuntimeError("injected dispatch failure")
        self.dispatched.append(len(batch))
        return StubHandle(list(batch), now if now is not None else 0.0)

    def fetch(self, handle):
        if self.fail_next and self.fail_next[0] == "fetch":
            self.fail_next.pop(0)
            raise RuntimeError("injected fetch failure")
        return [StubResult(i) for i, _ in enumerate(handle.requests)]


def _policy_loop(clock=None, **cfg_kw):
    """Single-threaded loop over a stub dispatcher (never start()ed)."""
    clock = clock or FakeClock()
    stub = StubDispatcher()
    loop = ServeLoop(
        config=ServeConfig(**cfg_kw), clock=clock, dispatcher=stub,
    )
    return loop, stub, clock


def _drain(loop, iters=10):
    for _ in range(iters):
        loop.run_once()


@pytest.fixture
def engine(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    return GraphEngine(device="cpu")


# -- config ------------------------------------------------------------------

def test_serve_config_env_round_trip(monkeypatch):
    monkeypatch.setenv("RCA_SERVE_MAX_BATCH", "32")
    monkeypatch.setenv("RCA_SERVE_MAX_WAIT_US", "500")
    monkeypatch.setenv("RCA_SERVE_QUEUE_CAP", "77")
    cfg = ServeConfig.from_env()
    assert (cfg.max_batch, cfg.max_wait_us, cfg.queue_cap) == (32, 500, 77)


def test_serve_config_defaults_when_unset(monkeypatch):
    for name in ("RCA_SERVE_MAX_BATCH", "RCA_SERVE_MAX_WAIT_US",
                 "RCA_SERVE_QUEUE_CAP"):
        monkeypatch.delenv(name, raising=False)
    cfg = ServeConfig.from_env()
    assert (cfg.max_batch, cfg.max_wait_us, cfg.queue_cap) == (16, 2000, 256)
    assert cfg == ServeConfig()


@pytest.mark.parametrize("name,bad", [
    ("RCA_SERVE_MAX_BATCH", "0"),
    ("RCA_SERVE_MAX_BATCH", "5000"),
    ("RCA_SERVE_MAX_BATCH", "abc"),
    ("RCA_SERVE_MAX_WAIT_US", "-1"),
    ("RCA_SERVE_QUEUE_CAP", "0"),
])
def test_serve_config_rejects_bad_env(monkeypatch, name, bad):
    monkeypatch.setenv(name, bad)
    with pytest.raises(ValueError, match=name):
        ServeConfig.from_env()
    with pytest.raises(ValueError, match=name):
        RefServeConfig.from_env()      # the reference rejects it too


def test_serve_config_rejects_bad_direct_construction():
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError):
        ServeConfig(max_wait_us=-5)
    with pytest.raises(ValueError):
        ServeConfig(queue_cap=0)


def test_slo_and_graph_cache_knobs_match_reference(monkeypatch):
    from rca_tpu import config as ref_config
    from rca_tpu_torch import config

    for name in ("RCA_SLO_MS", "RCA_SERVE_GRAPH_CACHE"):
        monkeypatch.delenv(name, raising=False)
    assert config.slo_ms() == ref_config.slo_ms() == 500.0
    assert (config.serve_graph_cache_cap()
            == ref_config.serve_graph_cache_cap() == 32)
    monkeypatch.setenv("RCA_SLO_MS", "250.5")
    monkeypatch.setenv("RCA_SERVE_GRAPH_CACHE", "7")
    assert config.slo_ms() == ref_config.slo_ms() == 250.5
    assert config.serve_graph_cache_cap() == 7
    for bad in ("0", "abc", "700000"):
        monkeypatch.setenv("RCA_SLO_MS", bad)
        with pytest.raises(ValueError, match="RCA_SLO_MS"):
            config.slo_ms()
    assert config.env_float("RCA_NOT_SET_ANYWHERE", 1.5, 0.0, 2.0) == 1.5


# -- queue policy ------------------------------------------------------------

def test_queue_caps_admission():
    q = RequestQueue(cap=2, clock=FakeClock())
    assert q.submit(_req("a"))
    assert q.submit(_req("a"))
    assert not q.submit(_req("b"))  # full: rejected, NOT queued
    assert len(q) == 2


def test_queue_weighted_fair_interleaves_flooding_tenant():
    q = RequestQueue(cap=64, clock=FakeClock())
    for i in range(6):
        q.submit(_req("flood", seed=i))
    for i in range(2):
        q.submit(_req("light", seed=10 + i))
    order = [q.pop().tenant for _ in range(8)]
    assert order[:4].count("light") == 2


def test_queue_weight_scales_drain_rate():
    q = RequestQueue(cap=64, clock=FakeClock())
    q.set_weight("heavy", 2.0)
    for i in range(8):
        q.submit(_req("heavy", seed=i))
        q.submit(_req("light", seed=100 + i))
    first6 = [q.pop().tenant for _ in range(6)]
    assert first6.count("heavy") == 4
    assert first6.count("light") == 2


def test_queue_priority_pops_before_normal():
    q = RequestQueue(cap=64, clock=FakeClock())
    q.submit(_req("a", seed=1))
    q.submit(_req("a", seed=2))
    q.submit(_req("b", seed=3, priority=PRIORITY_HIGH))
    assert q.pop().tenant == "b"


def test_queue_per_tenant_fifo():
    q = RequestQueue(cap=64, clock=FakeClock())
    reqs = [_req("a", seed=i) for i in range(5)]
    for r in reqs:
        q.submit(r)
    popped = [q.pop().request_id for _ in range(5)]
    assert popped == [r.request_id for r in reqs]


def test_queue_sheds_expired_only():
    clock = FakeClock()
    q = RequestQueue(cap=64, clock=clock)
    q.submit(_req("a", deadline_s=1.0))
    q.submit(_req("a", deadline_s=100.0))
    clock.advance(5.0)
    shed = q.shed_expired()
    assert len(shed) == 1 and shed[0].deadline_s == 1.0
    assert len(q) == 1


def test_queue_service_order_matches_reference():
    """The same admissions pop in the same order from both queues."""
    from rca_tpu.serve import RequestQueue as RefQueue

    port, ref = RequestQueue(cap=64, clock=FakeClock()), RefQueue(
        cap=64, clock=FakeClock())
    for q in (port, ref):
        q.set_weight("heavy", 3.0)
    rng = np.random.default_rng(5)
    for i in range(30):
        tenant = ["heavy", "light", "mid"][int(rng.integers(3))]
        prio = int(rng.integers(3))
        cost = float(rng.uniform(0.5, 2.0))
        p = _req(tenant, seed=i, priority=prio, cost=cost)
        r = RefServeRequest(tenant=tenant, features=p.features,
                            dep_src=p.dep_src, dep_dst=p.dep_dst,
                            priority=prio, cost=cost,
                            request_id=p.request_id)
        port.submit(p)
        ref.submit(r)
    assert ([port.pop().request_id for _ in range(30)]
            == [ref.pop().request_id for _ in range(30)])


def test_request_contract():
    r = _req("a", k=99)
    assert r.k == 16                       # clamped to K_CAP
    assert r.graph_key == _req("b", seed=5).graph_key
    assert r.graph_key != _req("a", n=9).graph_key
    with pytest.raises(ValueError):
        ServeRequest("a", np.zeros(3, np.float32), [0], [1])
    with pytest.raises(ValueError):
        ServeRequest("a", np.zeros((3, 2), np.float32), [0, 1], [1])
    with pytest.raises(TimeoutError):
        r.result(timeout=0)


def test_request_completes_exactly_once_under_racing_writers():
    from rca_tpu_torch.serve import ServeResponse

    r = _req("a")
    wins = []
    barrier = threading.Barrier(8)

    def racer(i):
        barrier.wait(5)
        wins.append(r.complete(ServeResponse("ok", r.request_id, "a",
                                             detail=str(i))))

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert not any(t.is_alive() for t in threads)
    assert sorted(wins) == [False] * 7 + [True]
    assert r.result(timeout=0).detail in {str(i) for i in range(8)}


# -- batcher flush policy ----------------------------------------------------

def _offer(b, req, now):
    req.enqueued_at = now
    b.offer(req)


def test_batcher_full_batch_flushes_immediately():
    clock = FakeClock()
    b = ShapeBucketBatcher(max_batch=3, max_wait_us=10_000_000, clock=clock)
    for i in range(3):
        _offer(b, _req("a", seed=i), clock())
    batch = b.take_ready()
    assert batch is not None and len(batch) == 3
    assert b.staged() == 0


def test_batcher_partial_waits_then_flushes():
    clock = FakeClock()
    b = ShapeBucketBatcher(max_batch=8, max_wait_us=2000, clock=clock)
    _offer(b, _req("a"), clock())
    assert b.take_ready() is None
    assert b.next_ready_in() == pytest.approx(0.002)
    clock.advance(0.0021)
    batch = b.take_ready()
    assert batch is not None and len(batch) == 1


def test_batcher_drain_skips_wait_window():
    clock = FakeClock()
    b = ShapeBucketBatcher(max_batch=8, max_wait_us=10_000_000, clock=clock)
    _offer(b, _req("a"), clock())
    assert b.take_ready(drain=True) is not None


def test_batcher_never_mixes_graphs():
    clock = FakeClock()
    b = ShapeBucketBatcher(max_batch=8, max_wait_us=0, clock=clock)
    _offer(b, _req("a", n=8), clock())
    _offer(b, _req("a", n=16), clock())
    first = b.take_ready()
    second = b.take_ready()
    assert len(first) == 1 and len(second) == 1
    assert first[0].graph_key != second[0].graph_key
    assert b.group_count() == 0


def test_batcher_sheds_expired():
    clock = FakeClock()
    b = ShapeBucketBatcher(max_batch=8, max_wait_us=0, clock=clock)
    _offer(b, _req("a", deadline_s=1.0), clock())
    clock.advance(2.0)
    assert len(b.shed_expired()) == 1
    assert b.staged() == 0 and b.take_ready() is None


def test_batcher_rejects_bad_policy():
    with pytest.raises(ValueError):
        ShapeBucketBatcher(max_batch=0)
    with pytest.raises(ValueError):
        ShapeBucketBatcher(max_wait_us=-1)


# -- loop policy (single-threaded, stub device) ------------------------------

def test_loop_queue_full_response_at_admission():
    loop, stub, _ = _policy_loop(queue_cap=2)
    r1, r2, r3 = _req("a", seed=1), _req("a", seed=2), _req("b", seed=3)
    assert loop.submit(r1) and loop.submit(r2)
    assert not loop.submit(r3)
    resp = r3.result(timeout=0)
    assert resp.status == "queue_full"
    assert stub.dispatched == []


def test_loop_expired_request_never_consumes_device_slot():
    clock = FakeClock()
    loop, stub, clock = _policy_loop(clock=clock, max_wait_us=0)
    dead = _req("a", deadline_s=5.0)
    live = _req("a", seed=9, deadline_s=100.0)
    loop.submit(dead)
    loop.submit(live)
    clock.advance(10.0)
    _drain(loop)
    assert dead.result(timeout=0).status == "shed"
    assert live.result(timeout=0).status == "ok"
    assert sum(stub.dispatched) == 1


def test_loop_dead_on_arrival_is_shed_at_admission():
    clock = FakeClock(100.0)
    loop, stub, _ = _policy_loop(clock=clock)
    doa = _req("a", deadline_s=50.0)
    assert not loop.submit(doa)
    assert doa.result(timeout=0).status == "shed"
    assert len(loop.queue) == 0 and stub.dispatched == []


def test_loop_ok_response_carries_batch_accounting():
    loop, stub, _ = _policy_loop(max_wait_us=0)
    reqs = [_req("a", seed=i) for i in range(3)]
    for r in reqs:
        loop.submit(r)
    _drain(loop)
    resps = [r.result(timeout=0) for r in reqs]
    assert all(r.status == "ok" for r in resps)
    assert {r.batch_size for r in resps} == {3}
    assert loop.device_batches == 1


def test_loop_response_stamps_its_completion_time():
    """Each response carries the scheduler clock at completion, so a
    caller reads a request's submit → completion time off it."""
    clock = FakeClock(10.0)
    loop, stub, _ = _policy_loop(clock=clock, max_wait_us=0)
    req = _req("a")
    loop.submit(req)
    clock.advance(0.25)
    _drain(loop)
    resp = req.result(timeout=0)
    assert resp.ok and resp.completed_at - req.enqueued_at == 0.25


def test_loop_fetch_failure_degrades_with_last_known():
    loop, stub, _ = _policy_loop(max_wait_us=0)
    first = _req("a", seed=1)
    loop.submit(first)
    _drain(loop)
    assert first.result(timeout=0).status == "ok"

    stub.fail_next = ["fetch"]
    second = _req("a", seed=2)
    loop.submit(second)
    _drain(loop)
    resp = second.result(timeout=0)
    assert resp.status == "degraded"
    assert "last known ranking" in resp.detail
    assert resp.ranked == first.result(timeout=0).ranked


def test_loop_error_when_no_last_known():
    loop, stub, _ = _policy_loop(max_wait_us=0)
    stub.fail_next = ["dispatch"]
    r = _req("a")
    loop.submit(r)
    _drain(loop)
    assert r.result(timeout=0).status == "error"


def test_loop_open_breaker_answers_without_device():
    loop, stub, clock = _policy_loop(max_wait_us=0)
    for i in range(3):
        stub.fail_next = ["dispatch"]
        r = _req("a", seed=i)
        loop.submit(r)
        _drain(loop)
        assert r.result(timeout=0).status == "error"
    assert loop.breaker.state == "open"
    dispatched_before = len(stub.dispatched)
    r = _req("a", seed=99)
    loop.submit(r)
    _drain(loop)
    assert r.result(timeout=0).status == "error"
    assert "circuit_open" in r.result(timeout=0).detail
    assert len(stub.dispatched) == dispatched_before
    # after the reset window the half-open probe closes it again
    clock.advance(1.5)
    probe = _req("a", seed=100)
    loop.submit(probe)
    _drain(loop)
    assert probe.result(timeout=0).status == "ok"
    assert loop.breaker.state == "closed"


def test_loop_shutdown_resolves_everything():
    loop, stub, _ = _policy_loop(max_wait_us=10_000_000, max_batch=64)
    reqs = [_req("a", seed=i) for i in range(4)]
    for r in reqs:
        loop.submit(r)
    loop.start()
    loop.stop()
    assert all(r.done() for r in reqs)


def test_loop_rejects_a_recorder(tmp_path):
    """The loop used to refuse a recorder; it now takes one, writes its
    knobs into the header and one ``serve`` frame per ``ok`` response."""
    from rca_tpu_torch.replay import Recorder, load_recording

    rec = Recorder(str(tmp_path / "rec"), mode="serve")
    loop = ServeLoop(dispatcher=StubDispatcher(), recorder=rec,
                     config=ServeConfig(max_batch=4))
    reqs = [_req(seed=i) for i in range(3)]
    assert all(loop.submit(r) for r in reqs)
    _drain(loop)
    rec.close()
    assert all(r.result(timeout=5).status == "ok" for r in reqs)
    parsed = load_recording(str(tmp_path / "rec"))
    assert parsed.session_info["max_batch"] == 4
    assert [fr["request_id"] for fr in parsed.serve] == \
        [r.request_id for r in reqs]


def test_served_request_records_its_trace():
    """With a tracer on, a request's root span closes at completion and
    its queue / batch / dispatch / fetch spans parent onto it."""
    from rca_tpu_torch.observability.spans import Tracer

    clock = FakeClock()
    tracer = Tracer(enabled=True, clock=clock, seed=1)
    loop = ServeLoop(config=ServeConfig(max_wait_us=0), clock=clock,
                     dispatcher=StubDispatcher(), tracer=tracer)
    req = _req("a")
    loop.submit(req)
    _drain(loop)
    assert req.result(timeout=0).ok
    spans = tracer.spans(trace_id=req.trace.trace_id)
    names = sorted(sp["name"] for sp in spans)
    assert names == ["serve.batch", "serve.dispatch", "serve.fetch",
                     "serve.queue", "serve.request"]
    root = next(sp for sp in spans if sp["name"] == "serve.request")
    assert root["span_id"] == req.trace.span_id
    assert root["attrs"]["status"] == "ok"
    assert all(sp["parent_id"] == root["span_id"]
               for sp in spans if sp is not root)


def test_metrics_summary_shape():
    loop, stub, _ = _policy_loop(max_wait_us=0)
    for i in range(3):
        loop.submit(_req("a", seed=i))
    _drain(loop)
    m = loop.metrics.summary()
    assert m["tenants"]["a"]["answered"] == 3
    assert m["tenants"]["a"]["queue_ms_p50"] is not None
    assert m["batches"] == 1
    assert m["batch_occupancy_mean"] == 3.0
    assert m["dispatched_requests"] == 3
    assert m["duration"]["a"]["count"] == 3
    assert m["slo_breaches"] == {}


def test_metrics_summary_keys_match_reference():
    from rca_tpu.serve import ServeMetrics as RefMetrics
    from rca_tpu_torch.serve import ServeMetrics

    port, ref = ServeMetrics(slo_ms_target=100.0), RefMetrics(
        slo_ms_target=100.0)
    for m in (port, ref):
        m.submitted("a", 3)
        m.answered("a", 4.0)
        m.request_duration("a", 0.2, ok=True)
        m.request_duration("a", 0.01, ok=False)
        m.record_batch(2)
        m.graph_cache("miss")
        m.resident_reuse("a", 7)
        m.replica_batch(0, 2)
        m.replica_occupancy(0, 3)
        m.stolen(0, 1, 2)
        m.replica_state(0, "dead")
    assert port.summary() == ref.summary()


def test_phase_stats_quantile():
    from rca_tpu_torch.obslog.profiling import PhaseStats

    ps = PhaseStats()
    for v in range(1, 101):
        ps.record("q", float(v))
    assert ps.quantile("q", 0.0) == 1.0
    assert ps.quantile("q", 0.5) == 51.0
    assert ps.quantile("q", 1.0) == 100.0
    assert ps.quantile("missing", 0.5) is None
    twin = ps.snapshot()
    ps.record("q", 1000.0)
    assert twin.quantile("q", 1.0) == 100.0
    assert ps.quantile("q", 1.0) == 1000.0


def test_latency_histogram_matches_reference():
    from rca_tpu.observability.export import LatencyHistogram as RefHist
    from rca_tpu_torch.observability.export import LatencyHistogram

    port, ref = LatencyHistogram(), RefHist()
    for s in (0.001, 0.005, 0.02, 0.3, 4.0, 12.0):
        port.record(s)
        ref.record(s)
    assert port.to_dict() == ref.to_dict()


# -- resilience primitives ----------------------------------------------------

def test_circuit_breaker_cycle():
    from rca_tpu_torch.resilience.policy import CircuitBreaker, CircuitOpen

    clock = FakeClock()
    br = CircuitBreaker(failure_threshold=2, reset_after=1.0, clock=clock,
                        name="t")
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    with pytest.raises(CircuitOpen, match="circuit t is open"):
        br.call(lambda: 1)
    clock.advance(1.0)
    assert br.state == "half-open"
    assert br.allow()            # this caller is the probe
    assert not br.allow()        # a second one is held
    br.record_failure()          # the probe failed: open again
    assert br.state == "open"
    clock.advance(1.0)
    assert br.call(lambda: 7) == 7
    assert br.state == "closed"
    with pytest.raises(ZeroDivisionError):
        br.call(lambda: 1 / 0)


def test_seeded_fault_hook_matches_reference():
    from rca_tpu.resilience.chaos import seeded_fault_hook as ref_hook
    from rca_tpu_torch.resilience.chaos import (
        InjectedTimeout,
        seeded_fault_hook,
    )

    def schedule(hook, exc):
        out = []
        for i in range(200):
            try:
                hook("dispatch" if i % 2 else "fetch")
                out.append(False)
            except exc:
                out.append(True)
        return out

    from rca_tpu.resilience.chaos import InjectedTimeout as RefTimeout

    got = schedule(seeded_fault_hook(7, rate=0.2), InjectedTimeout)
    assert got == schedule(ref_hook(7, rate=0.2), RefTimeout)
    assert 10 < sum(got) < 80
    only = seeded_fault_hook(7, rate=1.0, ops=["fetch"])
    only("dispatch")
    with pytest.raises(InjectedTimeout):
        only("fetch")
    assert issubclass(InjectedTimeout, TimeoutError)


def test_thread_constructors():
    from rca_tpu_torch.util.threads import make_condition, make_lock

    cond = make_condition("T._cond")
    with cond:
        assert not cond.wait(0.01)
    shared = make_lock("T._shared")
    cond2 = make_condition("T._cond2", lock=shared)
    with cond2:
        cond2.notify_all()


# -- the registry and the launch counters under serve threads ----------------

def test_registry_elects_a_shape_once_when_threads_ask_at_once(monkeypatch):
    """Serve threads (a loop's worker, a pool's replicas on one card) that
    ask about a new shape at once run ONE election: on the card that is
    one timed race, never two racing each other, and kernelscope notes
    one compile, not a recompile."""
    from rca_tpu_torch.engine import registry
    from rca_tpu_torch.observability.kernelscope import RecompileMonitor

    calls = []
    real = registry.KernelRegistry._decide

    def slow_decide(self, *args):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return real(self, *args)

    monkeypatch.setattr(registry.KernelRegistry, "_decide", slow_decide)
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    reg = registry.KernelRegistry()
    monitor = RecompileMonitor(enabled=True).start()
    rows, barrier = [], threading.Barrier(6)

    def ask():
        barrier.wait(5)
        rows.append(reg.resolve(4096, 8192, device="cpu"))

    threads = [threading.Thread(target=ask) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert len(rows) == 6 and all(r is rows[0] for r in rows)
    snap = monitor.snapshot()
    assert (snap["compiles"], snap["recompiles"]) == (1, 0)


def test_launch_counts_lose_no_update_under_threads():
    from rca_tpu_torch.kernels import (
        LAUNCHES,
        PERSIST_LAUNCHES,
        SHARD_LAUNCHES,
        count_launch,
    )

    before = (dict(LAUNCHES), dict(PERSIST_LAUNCHES), dict(SHARD_LAUNCHES))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(3000):
                count_launch("seg_up_step", shard=True)
                count_launch("evidence_front", persist=True)

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert LAUNCHES["seg_up_step"] - before[0]["seg_up_step"] == 24000
    assert SHARD_LAUNCHES["seg_up_step"] - before[2]["seg_up_step"] == 24000
    assert (PERSIST_LAUNCHES["evidence_front"]
            - before[1]["evidence_front"]) == 24000
    assert LAUNCHES["evidence_front"] - before[0]["evidence_front"] == 24000
    for counts, was in zip((LAUNCHES, PERSIST_LAUNCHES, SHARD_LAUNCHES),
                           before):
        counts.update(was)


# -- against the reference ----------------------------------------------------

def _waves(n, seed):
    """The seeded requests of one graph: a wave of 4 dense perturbations
    (a NaN row and an Inf in lanes 2 and 3; full staging), a wave of 4
    sparse ones against the first lane (a NaN row in lane 1; delta
    staging), and one request dead on arrival."""
    case = ref_cascade(n, n_roots=1, seed=seed)
    rng = np.random.default_rng(seed)
    first = []
    for _ in range(4):
        first.append(np.clip(case.features + rng.uniform(
            0, 0.05, case.features.shape), 0, 1).astype(np.float32))
    first[2][5] = np.nan
    first[3][7, 2] = np.inf
    second = []
    for _ in range(4):
        f = first[0].copy()
        rows = rng.choice(n, 3, replace=False)
        f[rows] = rng.uniform(0, 1, (3, f.shape[1]))
        second.append(f)
    second[1][rows[0], 4] = np.nan
    return case, [first, second, [first[1]]]


def _run(loop_cls, req_cls, engine, config, case, waves):
    clock = FakeClock(10.0)
    loop = loop_cls(engine=engine, config=config, clock=clock)
    out = []
    for w, wave in enumerate(waves):
        reqs = [req_cls(tenant=f"t{i % 2}", features=f, dep_src=case.dep_src,
                        dep_dst=case.dep_dst, names=case.names, k=5,
                        deadline_s=5.0 if w == 2 else None)
                for i, f in enumerate(wave)]
        for r in reqs:
            loop.submit(r)
        for _ in range(6):
            loop.run_once()
            clock.advance(0.001)
        out.extend(r.result(timeout=0) for r in reqs)
    return out, loop.metrics.summary()


@pytest.mark.parametrize("n,seed", [(48, 0), (120, 1), (260, 2)])
def test_serve_loop_matches_reference(engine, monkeypatch, n, seed):
    case, waves = _waves(n, seed)
    ref_resps, ref_m = _run(RefServeLoop, RefServeRequest, RefEngine(),
                            RefServeConfig(max_batch=4, max_wait_us=0),
                            case, waves)
    resps, m = _run(ServeLoop, ServeRequest, engine,
                    ServeConfig(max_batch=4, max_wait_us=0), case, waves)
    statuses = [r.status for r in resps]
    assert statuses == [r.status for r in ref_resps]
    assert statuses == ["ok"] * 8 + ["shed"]
    for got, want in zip(resps, ref_resps):
        if not want.ok:
            continue
        assert [c["component"] for c in got.ranked] == [
            c["component"] for c in want.ranked]
        assert got.result.sanitized_rows == want.result.sanitized_rows
        assert got.batch_size == want.batch_size
        np.testing.assert_allclose(got.result.score, want.result.score,
                                   rtol=1e-5, atol=1e-6)
        for key in ("score", "anomaly", "explained_by_upstream",
                    "downstream_impact"):
            np.testing.assert_allclose(
                [c[key] for c in got.ranked], [c[key] for c in want.ranked],
                rtol=1e-5, atol=1e-6)
    assert [r.result.sanitized_rows for r in resps[:8]] == [2] * 4 + [1] * 4
    for key in ("batches", "batch_occupancy_mean", "dispatched_requests",
                "shed_total", "graph_cache"):
        assert m[key] == ref_m[key], key
    for tenant, row in m["tenants"].items():
        want_row = ref_m["tenants"][tenant]
        for key in ("submitted", "answered", "shed", "degraded", "errors",
                    "resident_delta_requests", "resident_rows_saved"):
            assert row[key] == want_row[key], (tenant, key)
    assert sum(t["resident_delta_requests"]
               for t in m["tenants"].values()) == 4


# -- against itself -----------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays

    return synthetic_cascade_arrays(90, n_roots=1, seed=4)


@pytest.mark.parametrize("staging", ["full", "delta"])
@pytest.mark.parametrize("width", list(range(1, 17)))
def test_coalesced_lanes_are_bitwise_solo(engine, graph, width, staging):
    rng = np.random.default_rng(width)
    disp = BatchDispatcher(engine)
    warm = ServeRequest("w", graph.features, graph.dep_src, graph.dep_dst,
                        k=5)
    disp.fetch(disp.dispatch([warm]))
    feats = []
    for _ in range(width):
        f = graph.features.copy()
        if staging == "full":
            f = np.clip(f + rng.uniform(0, 0.05, f.shape), 0, 1)
        else:
            rows = rng.choice(graph.n, 3, replace=False)
            f[rows] = rng.uniform(0, 1, (3, f.shape[1]))
        feats.append(f.astype(np.float32))
    if width > 2:
        feats[2][11] = np.nan
    reqs = [ServeRequest(f"t{i}", f, graph.dep_src, graph.dep_dst,
                         names=graph.names, k=5)
            for i, f in enumerate(feats)]
    handle = disp.dispatch(reqs)
    assert handle.resident_delta == (staging == "delta")
    results = disp.fetch(handle)
    assert len(results) == width
    for f, res in zip(feats, results):
        solo = engine.analyze_arrays(f, graph.dep_src, graph.dep_dst,
                                     graph.names, k=5)
        assert res.ranked == solo.ranked
        assert np.array_equal(res.score, solo.score)
        assert np.array_equal(res.full_diagnostics(),
                              solo.full_diagnostics())
        assert res.sanitized_rows == (1 if width > 2 else 0)
        assert res.engine == "serve+single"


def test_dispatcher_rejects_mixed_or_empty_batches(engine):
    disp = BatchDispatcher(engine)
    with pytest.raises(ValueError, match="empty"):
        disp.dispatch([])
    with pytest.raises(ValueError, match="graph_key"):
        disp.dispatch([_req("a", n=8), _req("a", n=9)])


def test_dispatcher_graph_cache_evicts_least_recent(engine):
    from rca_tpu_torch.serve import ServeMetrics

    metrics = ServeMetrics()
    disp = BatchDispatcher(engine, cache_cap=2, metrics=metrics)
    rng = np.random.default_rng(0)
    reqs = [ServeRequest("a", rng.uniform(0, 1, (n, 13)), np.arange(n - 1),
                         np.arange(1, n)) for n in (8, 9, 10)]
    for r in reqs + [reqs[2]]:
        disp.fetch(disp.dispatch([r]))
    assert not disp.has_graph(reqs[0].graph_key)
    assert disp.has_graph(reqs[2].graph_key)
    assert metrics.summary()["graph_cache"] == {"hit": 1, "miss": 3,
                                                "eviction": 1}


def test_explained_request_carries_provenance(engine, graph):
    loop = ServeLoop(engine=engine, config=ServeConfig(max_wait_us=0),
                     clock=FakeClock())
    req = ServeRequest("a", graph.features, graph.dep_src, graph.dep_dst,
                       names=graph.names, k=3, explain=True)
    loop.submit(req)
    for _ in range(3):
        loop.run_once()
    resp = req.result(timeout=0)
    assert resp.ok and resp.provenance is not None
    assert resp.provenance == resp.result.attribution()
    assert loop.metrics.summary()["tenants"]["a"]["explain_requests"] == 1


def test_selftest_contract(engine):
    out = serve_selftest(n_requests=32, seed=0, engine=engine,
                         timeout_s=60.0)
    assert out["ok"], out
    assert out["all_resolved"] and out["parity_ok"]
    assert out["by_status"].get("shed", 0) >= out["expected_shed_min"]
    assert set(out["by_status"]) <= {"ok", "shed"}
    assert out["device_batches"] < out["requests"] // 2
    assert out["metrics"]["batch_occupancy_max"] > 1
    assert out["resident_delta_requests"] >= 1
    assert out["kernelscope"]["recompiles"] == 0


def test_selftest_parity_under_chaos(engine):
    out = serve_selftest(n_requests=24, seed=3, engine=engine, chaos=True,
                         timeout_s=60.0)
    assert out["all_resolved"], out
    assert out["parity_ok"], out
    assert out["ok"], out
    assert out["by_status"].get("degraded", 0) + out["by_status"].get(
        "error", 0) > 0                        # the faults really fired


def test_concurrent_submitters_all_resolve(engine):
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays

    case = synthetic_cascade_arrays(48, n_roots=1, seed=1)
    rng = np.random.default_rng(0)
    feats = [
        np.clip(case.features + rng.uniform(
            0, 0.05, case.features.shape
        ).astype(np.float32), 0, 1)
        for _ in range(16)
    ]
    with ServeClient(engine=engine) as client:
        reqs = [None] * 16

        def submit(w):
            for i in range(w, 16, 4):
                reqs[i] = client.submit(
                    feats[i], case.dep_src, case.dep_dst,
                    tenant=f"t{w}", k=3,
                )

        threads = [threading.Thread(target=submit, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        resps = [r.result(60.0) for r in reqs]
    assert all(r.status == "ok" for r in resps)
    assert client.loop.device_batches < 16


# -- the coordinator and the CLI ----------------------------------------------

def test_coordinator_routes_correlation_through_serve(engine):
    from rca_tpu_torch.cluster.fixtures import NS, five_service_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.coordinator import RCACoordinator

    client = MockClusterClient(five_service_world())
    direct = RCACoordinator(client, backend="torch", engine=engine)
    want = direct.run_analysis("comprehensive", NS)
    with ServeClient(engine=engine) as serve:
        coord = RCACoordinator(client, backend="torch", serve=serve,
                               tenant="coord-test")
        assert coord.device.type == "cpu"
        record = coord.run_analysis("comprehensive", NS)
        assert serve.loop.device_batches >= 1
    assert record["status"] == "completed", record.get("error")
    correlated = record["results"]["correlated"]
    assert correlated["engine"] == "serve+single"
    got = [(r["component"], r["score"]) for r in correlated["root_causes"]]
    assert got == [(r["component"], r["score"])
                   for r in want["results"]["correlated"]["root_causes"]]
    assert serve.loop.metrics.summary()["tenants"]["coord-test"][
        "answered"] >= 1


def test_coordinator_rejects_engine_and_serve():
    from rca_tpu_torch.cluster.fixtures import five_service_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.coordinator import RCACoordinator

    with ServeClient(dispatcher=StubDispatcher()) as client:
        with pytest.raises(ValueError, match="not both"):
            RCACoordinator(MockClusterClient(five_service_world()),
                           serve=client, engine=object())


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "serve", *argv, "--device",
         "cpu", "--compact"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120,
    )


def test_serve_cli_selftest_and_load():
    proc = _cli("--selftest", "--requests", "16")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["ok"] and out["parity_ok"] and out["requests"] == 16
    proc = _cli("--fixture", "120svc", "--requests", "12", "--tenants", "3")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["by_status"] == {"ok": 12}
    assert set(out["metrics"]["tenants"]) == {"tenant-0", "tenant-1",
                                              "tenant-2"}
    assert out["device_batches"] < 12
    scope = out["kernelscope"]
    assert scope["enabled"] and scope["recompiles"] == 0
    assert {(row["n_pad"], row["winner"])
            for row in scope["kernel_registry"]} == {(128, "torch")}
    assert len(scope["kernel_set"]) == 16


@pytest.mark.parametrize("flag,item", [
    ("--listen", "A9"), ("--federation", "A14"), ("--autoscale", "A14"),
])
def test_serve_cli_unported_modes_exit_2(capsys, tmp_path, flag, item):
    """The serve modes around ``--autoscale`` (A14, the autoscaler's
    controller; ``--listen`` is A9's gateway), each against the
    reference's CLI: ``--listen --autoscale`` without ``--federation`` is
    refused with the reference's message, as is ``--federation N`` outside
    ``[MIN, MAX]`` (before a worker is spawned); ``--autoscale 2:3`` alone
    runs the ramp soak on the CPU, exits 0 and prints the reference
    soak's keys."""
    from rca_tpu.cli import main as ref_main
    from rca_tpu_torch.cli import main

    log_dir = ["--log-dir", str(tmp_path)]
    if flag == "--autoscale":
        argv = ["serve", "--autoscale", "2:3", "--seed", "0", "--compact"]
        assert main([*argv, "--device", "cpu"]) == 0, item
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert ref_main(argv) == 0
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(out) == set(ref)
        for key in ("ok", "worker_mode", "min_workers", "max_workers",
                    "all_terminal", "double_completions", "peaked",
                    "shrunk", "p99_ok", "placement_hit_rate"):
            assert out[key] == ref[key], key
        assert out["ok"] and out["by_status"] == {"ok": out["requests"]}
        return
    if flag == "--listen":
        argv = ["serve", "--listen", "127.0.0.1:0", "--autoscale", "1:2",
                *log_dir]
        with pytest.raises(SystemExit) as theirs:
            ref_main(argv)
        want = str(theirs.value.code)
    else:
        argv = ["serve", "--listen", "127.0.0.1:0", "--federation", "2",
                "--autoscale", "3:4", *log_dir]
        want = "--autoscale 3:4: --federation 2 is outside [3, 4]"
    with pytest.raises(SystemExit) as mine:
        main([*argv, "--device", "cpu"])
    assert str(mine.value.code) == want, item
    assert "--federation" in want
    assert capsys.readouterr().out == ""
